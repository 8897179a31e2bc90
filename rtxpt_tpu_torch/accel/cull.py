"""Conservative per-ray-group cluster culling, once per bounce
(counterpart of rtxpt_tpu/accel/cull.py; plain PyTorch, as the JAX
package leaves it to XLA).

For each 128-ray row the component-interval bounds of the active lanes'
origins O and directions D form a beam. An interval slab test against a
cluster AABB B gives, per axis, the shifted slab S = [B.lo - O.hi,
B.hi - O.lo] and

  enter_a = S.lo > 0: S.lo / max(D.hi, eps)   (infeasible if D.hi <= 0)
            S.hi < 0: S.hi / min(D.lo, -eps)  (infeasible if D.lo >= 0)
            else:     0
  exit_a  = D.lo > 0: S.hi / D.lo;  D.hi < 0: S.lo / D.hi;  else +inf

and the beam may hit B iff max_a enter <= min(min_a exit, tmax): exact
for point intervals, conservative otherwise. The group hull (the 8 row
beams of a 1024-lane group) is tested against every cluster, and the
kslots nearest (by hull entry, ties by lowest cluster id) become the
group's candidate list; the per-row entry distances are then computed
for those slots only.
"""

from __future__ import annotations

import torch

_INF = 3e38
_EPS = 1e-20


def _row_bounds(x, active, sign):
    """Masked per-row bounds: x [3,G,R,128], active [G,R,128] ->
    [3,G,R]."""
    if sign > 0:
        return torch.where(active[None], x, -_INF).amax(dim=-1)
    return torch.where(active[None], x, _INF).amin(dim=-1)


def _enter_exit(slo, shi, dl, dh):
    pos = slo > 0.0
    neg = shi < 0.0
    enter = torch.where(
        pos, torch.where(dh > _EPS, slo / torch.clamp(dh, min=_EPS), _INF),
        torch.where(neg, torch.where(dl < -_EPS,
                                     shi / torch.clamp(dl, max=-_EPS), _INF),
                    0.0))
    exit_ = torch.where(
        dl > _EPS, shi / torch.clamp(dl, min=_EPS),
        torch.where(dh < -_EPS, slo / torch.clamp(dh, max=-_EPS), _INF))
    return enter.amax(dim=0), exit_.amin(dim=0)


def _slab_chunk(olo, ohi, dlo, dhi, blo, bhi, tmax_row):
    """Interval slab test of rows against a chunk of clusters.
    olo.. [3,G,R]; blo, bhi [3,Cc]; tmax_row [G,R] -> enter [G,R,Cc]
    (+inf where missed)."""
    slo = blo[:, None, None, :] - ohi[..., None]      # [3,G,R,Cc]
    shi = bhi[:, None, None, :] - olo[..., None]
    t_en, t_ex = _enter_exit(slo, shi, dlo[..., None], dhi[..., None])
    t_ex = torch.minimum(t_ex, tmax_row[..., None])
    return torch.where(t_en <= t_ex, t_en, _INF)


def _f32_bits(x):
    return x.contiguous().view(torch.int32)


def cull_candidates(o, d, active, tmax, aabb_lo, aabb_hi, kslots: int,
                    chunk: int = 512, lo=None):
    """Per-group candidate lists.

    o, d [3,G,R,128] f32; active [G,R,128] bool; tmax a float or
    [G,R,128] f32; aabb_lo/hi [C,3]. Returns (cand [G,1,1+(2+R)*kslots]
    i32, overflow [] i64).

    `lo` (([G] f32 entry, [G] i32 cluster id), optional) is a per-group
    strict lower bound in the lexicographic (entry, id) order: only
    clusters strictly after it are candidates. The paged tier passes
    the previous page's last kept slot (bounce_clustered.page_boundary).

    cand row: [count, ids x K (nearest hull entry first), hull entry x K
    (f32 bits), row entry x K*R (f32 bits, slot-major; +inf where the
    row's beam misses the cluster)]. Positive floats order like their
    int32 bits, so the kernels compare these bits with committed-t bits.
    `overflow` counts the feasible clusters past the K kept ones, summed
    over groups."""
    G, R = o.shape[1], o.shape[2]
    C = aabb_lo.shape[0]
    dev = o.device
    olo = _row_bounds(o, active, -1)
    ohi = _row_bounds(o, active, +1)
    dlo = _row_bounds(d, active, -1)
    dhi = _row_bounds(d, active, +1)
    if not isinstance(tmax, torch.Tensor) or tmax.dim() == 0:
        tmax_row = torch.full((G, R), float(tmax), dtype=torch.float32,
                              device=dev)
    else:
        tmax_row = torch.where(active, tmax, -_INF).amax(dim=-1)
    row_any = active.any(dim=-1)                      # [G,R]
    tmax_row = torch.where(row_any, tmax_row, -_INF)  # empty row: no hits

    # Phase 1: the group hull beam against every cluster ([G,1,C]).
    ra = row_any[None]
    g_olo = torch.where(ra, olo, _INF).amin(dim=2, keepdim=True)
    g_ohi = torch.where(ra, ohi, -_INF).amax(dim=2, keepdim=True)
    g_dlo = torch.where(ra, dlo, _INF).amin(dim=2, keepdim=True)
    g_dhi = torch.where(ra, dhi, -_INF).amax(dim=2, keepdim=True)
    g_tmax = tmax_row.amax(dim=1, keepdim=True)

    blo = aabb_lo.T
    bhi = aabb_hi.T
    enter_g = torch.cat([
        _slab_chunk(g_olo, g_ohi, g_dlo, g_dhi, blo[:, c0:c0 + chunk],
                    bhi[:, c0:c0 + chunk], g_tmax)
        for c0 in range(0, C, chunk)], dim=-1)[:, 0]   # [G,C]
    if lo is not None:
        lo_e, lo_i = lo
        cid = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
        after = (enter_g > lo_e[:, None]) | (
            (enter_g == lo_e[:, None]) & (cid > lo_i[:, None]))
        enter_g = torch.where(after, enter_g, _INF)
    hit_g = enter_g < _INF

    # nearest first; a stable sort keeps the lowest cluster id on ties
    # (the JAX package's lax.top_k order)
    k = min(kslots, C)
    te, idx = torch.sort(enter_g, dim=1, stable=True)
    te = te[:, :k].contiguous()
    ids = idx[:, :k]
    count = (te < _INF).sum(dim=-1, dtype=torch.int32)              # [G]
    total = hit_g.sum(dim=-1, dtype=torch.int32)
    overflow = torch.clamp(total - count, min=0).sum(dtype=torch.int64)
    te_bits = _f32_bits(te)

    # Phase 2: per-row entry distances for the k selected slots only.
    sblo = aabb_lo[ids].permute(2, 0, 1)[:, :, None, :]   # [3,G,1,k]
    sbhi = aabb_hi[ids].permute(2, 0, 1)[:, :, None, :]
    t_en, t_ex = _enter_exit(sblo - ohi[..., None], sbhi - olo[..., None],
                             dlo[..., None], dhi[..., None])
    t_ex = torch.minimum(t_ex, tmax_row[..., None])
    te_row = torch.where(t_en <= t_ex, t_en, _INF)        # [G,R,k]
    te_row_bits = _f32_bits(te_row).permute(0, 2, 1).reshape(G, k * R)
    ids = ids.to(torch.int32)
    if k < kslots:
        padk = kslots - k
        ids = torch.nn.functional.pad(ids, (0, padk))
        te_bits = torch.nn.functional.pad(te_bits, (0, padk))
        te_row_bits = torch.nn.functional.pad(te_row_bits, (0, padk * R))
    cand = torch.cat([count[:, None], ids, te_bits, te_row_bits], dim=1)
    return cand[:, None, :].contiguous(), overflow

"""The clustered tier for large scenes (counterpart of
rtxpt_tpu/pt/bounce_clustered.py, the flat all-rows tier), flat and
instanced.

Scenes above 2048 triangles have cluster tables (accel/cluster.py)
instead of bounce tables. Each bounce of `trace_paths_clustered` runs:

  1. the wavefront sort (pixel Morton key at bounce 0, ray coherence key
     after; inactive lanes last);
  2. `cull_candidates` (accel/cull.py) per 1024-lane group;
  3. K3 `closest_hit`, once per page; pages merge by least t;
  4. K4 `shade`: surface_and_shade on K3's hits, which emits the next
     ray state and one NEE shadow request per lane (the environment of a
     miss and the environment light's sample too, when the tables carry
     the environment table; the materials' texture maps too, when the
     tables carry the texture atlas and stochastic texture filtering is
     on); in the external-NEE modes (NEE-AT, more
     than 128 lights, WRS K > 1) it exports the shaded surface instead,
     and pt/nee_external.py selects the light and packs the requests;
  5. the shadow-ray sort;
  6. `cull_candidates` for the shadow rays;
  7. K5 `occlusion`, once per page; pages merge by OR;
  8. the unsort and the NEE add (and NEE-AT's feedback).

With an environment, a final round follows the last bounce: K3 over the
still-active rays (no sort) and K4's `final_env` variant, which adds the
environment of the rays that escape.

Tables with opacity micromaps (accel/cluster.py `omm_word`, `omm_cov`)
run K3's, K4's and K5's micromap variants when the textures ride in the
kernels (stochastic texture filtering, the JAX package's gate): K3 rejects
micro-TRANSPARENT candidates and flags a winner on an UNKNOWN cell
(HA_UNK), both with the JAX kernels' near-edge rule (`_EDGE4`: within the
split-bf16 error of a cell edge a candidate counts as UNKNOWN, so that the
two packages never disagree on a decisive state); K4 tests such a hit's
alpha at MIP 0 and lets it pass through; K5 resolves UNKNOWN cells
stochastically against the coverage, with each lane's alpha uniform
(SH_UA). A scene with nested dielectric priorities
(`scene.has_nested_priorities`, bounce_clustered.py:1572-1575) runs K4's
priority variant, whose false hits pass through the same way.
`cfg.passthrough_extra_iters` more rounds let pass-through lanes reach
their max_bounces.

K3, K4 and K5 are CUDA kernels written by hand for Hopper
(csrc/cluster_closest.cu, cluster_shade.cu, cluster_shadow.cu) and
replace the TPU kernels `_kernel_a1`, `_kernel_a2` and `_kernel_b1`.
Beside each is its plain PyTorch version (`*_reference`); the wrapper
runs the kernel for CUDA tensors and the plain version for CPU tensors.

Instanced cluster tables (accel/cluster.py build_cluster_tables_instanced)
hold object-space prototype blocks, and the cull runs over the expanded
world candidates. Before K3 and K5, `map_cand_inst` replaces each
candidate's world id by its pool block id and appends the slots' instance
ids; the pages' boundaries come from the world ids before that. K3's and
K5's instanced variants (`_kernel_a1(instanced=True)`, `_kernel_b1_inst`)
map the ray operand into each visited instance's object frame with its
M10 (`object_operand`); t stays the world parameter, so hits compare
across instances as they are. K3 refits its winner on the winner's object
ray and exports the winner's instance in HA_INST; `post_attr_inst` then
brings the object-space attribute rows of the merged pages to world space
before K4.

The per-row route (`FLAT = False`; the JAX package's `_FLAT`, its round-3
kernels kept for A/B comparison) runs one page and no K3 / K4 pair: per
bounce one cull over the group hull with the scalar max_ray_travel, then
K6 `closest_shade` (`_kernel_a`: each 128-lane row walks its group's
list under its own gate, and the winner is shaded in the same kernel),
and for the sorted shadow rays one cull with the per-lane distance, then
K7 `occlusion_rows` (`_kernel_b`: per-row any-hit). The final round is a
cull and K6's `final_env` variant. K6 and K7 are csrc/cluster_rows.cu.
The route serves what the JAX per-row route serves: no micromaps, nested
priorities, instanced tables or external NEE (pt/dispatch.py refuses
them by name). `cull_overflow` is the overflow of each bounce's two culls.

Layouts are the JAX package's row maps (OD_*, HA_*, SH_*), but flat:
every row spans all N lanes ([rows, N] with N a multiple of 1024), and
group g is lanes [1024 g, 1024 (g+1)). The JAX package's
[G, rows, 1024] blocks are the same numbers in another memory order.

The sorts, the culls, the instanced attribute post-transform and the
final environment round run inside `torch.profiler.record_function`
ranges named "rtxpt.sort", "rtxpt.cull", "rtxpt.post" and "rtxpt.final",
so that a profile of a frame can split its device time (chip_smoke.py
does).

Choices against the JAX package (ROADMAP queue 3):
  * F2: the sort carries the int state rows whole (no 12-bit packing).
  * F4: the sort carries the ray cone and spread in f32 (no bf16
    rounding). Neither reaches the radiance of an untextured scene; in a
    textured one the cone sets the MIP level, and the JAX package's bf16
    cone (about 2^-8 relative, 0.006 of a level) moves about 0.5% of the
    fetches after bounce 0 to a neighbouring level
    (tests/test_torch_cluster_tex.py states the tolerance this leaves).
  * F5: `cull_overflow` is, per bounce, the cull overflow of the final
    page of the closest-hit cull plus that of the final page of the
    shadow cull: the feasible clusters still past the last page's
    boundary, i.e. geometry possibly missed. Summed over bounces.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel import cluster as CL
from rtxpt_tpu_torch.accel.cull import cull_candidates
from rtxpt_tpu_torch.ops.wavefront import (
    pixel_morton_key, ray_coherence_key, sort_rows_by_key, unsort_rows)
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import wide as W
from rtxpt_tpu_torch.scene.omm import micro_index, micro_state
from rtxpt_tpu_torch.utils import rng

CT = CL.CT
R = 8                    # 128-lane rows per group
FL = R * 128             # lanes per group (one CUDA block of K3 and K5)
DEFAULT_KSLOTS = 64
DEFAULT_PAGES = 2
_BIG = bf._BIG
_INF_BITS = 0x7F800000   # +inf as int32 bits: K6's and K7's row gate

# The route of trace_paths_clustered: True the flat all-rows kernels (K3,
# K4, K5, paged), False the per-row kernels (K6, K7, one page). The JAX
# package's bounce_clustered._FLAT, set by assignment (tests, chip_smoke.py)
# and read at call time; no environment variable sets it.
FLAT = True

# Split-bf16 selection margins, relative to |det|: the exact refit
# re-tests the winner, so these only prevent false negatives at shared
# edges. A margin-only candidate ties on t with the true hit across the
# shared edge, so strictly-inside candidates win ties (_TIE_BUMP).
MARGIN = 2e-3
_TIE_BUMP = 1e-4
REFIT_EPS = 1e-3         # refit acceptance band (barycentric units)
SHADOW_T_EPS = 2e-4      # any-hit backoff for the split-bf16 t rounding
# Micro-cell edge guard band (cell units): the split-bf16 (u, v) carry
# MARGIN-scale error, so a candidate within this band of a micro-cell
# boundary is never rejected as TRANSPARENT; it resolves as UNKNOWN.
_EDGE4 = 4.0 * 4.0 * MARGIN

# K3 ray operand rows [OD_ROWS, N] (global coordinates)
OD_D = 0                 # 0:3 direction
OD_OXD = 3               # 3:6 o x d
OD_O = 6                 # 6:9 origin
OD_ACT = 9               # active mask (gates the prune bound)
OD_ROWS = 10

# K3 -> K4 hit rows [HA_ROWS, N]
HA_T = 0                 # closest t (_BIG = miss)
HA_U = 1
HA_V = 2
HA_FRONT = 3             # winner det (refit-exact); > 0 = front face
HA_PRIM = 4              # global triangle index (-1 = miss)
HA_ATTR = 5              # + bf.AT_ROWS attribute rows (bf.AT_* order)
HA_UNK = HA_ATTR + bf.AT_ROWS   # the winner's micro-cell is UNKNOWN (omm)
HA_INST = HA_UNK + 1            # winner instance (instanced; -1 = none)
HA_ROWS = HA_INST + 1

# K4 -> K5 shadow request rows [SH_ROWS, N]
SH_O = 0                 # 0:3 origin
SH_D = 3                 # 3:6 direction
SH_DIST = 6
SH_CONTRIB = 7           # 7:10
SH_DO = 10
SH_CDIFF = 11            # 11:14 the NEE contribution's diffuse part (split)
SH_UA = 14               # the stochastic alpha uniform (opacity micromaps)
SH_ROWS = 15

# bounce-table attribute row -> cluster attribute row
_ATTR_MAP = {bf.AT_N0: CL.AT_N0, bf.AT_N1: CL.AT_N1, bf.AT_N2: CL.AT_N2,
             bf.AT_GN: CL.AT_GN, bf.AT_MID: CL.AT_MID,
             bf.AT_LPDF: CL.AT_LPDF, bf.AT_LAREA: CL.AT_LAREA,
             bf.AT_ISLIGHT: CL.AT_ISLIGHT, bf.AT_LODB: CL.AT_LODB,
             bf.AT_LID: CL.AT_LID, bf.AT_TANG: CL.AT_TANG,
             bf.AT_TSGN: CL.AT_TSGN}
for _j in range(2):
    _ATTR_MAP[bf.AT_UV0 + _j] = CL.AT_UV0 + _j
    _ATTR_MAP[bf.AT_UV1 + _j] = CL.AT_UV1 + _j
    _ATTR_MAP[bf.AT_UV2 + _j] = CL.AT_UV2 + _j
_ATTR_ROW_MAP = dict(_ATTR_MAP)
for _base in (bf.AT_N0, bf.AT_N1, bf.AT_N2, bf.AT_GN, bf.AT_TANG):
    for _j in range(1, 3):
        _ATTR_ROW_MAP[_base + _j] = _ATTR_MAP[_base] + _j
# the row order K3 writes: HA_ATTR + i holds cluster row ATTR_ROWS[i]
ATTR_ROWS = tuple(_ATTR_ROW_MAP[i] for i in range(bf.AT_ROWS))

# Non-zero coefficient rows of each quantity (det, u, v, t) against the
# operand [d | o' x d | o' | 1] (accel/cluster.py): the products are
# summed over these rows in this order, hi*hi, then hi*lo, then lo*hi,
# by the plain versions and the kernels alike (csrc/cluster.cuh).
Q_ROWS = ((0, 1, 2), (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5), (6, 7, 8, 9))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of K3, K4 and K5
# ---------------------------------------------------------------------------


def _center(blk):
    """Cluster centers (cx, cy, cz) [g, 1] of blocks [g, 32, 512]."""
    row = blk[:, CL.CENTER_ROW]
    return row[:, 0:1], row[:, CT:CT + 1], row[:, 2 * CT:2 * CT + 1]


def _operand(d, oxd, o, cx, cy, cz):
    """Split-bf16 cluster-local ray operand: (hi, lo), 10 rows of [g, FL]
    each. The operand is shifted (o' = o - c, (o x d)' = o x d - c x d)
    and then split, so rounding scales with the cluster's extent."""
    cxd = (cy * d[2] - cz * d[1], cz * d[0] - cx * d[2],
           cx * d[1] - cy * d[0])
    op = [d[0], d[1], d[2], oxd[0] - cxd[0], oxd[1] - cxd[1],
          oxd[2] - cxd[2], o[0] - cx, o[1] - cy, o[2] - cz]
    hi = [_bf16(x) for x in op]
    lo = [x - h for x, h in zip(op, hi)]
    one = torch.ones_like(op[0])
    return hi + [one], lo + [torch.zeros_like(one)]


def _quantities(blk, hi, lo):
    """(det, u_num, v_num, t_num) [g, CT, FL] of every triangle of the
    blocks [g, 32, 512] against the operand: c_hi*r_hi + c_hi*r_lo +
    c_lo*r_hi, summed in f32 in the Q_ROWS order."""
    out = []
    for q, rows in enumerate(Q_ROWS):
        lanes = slice(q * CT, (q + 1) * CT)
        terms = ([(blk[:, k, lanes], hi[k]) for k in rows]
                 + [(blk[:, k, lanes], lo[k]) for k in rows]
                 + [(blk[:, 10 + k, lanes], hi[k]) for k in rows])
        # each product rounded, then added in order (into one buffer)
        acc = terms[0][0][:, :, None] * terms[0][1][:, None]
        prod = torch.empty_like(acc)
        for c, r in terms[1:]:
            acc += torch.mul(c[:, :, None], r[:, None], out=prod)
        out.append(acc)
    return out


def _signed(det, un, vn, tn):
    s = torch.where(det >= 0.0, 1.0, -1.0)
    return det * s, un * s, vn * s, tn * s


def micro_state_guarded(word, su, sv, absd):
    """(state, near) of candidates at their split-bf16 barycentrics
    (bounce_clustered._micro_state_guarded): u, v = clip(s / |det|, 0, 1);
    `near` marks a point within _EDGE4 of its micro-cell's edges, which
    K3 and K5 treat as UNKNOWN."""
    inv_d = 1.0 / torch.clamp(absd, min=1e-30)
    u = torch.clamp(su * inv_d, 0.0, 1.0)
    v = torch.clamp(sv * inv_d, 0.0, 1.0)
    uu = u * 4.0
    vv = v * 4.0
    du = uu - torch.clamp(torch.floor(uu), max=3.0)
    dv = vv - torch.clamp(torch.floor(vv), max=3.0)
    near = ((du < _EDGE4) | (du > 1.0 - _EDGE4) | (dv < _EDGE4)
            | (dv > 1.0 - _EDGE4) | (torch.abs(du + dv - 1.0) < _EDGE4))
    return micro_state(word, micro_index(u, v)), near


def _candidate_states(valid, micro, cid, su, sv, absd):
    """(state, near) [g, CT, FL] of one visit's candidates, decoded only
    where `valid` (the geometric test) holds: elsewhere the plain
    versions never read them (state 0, near False)."""
    state = torch.zeros(valid.shape, dtype=torch.int64, device=valid.device)
    near = torch.zeros_like(valid)
    at = valid.nonzero(as_tuple=True)
    if at[0].numel():
        state[at], near[at] = micro_state_guarded(
            micro[cid][at[0], at[1]], su[at], sv[at], absd[at])
    return state, near


def _select(absd, su, sv, st, max_travel: float, divide: bool = False):
    """The closest-hit test of each candidate [.., CT, 128]: inside the
    conservative edge margins (MARGIN) at 0 < t < max_travel, and its t
    with the tie bump on margin-only candidates, so that strictly-inside
    ones win ties. divide: t = t_num / |det| (K6, `_kernel_a`) instead of
    t_num * (1 / |det|) (K3, `_kernel_a1`). Returns (valid, t)."""
    mm = MARGIN * absd
    valid = ((absd > 1e-30) & (su >= -mm) & (sv >= -mm)
             & (su + sv <= absd + mm + mm)
             & (st > 0.0) & (st < max_travel * absd))
    strict = (su >= 0.0) & (sv >= 0.0) & (su + sv <= absd)
    den = torch.clamp(absd, min=1e-30)
    tt = st / den if divide else st * (1.0 / den)
    return valid, tt * torch.where(strict, 1.0, 1.0 + _TIE_BUMP)


def _closest_in_block(valid, tt):
    """Each lane's closest valid candidate of one block: (t [.., 128],
    _BIG where none is valid; its triangle, the lowest index on ties)."""
    t_m = torch.where(valid, tt, _BIG)
    t_c = t_m.amin(dim=1)
    iota = torch.arange(CT, device=tt.device)[None, :, None]
    return t_c, torch.where(t_m <= t_c[:, None], iota, CT).amin(dim=1)


def _strict_hit(absd, su, sv, st, dist):
    """The any-hit test of each candidate: strictly inside (no margins)
    at 0 < t < dist."""
    return ((absd > 1e-30) & (su >= 0.0) & (sv >= 0.0)
            & (su + sv <= absd) & (st > 0.0) & (st < dist * absd))


def _first_occluder(valid):
    """Whether each lane is occluded in one block, and the triangles it
    tested: up to and including the first occluder, else all CT."""
    hit = valid.any(dim=1)
    # argmax gives the first occluder's index
    return hit, torch.where(hit, valid.to(torch.int32).argmax(dim=1) + 1, CT)


def inst_base(kslots: int) -> int:
    """Start of the per-slot instance ids that `map_cand_inst` appends to
    a candidate row."""
    return 1 + (2 + R) * kslots


def object_operand(m, d, oxd, o):
    """The ray operand in an instance's object frame: rows 0..8 of
    M10 @ [d, o x d, o, 1] (accel/cluster.py instance_operand_map), each
    row summed over the ten columns in order; K3's and K5's instanced
    variants sum alike (csrc/cluster.cuh xform_operand). m [..., 10, 10]
    broadcast against the lanes of d, oxd, o [3, ...]. Returns the object
    (d, o x d, o), [3, ...] each."""
    base = [*d, *oxd, *o]
    rows = []
    for k in range(9):
        acc = m[..., k, 0] * base[0]
        for j in range(1, 9):
            acc = acc + m[..., k, j] * base[j]
        rows.append(acc + m[..., k, 9] * 1.0)
    return (torch.stack(rows[0:3]), torch.stack(rows[3:6]),
            torch.stack(rows[6:9]))


def closest_hit_reference(cand, od, blocks, kslots: int, max_travel: float,
                          noprune: bool = False, stats: bool = False,
                          xf=None, micro=None):
    """K3's plain version (the function of `_kernel_a1`): for each group,
    walk its candidate clusters nearest first (stopping once no active
    lane's committed t reaches the next slot's hull entry), select each
    lane's closest split-bf16 hit with the edge margins and the tie bump
    (lowest triangle index, then earliest slot, wins ties), and refit the
    winner exactly in f32.

    cand [G,1,W] i32, od [OD_ROWS, N] f32 (N = G*FL), blocks [C,32,512]
    -> ha [HA_ROWS, N] f32; with `stats`, (ha, visits [G] i32: the slots
    each group visited). With `xf` ([I,10,10], instanced tables), the
    candidate rows carry pool block ids and the appended instance ids
    (`map_cand_inst`), each visit maps the ray into its instance's object
    frame, the refit runs on the winner's object ray, and HA_INST holds
    the winner's instance. With `micro` (the tables' omm_word [C, CT],
    flat tables): `_kernel_a1(omm=True)`, a micro-TRANSPARENT candidate
    is rejected in the selection unless it is near a micro-cell edge, and
    HA_UNK flags a winner whose cell is UNKNOWN or near an edge."""
    if micro is not None and xf is not None:
        raise ValueError("closest_hit: the instanced variant has no "
                         "micromaps")
    G = cand.shape[0]
    dev = od.device
    odg = od.view(OD_ROWS, G, FL)
    act = odg[OD_ACT] > 0.5
    best_t = torch.full((G, FL), _BIG, dtype=torch.float32, device=dev)
    best_c = torch.zeros((G, FL), dtype=torch.int64, device=dev)
    best_j = torch.zeros((G, FL), dtype=torch.int64, device=dev)
    best_i = torch.zeros((G, FL), dtype=torch.int64, device=dev)
    best_unk = torch.zeros((G, FL), dtype=torch.bool, device=dev)
    running = torch.ones((G,), dtype=torch.bool, device=dev)
    visits = torch.zeros((G,), dtype=torch.int32, device=dev)
    for i in range(kslots):
        running = running & (i < cand[:, 0, 0])
        if not noprune:
            bound = torch.where(act, best_t, 0.0).view(torch.int32).amax(1)
            running = running & (cand[:, 0, 1 + kslots + i] <= bound)
        gs = running.nonzero()[:, 0]
        if gs.numel() == 0:
            break
        visits += running
        cid = cand[gs, 0, 1 + i].long()
        blk = blocks[cid]
        ray = (odg[OD_D:OD_D + 3, gs], odg[OD_OXD:OD_OXD + 3, gs],
               odg[OD_O:OD_O + 3, gs])
        if xf is not None:
            iid = cand[gs, 0, inst_base(kslots) + i].long()
            ray = object_operand(xf[iid][:, None], *ray)
        hi, lo = _operand(*ray, *_center(blk))
        absd, su, sv, st = _signed(*_quantities(blk, hi, lo))
        valid, tt = _select(absd, su, sv, st, max_travel)
        if micro is not None:
            state, near = _candidate_states(valid, micro, cid, su, sv, absd)
            valid = valid & ((state != bf.MICRO_TRANSPARENT) | near)
            unk_c = (state == bf.MICRO_UNKNOWN) | near
        t_c, j_c = _closest_in_block(valid, tt)               # [g, FL]
        improved = t_c < best_t[gs]
        if micro is not None:
            unk_w = torch.gather(unk_c, 1, j_c[:, None])[:, 0]
            best_unk[gs] = torch.where(improved, unk_w, best_unk[gs])
        best_t[gs] = torch.where(improved, t_c, best_t[gs])
        best_c[gs] = torch.where(improved, cid[:, None], best_c[gs])
        best_j[gs] = torch.where(improved, j_c, best_j[gs])
        if xf is not None:
            best_i[gs] = torch.where(improved, iid[:, None], best_i[gs])
    ha = _refit(odg, blocks, best_t, best_c, best_j, max_travel,
                None if xf is None else (xf, best_i), best_unk)
    return (ha, visits) if stats else ha


def _winner_rows(blocks, best_c, best_j, had, rows):
    """Cluster attribute rows `rows` of each lane's winner ([len, G, FL];
    0 where the lane has no winner)."""
    flat = blocks.view(blocks.shape[0], -1)
    cols = torch.tensor([(CL.ATTR_BASE + a // 4) * CL.LANES + (a % 4) * CT
                         for a in rows], device=blocks.device)
    vals = flat[best_c[None], cols[:, None, None] + best_j[None]]
    return torch.where(had[None], vals, 0.0)


def _refit(odg, blocks, best_t, best_c, best_j, max_travel, inst=None,
           unk=None):
    """The winners' exact f32 refit and the HA rows. `inst` = (xf, best_i)
    on instanced tables: the refit runs on each winner's object ray (zero
    where a lane has no winner) and HA_INST holds its instance. `unk`
    [G, FL] bool: the winners' UNKNOWN flags (HA_UNK, where the refit
    keeps the hit)."""
    had = best_t < _BIG
    cen_cols = torch.tensor([CL.CENTER_ROW * CL.LANES + a * CT
                             for a in range(3)], device=blocks.device)
    flat = blocks.view(blocks.shape[0], -1)
    cen = torch.where(had[None], flat[best_c[None], cen_cols[:, None, None]],
                      0.0)
    geo = _winner_rows(blocks, best_c, best_j, had,
                       tuple(range(CL.AT_V0, CL.AT_E2 + 3)))
    v0, e1, e2 = geo[0:3], geo[3:6], geo[6:9]
    o, dr = odg[OD_O:OD_O + 3], odg[OD_D:OD_D + 3]
    if inst is not None:
        xf, best_i = inst
        dr, _, o = object_operand(xf[best_i], dr, odg[OD_OXD:OD_OXD + 3], o)
        dr, o = torch.where(had, dr, 0.0), torch.where(had, o, 0.0)
    ocl = o - cen
    pvec = W.cross3(dr, e2)
    detx = W.dot3(e1, pvec)
    ok = torch.abs(detx) > 1e-30
    inv = torch.where(ok, 1.0 / torch.where(ok, detx, 1.0), 0.0)
    tvec = ocl - v0
    u = W.dot3(tvec, pvec) * inv
    qvec = W.cross3(tvec, e1)
    v = W.dot3(dr, qvec) * inv
    tx = W.dot3(e2, qvec) * inv
    exact_ok = (ok & (u >= -REFIT_EPS) & (v >= -REFIT_EPS)
                & (u + v <= 1.0 + REFIT_EPS) & (tx > 0.0)
                & (tx < max_travel))
    extra = _winner_rows(blocks, best_c, best_j, had,
                         (CL.AT_VALID, CL.AT_GIDX) + ATTR_ROWS)
    hitr = had & exact_ok & (extra[0] > 0.5)
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    scale = 1.0 / torch.clamp(u + v, min=1.0)
    u = u * scale
    v = v * scale
    G = best_t.shape[0]
    inst_row = torch.full((G, FL), -1.0, device=best_t.device)
    if inst is not None:
        inst_row = torch.where(hitr, inst[1].to(torch.float32), -1.0)
    unk_row = torch.zeros((G, FL), device=best_t.device)
    if unk is not None:
        unk_row = (hitr & unk).to(torch.float32)
    ha = torch.cat([
        torch.stack([torch.where(hitr, tx, _BIG), u, v,
                     torch.where(hitr, detx, -1.0),
                     torch.where(hitr, extra[1], -1.0)]),
        extra[2:], unk_row[None], inst_row[None]])
    return ha.reshape(HA_ROWS, G * FL)


def occlusion_reference(cand, sh, blocks, kslots: int, stats: bool = False,
                        xf=None, micro=None, cover=None):
    """K5's plain version (the function of `_kernel_b1`): for each group,
    walk its candidate clusters until every lane is occluded; a lane is
    occluded by any triangle strictly inside (no margins) at
    0 < t < dist * (1 - SHADOW_T_EPS). Lanes without a request (SH_DO 0)
    count as occluded.

    cand [G,1,W] i32, sh [SH_ROWS, N] f32 -> occ [N] f32 (1 occluded);
    with `stats`, (occ, tests [G] i32: the ray-triangle pairs the group
    tested, a lane's test of a slot ending at its first occluder). With
    `xf` ([I,10,10]): `_kernel_b1_inst`, each visit in its instance's
    object frame (as closest_hit_reference). With `micro` and `cover`
    (omm_word, omm_cov [C, CT], flat tables): `_kernel_b1(omm=True)`, a
    micro-TRANSPARENT candidate never occludes, and an UNKNOWN or
    near-edge one occludes where the lane's alpha uniform (SH_UA) is
    under its coverage."""
    if micro is not None and xf is not None:
        raise ValueError("occlusion: the instanced variant has no "
                         "micromaps")
    G = cand.shape[0]
    shg = sh.view(SH_ROWS, G, FL)
    o = shg[SH_O:SH_O + 3]
    d = shg[SH_D:SH_D + 3]
    oxd = W.cross3(o, d)
    dist = shg[SH_DIST] * (1.0 - SHADOW_T_EPS)
    ua = shg[SH_UA]
    occ = torch.where(shg[SH_DO] > 0.5, 0.0, 1.0)
    running = torch.ones((G,), dtype=torch.bool, device=sh.device)
    tests = torch.zeros((G,), dtype=torch.int32, device=sh.device)
    for i in range(kslots):
        live = (occ < 0.5).sum(dim=1, dtype=torch.int32)
        running = running & (i < cand[:, 0, 0]) & (live > 0)
        gs = running.nonzero()[:, 0]
        if gs.numel() == 0:
            break
        cid = cand[gs, 0, 1 + i].long()
        blk = blocks[cid]
        ray = (d[:, gs], oxd[:, gs], o[:, gs])
        if xf is not None:
            iid = cand[gs, 0, inst_base(kslots) + i].long()
            ray = object_operand(xf[iid][:, None], *ray)
        hi, lo = _operand(*ray, *_center(blk))
        absd, su, sv, st = _signed(*_quantities(blk, hi, lo))
        valid = _strict_hit(absd, su, sv, st, dist[gs][:, None])
        if micro is not None:
            state, near = _candidate_states(valid, micro, cid, su, sv, absd)
            unk = (state == bf.MICRO_UNKNOWN) | near
            valid = valid & ((state != bf.MICRO_TRANSPARENT) | near) \
                & (~unk | (ua[gs][:, None] < cover[cid][:, :, None]))
        hit, tested = _first_occluder(valid)
        tests[gs] += torch.where(occ[gs] < 0.5, tested, 0).sum(
            dim=1, dtype=torch.int32)
        occ[gs] = torch.maximum(occ[gs], hit.float())
    occ = occ.reshape(G * FL)
    return (occ, tests) if stats else occ


def shade_reference(ha, fs, is_, tables, kcfg: bf.KernelConfig,
                    sample_idx: int, final_env: bool = False,
                    omm: bool = False, prio: bool = False, fs2=None):
    """K4's plain version (the function of `_kernel_a2`): surface_and_shade
    on K3's hits. ha [HA_ROWS, N], fs [NF, N], is_ [NI, N] ->
    (fs_out [NF, N], is_out [NI, N], sh [SH_ROWS, N], hit [NH, N]), plus
    surf [SF_ROWS, N] in the external modes (3-5) with lights, where hit
    row 5 is the shading flag (0 not shaded, 1 shaded at logical bounce
    0, 2 later) and the SH rows carry no request. `final_env`: the final
    environment-only round (bounce_fused.final_env_state, MIS in the NEE
    modes 1 and 2 only, as `_kernel_a2`), SH rows and hit row 5 zero.
    `omm` (`_kernel_a2(omm=True)`): HA_UNK feeds surface_and_shade's
    alpha test and pass-through, and SH_UA carries the alpha uniform.
    `prio` (`_kernel_a2(prio=True)`): the nested-priority false-hit
    pass-through of surface_and_shade. With the split rows `fs2` [NF2, N]
    (`_kernel_a2`'s split variant, bounce_clustered.py:469-494, :536-539,
    :557-559, :586-588) fs2_out comes last and SH_CDIFF holds the NEE
    contribution's diffuse part, which trace_paths_clustered merges after
    K5."""
    t = ha[HA_T]
    hit = t < _BIG
    front = ha[HA_FRONT] > 0.0
    if final_env:
        outs = bf.final_env_state(fs, is_, hit, tables.env, kcfg,
                                  tables.n_lights, (1, 2), fs2)
        sh = torch.zeros((SH_ROWS,) + t.shape, device=t.device)
        hit_out = torch.stack([torch.where(hit, t, 0.0), ha[HA_PRIM],
                               ha[HA_U], ha[HA_V], front.to(torch.float32),
                               torch.zeros_like(t)])
        return outs[:2] + (sh, hit_out) + outs[2:]

    def attr(i, k=1):
        return ha[HA_ATTR + i] if k == 1 else ha[HA_ATTR + i:HA_ATTR + i + k]

    s = bf.surface_and_shade(
        o=fs[bf.FS_O:bf.FS_O + 3], d=fs[bf.FS_D:bf.FS_D + 3], t=t, hit=hit,
        front=front, bu=ha[HA_U], bv=ha[HA_V], attr=attr,
        thp=fs[bf.FS_THP:bf.FS_THP + 3], L=fs[bf.FS_L:bf.FS_L + 3],
        prev_pdf=fs[bf.FS_PREVPDF], cone=fs[bf.FS_CONE],
        spread=fs[bf.FS_SPREAD], active=is_[bf.IS_ACTIVE] > 0,
        prev_delta=is_[bf.IS_PREVDELTA] > 0,
        med0=is_[bf.IS_MED0].to(torch.int64),
        med1=is_[bf.IS_MED1].to(torch.int64), px=is_[bf.IS_PX],
        py=is_[bf.IS_PY], budget=is_[bf.IS_BUDGET],
        lb=is_[bf.IS_LBOUNCE].to(torch.int64), tables=tables, kcfg=kcfg,
        sample_idx=sample_idx,
        omm_unknown=(ha[HA_UNK] > 0.5) if omm else None, prio=prio,
        **bf.split_args(fs2))
    fs_out = torch.cat([s["o_new"], s["wi_world"], s["thp"], s["L"],
                        s["prev_pdf"][None], s["cone"][None],
                        s["spread"][None]], dim=0)
    i32 = torch.int32
    is_out = torch.stack([s["active"].to(i32), s["prev_delta"].to(i32),
                          s["med0"].to(i32), s["med1"].to(i32),
                          is_[bf.IS_PX], is_[bf.IS_PY], is_[bf.IS_BUDGET],
                          s["lbounce"].to(i32)], dim=0)
    do = s["do_nee"].to(torch.float32)
    cdiff = torch.zeros((3,) + t.shape, device=t.device) if fs2 is None \
        else s["cdiff"]
    ua = s["u_alpha"] if omm else torch.zeros_like(t)
    sh = torch.cat([s["shadow_o"], s["shadow_d"], s["sdist"][None],
                    s["contrib"], do[None], cdiff, ua[None]], dim=0)
    ext = s["surf"] is not None
    flag = s["shaded"].to(torch.float32) \
        * (1.0 + (is_[bf.IS_LBOUNCE] > 0).to(torch.float32)) if ext else do
    hit_out = torch.stack([torch.where(hit, t, 0.0), ha[HA_PRIM], ha[HA_U],
                           ha[HA_V], front.to(torch.float32), flag], dim=0)
    outs = (fs_out, is_out, sh, hit_out) + ((s["surf"],) if ext else ())
    if fs2 is not None:
        outs += (torch.cat([s["ld"], s["ls"], s["fspec"][None]]),)
    return outs


# ---------------------------------------------------------------------------
# Plain PyTorch versions of K6 and K7 (the per-row route)
# ---------------------------------------------------------------------------


def _operand_rows(d, o, cx, cy, cz):
    """The per-row kernels' split-bf16 operand (bounce_clustered._row_cols):
    the origin is shifted first (o' = o - c) and o' x d is taken of the
    shifted origin, where K3's `_operand` shifts the global o x d."""
    ox, oy, oz = o[0] - cx, o[1] - cy, o[2] - cz
    op = [d[0], d[1], d[2], oy * d[2] - oz * d[1], oz * d[0] - ox * d[2],
          ox * d[1] - oy * d[0], ox, oy, oz]
    hi = [_bf16(x) for x in op]
    lo = [x - h for x, h in zip(op, hi)]
    one = torch.ones_like(op[0])
    return hi + [one], lo + [torch.zeros_like(one)]


def _row_entries(cand, kslots: int):
    """Each slot's per-row entry bits [G, kslots, R] of the candidate rows."""
    G = cand.shape[0]
    return cand[:, 0, 1 + 2 * kslots:1 + (2 + R) * kslots].reshape(
        G, kslots, R)


def _row_quantities(cand, i, rows, d, o, blocks):
    """Slot i's signed quantities (|det|, u, v, t) [p, CT, 128] for the
    128-lane rows `rows` [p] (row g * R + r of group g) against their
    group's candidate, with the per-row operand; d, o [3, G * R, 128]."""
    blk = blocks[cand[rows // R, 0, 1 + i].long()]
    hi, lo = _operand_rows(d[:, rows], o[:, rows], *_center(blk))
    return _signed(*_quantities(blk, hi, lo))


def _closest_rows(cand, fs, is_, blocks, kslots: int, max_travel: float,
                  noprune: bool = False):
    """K6's candidate walk and selection (the loop of `_kernel_a`): the
    group walks its list nearest first while some active lane's committed
    t reaches the slot's hull entry (as K3), and each 128-lane row visits
    a slot only where the row's own entry bits are at most the worst
    committed t of its active lanes (noprune: below +inf). The operand is
    the per-row one (`_operand_rows`) and t divides by |det|. Returns
    (best_t, best_c, best_j) [G, FL] and which slots each row visited
    [G * R, kslots] bool."""
    G = cand.shape[0]
    dev = fs.device
    o = fs[bf.FS_O:bf.FS_O + 3].reshape(3, G * R, 128)
    d = fs[bf.FS_D:bf.FS_D + 3].reshape(3, G * R, 128)
    act = (is_[bf.IS_ACTIVE] > 0).reshape(G * R, 128)
    te_rows = _row_entries(cand, kslots)
    best_t = torch.full((G * R, 128), _BIG, dtype=torch.float32, device=dev)
    best_c = torch.zeros((G * R, 128), dtype=torch.int64, device=dev)
    best_j = torch.zeros((G * R, 128), dtype=torch.int64, device=dev)
    running = torch.ones((G,), dtype=torch.bool, device=dev)
    visited = torch.zeros((G, R, kslots), dtype=torch.bool, device=dev)
    for i in range(kslots):
        running = running & (i < cand[:, 0, 0])
        bound = torch.where(act, best_t, 0.0).view(torch.int32).amax(
            -1).view(G, R)
        if noprune:
            row_on = te_rows[:, i] < _INF_BITS
        else:
            running = running & (cand[:, 0, 1 + kslots + i]
                                 <= bound.amax(1))
            row_on = te_rows[:, i] <= bound
        if not bool(running.any()):
            break
        row_on = row_on & running[:, None]
        visited[:, :, i] = row_on
        rows = row_on.reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        absd, su, sv, st = _row_quantities(cand, i, rows, d, o, blocks)
        t_c, j_c = _closest_in_block(*_select(absd, su, sv, st, max_travel,
                                              divide=True))   # [p, 128]
        improved = t_c < best_t[rows]
        cid = cand[rows // R, 0, 1 + i].long()
        best_t[rows] = torch.where(improved, t_c, best_t[rows])
        best_c[rows] = torch.where(improved, cid[:, None], best_c[rows])
        best_j[rows] = torch.where(improved, j_c, best_j[rows])
    return (best_t.view(G, FL), best_c.view(G, FL), best_j.view(G, FL),
            visited.reshape(G * R, kslots))


def closest_shade_reference(cand, fs, is_, tables, kcfg: bf.KernelConfig,
                            sample_idx: int, kslots: int, max_travel: float,
                            noprune: bool = False, final_env: bool = False,
                            stats: bool = False):
    """K6's plain version (the function of `_kernel_a`): the per-row walk
    (`_closest_rows`) over one page of candidates, K3's exact
    refit of the winner, and K4's shading of it (`shade_reference`, which
    is `_kernel_a`'s post-loop half). cand [G,1,1+(2+R)*kslots] i32, fs
    [NF, N], is_ [NI, N] (N = G*FL) -> (fs_out, is_out, sh [SH_ROWS, N],
    hit [NH, N]); with `stats`, also which slots each 128-lane row
    visited [N / 128, kslots] bool. `final_env`: the final
    environment-only round."""
    G = cand.shape[0]
    best_t, best_c, best_j, visited = _closest_rows(
        cand, fs, is_, tables.blocks, kslots, max_travel, noprune)
    odg = ray_operand(fs, is_).view(OD_ROWS, G, FL)
    ha = _refit(odg, tables.blocks, best_t, best_c, best_j, max_travel)
    out = shade_reference(ha, fs, is_, tables, kcfg, sample_idx, final_env)
    return (*out, visited) if stats else out


def occlusion_rows_reference(cand, sh, blocks, kslots: int,
                             stats: bool = False):
    """K7's plain version (the function of `_kernel_b`): lanes without a
    request (SH_DO 0) start occluded; the group walks its list while any
    lane is unoccluded, and a row visits a slot while some lane of it is
    unoccluded and its entry bits are below +inf. A lane is occluded by
    any triangle strictly inside (no margins) at 0 < t <
    dist * (1 - SHADOW_T_EPS), tested with the per-row operand
    (`_operand_rows`). cand [G,1,W] i32, sh [SH_ROWS, N] f32 -> occ [N]
    f32 (1 occluded or no request); with `stats`, (occ, tests [G] i32:
    the pairs the group's unoccluded lanes tested, each up to its first
    occluder)."""
    G = cand.shape[0]
    shr = sh.view(SH_ROWS, G * R, 128)
    o = shr[SH_O:SH_O + 3]
    d = shr[SH_D:SH_D + 3]
    dist = shr[SH_DIST] * (1.0 - SHADOW_T_EPS)
    occ = torch.where(shr[SH_DO] > 0.5, 0.0, 1.0)             # [G*R, 128]
    te_rows = _row_entries(cand, kslots)
    running = torch.ones((G,), dtype=torch.bool, device=sh.device)
    tests = torch.zeros((G * R,), dtype=torch.int32, device=sh.device)
    for i in range(kslots):
        open_r = (occ < 0.5).any(-1).view(G, R)
        running = running & (i < cand[:, 0, 0]) & open_r.any(1)
        if not bool(running.any()):
            break
        row_on = running[:, None] & open_r & (te_rows[:, i] < _INF_BITS)
        rows = row_on.reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        absd, su, sv, st = _row_quantities(cand, i, rows, d, o, blocks)
        valid = ((absd > 1e-30) & (su >= 0.0) & (sv >= 0.0)
                 & (su + sv <= absd) & (st > 0.0)
                 & (st < dist[rows][:, None] * absd))
        hit = valid.any(dim=1)                                # [p, 128]
        lane_on = occ[rows] < 0.5
        # argmax gives the first occluder's index
        tested = torch.where(hit, valid.to(torch.int32).argmax(dim=1) + 1, CT)
        tests[rows] += torch.where(lane_on, tested, 0).sum(dim=1,
                                                           dtype=torch.int32)
        occ[rows] = torch.maximum(occ[rows], hit.float())
    occ = occ.reshape(G * FL)
    tests = tests.view(G, R).sum(1, dtype=torch.int32)
    return (occ, tests) if stats else occ


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def _device_of(name, *tensors):
    """The one device of a wrapper's tensors: the CPU (the plain version)
    or CUDA (the kernel); any other device, or a mix, raises."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    for x in tensors[1:]:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {x.device}; "
                             f"all must be on the same device")
    return dev


def _check_cand(cand, kslots, dev, xf=None):
    """Check the candidate rows (and `xf`, on instanced tables): the
    instanced rows carry kslots appended instance ids."""
    g = cand.shape[0]
    width = inst_base(kslots) + (kslots if xf is not None else 0)
    bf._check("cand", cand, torch.int32, (g, 1, width), dev)
    if xf is not None:
        bf._check("xf", xf, torch.float32, (xf.shape[0], 10, 10), dev)


def _check_micro(micro, cover, blocks, dev):
    """Check the micromap side table ([C, CT] i32 words, f32 coverages)."""
    c = blocks.shape[0]
    bf._check("omm_word", micro, torch.int32, (c, CT), dev)
    if cover is not None:
        bf._check("omm_cov", cover, torch.float32, (c, CT), dev)


def closest_hit(cand, od, blocks, kslots: int, max_travel: float,
                noprune: bool = False, stats: bool = False, xf=None,
                micro=None):
    """K3 (csrc/cluster_closest.cu; its instanced variant with `xf`, its
    micromap variant with `micro`, counted as "cluster_closest_omm") for
    CUDA tensors, its plain version for CPU tensors. Arguments and results
    as in `closest_hit_reference`."""
    dev = _device_of("closest_hit", od, cand, blocks,
                     *(() if xf is None else (xf,)),
                     *(() if micro is None else (micro,)))
    if dev.type == "cpu":
        return closest_hit_reference(cand, od, blocks, kslots, max_travel,
                                     noprune, stats, xf=xf, micro=micro)
    if micro is not None and xf is not None:
        raise ValueError("closest_hit: the instanced variant has no "
                         "micromaps")
    g = cand.shape[0]
    _check_cand(cand, kslots, dev, xf)
    if micro is not None:
        _check_micro(micro, None, blocks, dev)
    bf._check("od", od, torch.float32, (OD_ROWS, g * FL), dev)
    bf._check("blocks", blocks, torch.float32,
              (blocks.shape[0], CL.BLK_ROWS, CL.LANES), dev)
    ha = torch.empty((HA_ROWS, g * FL), dtype=torch.float32, device=dev)
    visits = torch.zeros((g,), dtype=torch.int32, device=dev)
    if g:
        name = "cluster_closest" if xf is None else "cluster_closest_inst"
        extra = (xf.data_ptr(),) if xf is not None else (
            None if micro is None else micro.data_ptr(),)
        with torch.cuda.device(dev):
            kernels.CLUSTER_CLOSEST.launch(
                f"rtxpt_{name}", cand.data_ptr(), od.data_ptr(),
                blocks.data_ptr(), *extra,
                ha.data_ptr(), visits.data_ptr() if stats else None, g,
                kslots, float(max_travel), int(noprune),
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches[name + ("_omm" if micro is not None else "")] += 1
    return (ha, visits) if stats else ha


def occlusion(cand, sh, blocks, kslots: int, stats: bool = False, xf=None,
              micro=None, cover=None):
    """K5 (csrc/cluster_shadow.cu; `_kernel_b1_inst` with `xf`; its
    micromap variant with `micro` and `cover`, counted as
    "cluster_shadow_omm") for CUDA tensors, its plain version for CPU
    tensors. Arguments and results as in `occlusion_reference`."""
    dev = _device_of("occlusion", sh, cand, blocks,
                     *(() if xf is None else (xf,)),
                     *(() if micro is None else (micro, cover)))
    if dev.type == "cpu":
        return occlusion_reference(cand, sh, blocks, kslots, stats, xf=xf,
                                   micro=micro, cover=cover)
    if micro is not None and xf is not None:
        raise ValueError("occlusion: the instanced variant has no "
                         "micromaps")
    g = cand.shape[0]
    _check_cand(cand, kslots, dev, xf)
    if micro is not None:
        _check_micro(micro, cover, blocks, dev)
    bf._check("sh", sh, torch.float32, (SH_ROWS, g * FL), dev)
    bf._check("blocks", blocks, torch.float32,
              (blocks.shape[0], CL.BLK_ROWS, CL.LANES), dev)
    occ = torch.empty((g * FL,), dtype=torch.float32, device=dev)
    tests = torch.zeros((g,), dtype=torch.int32, device=dev)
    if g:
        name = "cluster_shadow" if xf is None else "cluster_shadow_inst"
        extra = (xf.data_ptr(),) if xf is not None else (
            (None, None) if micro is None
            else (micro.data_ptr(), cover.data_ptr()))
        with torch.cuda.device(dev):
            kernels.CLUSTER_SHADOW.launch(
                f"rtxpt_{name}", cand.data_ptr(), sh.data_ptr(),
                blocks.data_ptr(), *extra,
                occ.data_ptr(), tests.data_ptr() if stats else None, g,
                kslots, torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches[name + ("_omm" if micro is not None else "")] += 1
    return (occ, tests) if stats else occ


def shade(ha, fs, is_, tables, kcfg: bf.KernelConfig, sample_idx: int,
          final_env: bool = False, omm: bool = False, prio: bool = False,
          fs2=None):
    """K4 (csrc/cluster_shade.cu; its micromap variant with `omm`, its
    nested-priority variant with `prio`, its split variant with the split
    rows `fs2`) for CUDA tensors, its plain version for CPU tensors.
    Arguments and results as in `shade_reference`."""
    dev = _device_of("shade", fs, ha, is_, tables.mat_rows,
                     tables.light_rows)
    if final_env and tables.env is None:
        raise ValueError("shade: final_env needs the tables' environment")
    omm = omm and not final_env
    prio = prio and not final_env
    if dev.type == "cpu":
        return shade_reference(ha, fs, is_, tables, kcfg, sample_idx,
                               final_env, omm, prio, fs2)
    n = fs.shape[1]
    split = fs2 is not None
    if split:
        bf._check("fs2", fs2, torch.float32, (bf.NF2, n), dev)
    bf._check("ha", ha, torch.float32, (HA_ROWS, n), dev)
    bf._check("fs", fs, torch.float32, (bf.NF, n), dev)
    bf._check("is_", is_, torch.int32, (bf.NI, n), dev)
    bf._check("mat_rows", tables.mat_rows, torch.float32,
              (bf.MT_ROWS, 128), dev)
    bf._check("light_rows", tables.light_rows, torch.float32,
              (W.LROWS, 128), dev)
    if tables.env is not None:
        bf._check("env", tables.env, torch.float32, (bf.ET_SIZE,), dev)
    tex = bf.use_tex(tables, kcfg) and not final_env
    if tex:
        bf.check_tex_tables(tables, dev)
    if kcfg.nee_mode not in range(6):
        raise ValueError(f"shade: nee_mode {kcfg.nee_mode} not in 0..5")
    if kcfg.nee_mode in (1, 2) and tables.n_lights > bf.MAX_LIGHTS:
        raise ValueError("shade: more lights than the kernel's table")
    outs = (torch.empty_like(fs), torch.empty_like(is_),
            torch.empty((SH_ROWS, n), dtype=torch.float32, device=dev),
            torch.empty((bf.NH, n), dtype=torch.float32, device=dev))
    surf_out = None
    if kcfg.external and tables.n_lights > 0 and not final_env:
        surf_out = torch.empty((bf.SF_ROWS, n), dtype=torch.float32,
                               device=dev)
        outs += (surf_out,)
    fs2_out = torch.empty_like(fs2) if split else None
    if split:
        outs += (fs2_out,)
    if n == 0:
        return outs
    with torch.cuda.device(dev):
        kernels.CLUSTER_SHADE.launch(
            "rtxpt_cluster_shade", ha.data_ptr(), fs.data_ptr(),
            is_.data_ptr(), *(x.data_ptr() for x in outs[:4]),
            None if surf_out is None else surf_out.data_ptr(),
            fs2.data_ptr() if split else None,
            fs2_out.data_ptr() if split else None,
            tables.mat_rows.data_ptr(), tables.light_rows.data_ptr(),
            None if tables.env is None else tables.env.data_ptr(),
            *bf.tex_args(tables, tex), int(omm), int(prio), n,
            tables.n_lights,
            int(sample_idx) & rng.M32, kcfg.nee_mode, int(kcfg.enable_mis),
            kcfg.firefly, int(kcfg.rr_enable), kcfg.min_rr,
            int(kcfg.low_discrepancy), int(kcfg.energy_comp), kcfg.maxb,
            int(final_env), torch.cuda.current_stream(dev).cuda_stream)
    kernels.launches[bf.variant_name("cluster_shade", tables.env is not None,
                                     final_env, tex, omm, prio, split)] += 1
    return outs


def closest_shade(cand, fs, is_, tables, kcfg: bf.KernelConfig,
                  sample_idx: int, kslots: int, max_travel: float,
                  noprune: bool = False, final_env: bool = False,
                  stats: bool = False):
    """K6 (csrc/cluster_rows.cu; counted as "cluster_rows_closest_shade",
    with "_env", "_tex", "_tex_env" or as "..._final" by its variant) for
    CUDA tensors, its plain version for CPU tensors. Arguments and results
    as in `closest_shade_reference`. K6 has no export: with lights it
    shades in the kernel NEE modes 0-2 only (the per-row route has no
    external NEE)."""
    dev = _device_of("closest_shade", fs, cand, is_, tables.blocks,
                     tables.mat_rows, tables.light_rows)
    if final_env and tables.env is None:
        raise ValueError("closest_shade: final_env needs the tables' "
                         "environment")
    if kcfg.nee_mode not in range(6) or (kcfg.external
                                         and tables.n_lights > 0):
        raise ValueError(f"closest_shade: nee_mode {kcfg.nee_mode} with "
                         f"lights is not one of the kernel NEE modes 0..2")
    if dev.type == "cpu":
        return closest_shade_reference(cand, fs, is_, tables, kcfg,
                                       sample_idx, kslots, max_travel,
                                       noprune, final_env, stats)
    n = fs.shape[1]
    g = cand.shape[0]
    _check_cand(cand, kslots, dev)
    bf._check("fs", fs, torch.float32, (bf.NF, g * FL), dev)
    bf._check("is_", is_, torch.int32, (bf.NI, n), dev)
    bf._check("blocks", tables.blocks, torch.float32,
              (tables.blocks.shape[0], CL.BLK_ROWS, CL.LANES), dev)
    bf._check("mat_rows", tables.mat_rows, torch.float32,
              (bf.MT_ROWS, 128), dev)
    bf._check("light_rows", tables.light_rows, torch.float32,
              (W.LROWS, 128), dev)
    if tables.env is not None:
        bf._check("env", tables.env, torch.float32, (bf.ET_SIZE,), dev)
    tex = bf.use_tex(tables, kcfg) and not final_env
    if tex:
        bf.check_tex_tables(tables, dev)
    if kcfg.nee_mode in (1, 2) and tables.n_lights > bf.MAX_LIGHTS:
        raise ValueError("closest_shade: more lights than the kernel's "
                         "table")
    outs = (torch.empty_like(fs), torch.empty_like(is_),
            torch.empty((SH_ROWS, n), dtype=torch.float32, device=dev),
            torch.empty((bf.NH, n), dtype=torch.float32, device=dev))
    visited = torch.zeros((n // 128, kslots), dtype=torch.bool,
                          device=dev) if stats else None
    if g:
        with torch.cuda.device(dev):
            kernels.CLUSTER_ROWS.launch(
                "rtxpt_cluster_rows_closest_shade", cand.data_ptr(),
                fs.data_ptr(), is_.data_ptr(),
                *(x.data_ptr() for x in outs),
                None if visited is None else visited.data_ptr(),
                tables.blocks.data_ptr(), tables.mat_rows.data_ptr(),
                tables.light_rows.data_ptr(),
                None if tables.env is None else tables.env.data_ptr(),
                *bf.tex_args(tables, tex), g, kslots, float(max_travel),
                int(noprune), tables.n_lights, int(sample_idx) & rng.M32,
                kcfg.nee_mode, int(kcfg.enable_mis), kcfg.firefly,
                int(kcfg.rr_enable), kcfg.min_rr, int(kcfg.low_discrepancy),
                int(kcfg.energy_comp), kcfg.maxb, int(final_env),
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches[bf.variant_name(
            "cluster_rows_closest_shade", tables.env is not None, final_env,
            tex)] += 1
    return (*outs, visited) if stats else outs


def occlusion_rows(cand, sh, blocks, kslots: int, stats: bool = False):
    """K7 (csrc/cluster_rows.cu, counted as "cluster_rows_shadow") for
    CUDA tensors, its plain version for CPU tensors. Arguments and results
    as in `occlusion_rows_reference`."""
    dev = _device_of("occlusion_rows", sh, cand, blocks)
    if dev.type == "cpu":
        return occlusion_rows_reference(cand, sh, blocks, kslots, stats)
    g = cand.shape[0]
    _check_cand(cand, kslots, dev)
    bf._check("sh", sh, torch.float32, (SH_ROWS, g * FL), dev)
    bf._check("blocks", blocks, torch.float32,
              (blocks.shape[0], CL.BLK_ROWS, CL.LANES), dev)
    occ = torch.empty((g * FL,), dtype=torch.float32, device=dev)
    tests = torch.zeros((g,), dtype=torch.int32, device=dev)
    if g:
        with torch.cuda.device(dev):
            kernels.CLUSTER_ROWS.launch(
                "rtxpt_cluster_rows_shadow", cand.data_ptr(), sh.data_ptr(),
                blocks.data_ptr(), occ.data_ptr(),
                tests.data_ptr() if stats else None, g, kslots,
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches["cluster_rows_shadow"] += 1
    return (occ, tests) if stats else occ


# ---------------------------------------------------------------------------
# Wavefront loop
# ---------------------------------------------------------------------------


def page_boundary(cand, kslots: int):
    """Per-group lower bound of the next candidate page: the last kept
    slot as an (entry, cluster id) pair. A list that did not fill its
    kslots holds the whole feasible tail, so its bound is (3e38, 2^30)
    and the next page selects nothing."""
    sat = cand[:, 0, 0] >= kslots
    te = cand[:, 0, 2 * kslots].contiguous().view(torch.float32)
    lid = cand[:, 0, kslots]
    return (torch.where(sat, te, 3e38), torch.where(sat, lid, 2 ** 30))


def _pad(x, npad, fill=0):
    n = x.shape[0]
    if n == npad:
        return x
    tail = torch.full((npad - n,) + tuple(x.shape[1:]), fill,
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def map_cand_inst(cand, tbl, kslots: int):
    """Candidate rows of the cull (world candidate ids) -> the instanced
    kernels' rows: each slot's id replaced by its pool block id (the block
    K3 and K5 read) and the slots' instance ids appended at
    `inst_base(kslots)`. Flat tables keep their rows. The next page's
    boundary is taken from the rows before this map: the world ids are
    the page order's tiebreak."""
    if not tbl.instanced:
        return cand
    ids = torch.clamp(cand[:, 0, 1:1 + kslots], 0, tbl.n_clusters - 1).long()
    return torch.cat([cand[:, 0, 0:1], tbl.wc_block[ids],
                      cand[:, 0, 1 + kslots:], tbl.wc_inst[ids]],
                     dim=1)[:, None, :].contiguous()


def post_attr_inst(ha, tbl):
    """The attribute post-transform of instanced hits (the JAX package's
    _post_attr_inst): per winner instance (HA_INST), the object-space
    normals N0, N1, N2 and GN through the normal matrix and renormalised,
    the tangent through the o2w linear part, and the LOD bias shifted by
    the instance's area term inst_post[18]. Runs on the merged pages' HA
    rows [HA_ROWS, N]; flat tables keep their rows."""
    if not tbl.instanced:
        return ha
    with record_function("rtxpt.post"):
        return _post_attr(ha, tbl)


def _post_attr(ha, tbl):
    post = tbl.inst_post[torch.clamp(ha[HA_INST].long(), min=0)]   # [N,19]
    out = ha.clone()

    def rot(base, moff, renorm):
        v = ha[HA_ATTR + base:HA_ATTR + base + 3]
        r = torch.stack([post[:, moff + 3 * k] * v[0]
                         + post[:, moff + 3 * k + 1] * v[1]
                         + post[:, moff + 3 * k + 2] * v[2]
                         for k in range(3)])
        if renorm:
            r = r / torch.sqrt(torch.clamp(
                r[0] * r[0] + r[1] * r[1] + r[2] * r[2], min=1e-24))
        out[HA_ATTR + base:HA_ATTR + base + 3] = r

    for base in (bf.AT_N0, bf.AT_N1, bf.AT_N2, bf.AT_GN):
        rot(base, 9, True)
    rot(bf.AT_TANG, 0, False)
    out[HA_ATTR + bf.AT_LODB] = ha[HA_ATTR + bf.AT_LODB] + post[:, 18]
    return out


def scene_bounds(tbl):
    """(lo [3], extent [3]) of the cluster boxes: the grid of the ray
    coherence key."""
    lo = tbl.aabb_lo.amin(dim=0)
    return lo, torch.clamp(tbl.aabb_hi.amax(dim=0) - lo, min=1e-6)


def ray_operand(fs, is_):
    """K3's ray operand rows [OD_ROWS, N] of a wavefront state."""
    o3 = fs[bf.FS_O:bf.FS_O + 3]
    d3 = fs[bf.FS_D:bf.FS_D + 3]
    act = (is_[bf.IS_ACTIVE] > 0).to(torch.float32)
    return torch.cat([d3, W.cross3(o3, d3), o3, act[None]]).contiguous()


def cull(o3, d3, active, tmax, tbl, kslots: int, lo=None):
    """`cull_candidates` for flat rows: o3, d3 [3, N], active [N] bool, tmax
    a float or [N], N a multiple of 1024. Returns (cand, overflow)."""
    g = o3.shape[1] // FL

    def groups(x):
        return x.reshape(x.shape[:-1] + (g, R, 128))

    if isinstance(tmax, torch.Tensor):
        tmax = groups(tmax)
    with record_function("rtxpt.cull"):
        return cull_candidates(groups(o3), groups(d3), groups(active), tmax,
                               tbl.aabb_lo, tbl.aabb_hi, kslots, lo=lo)


def sort_wavefront(fs, is_, src, first: bool, bounds, fs2=None):
    """The wavefront sort before a bounce: pixel Morton order at bounce 0
    (the camera rays share an origin), the ray coherence key after;
    inactive lanes last. Returns (fs, is_, src) permuted alike, and the
    split rows `fs2` too when given (bounce_clustered.py:1739-1780)."""
    active = is_[bf.IS_ACTIVE] > 0
    if first:
        key = torch.where(active,
                          pixel_morton_key(is_[bf.IS_PX], is_[bf.IS_PY]),
                          2 ** 30)
    else:
        key = ray_coherence_key(fs[bf.FS_O:bf.FS_O + 3],
                                fs[bf.FS_D:bf.FS_D + 3], *bounds, active)
    with record_function("rtxpt.sort"):
        _, perm = torch.sort(key, stable=True)
        out = fs[:, perm], is_[:, perm], src[perm]
        return out if fs2 is None else out + (fs2[:, perm],)


def sort_shadows(sh, bounds):
    """The shadow-ray sort: rows K5 reads ([SH_ROWS, N]: origin,
    direction, distance, request and alpha uniform; the others zero) in
    ray coherence order, and the permutation to undo it."""
    do = sh[SH_DO] > 0.5
    key = ray_coherence_key(sh[SH_O:SH_O + 3], sh[SH_D:SH_D + 3], *bounds,
                            do)
    # the request flag rides in the sign of the distance
    dodist = torch.where(do, sh[SH_DIST], -sh[SH_DIST])
    with record_function("rtxpt.sort"):
        _, rows, perm = sort_rows_by_key(
            key, torch.cat([sh[SH_O:SH_D + 3], dodist[None],
                            sh[SH_UA:SH_UA + 1]]))
    shp = torch.zeros_like(sh)
    shp[SH_O:SH_D + 3] = rows[0:6]
    shp[SH_DIST] = torch.abs(rows[6])
    shp[SH_DO] = (rows[6] > 0.0).to(torch.float32)
    shp[SH_UA] = rows[7]
    return shp, perm


def closest_paged(fs, is_, tbl, kslots: int, pages: int, max_travel: float,
                  noprune: bool = False, omm: bool = False):
    """K3 over `pages` pages of each group's candidate order: page p culls
    the clusters after page p-1's last slot, up to each lane's committed
    t, and the pages merge by least t; `omm`: K3's micromap variant.
    Returns (ha [HA_ROWS, N], the final page's cull overflow); on
    instanced tables the attribute rows are still in object space
    (`post_attr_inst`)."""
    o3 = fs[bf.FS_O:bf.FS_O + 3]
    d3 = fs[bf.FS_D:bf.FS_D + 3]
    active = is_[bf.IS_ACTIVE] > 0
    od = ray_operand(fs, is_)
    ha, lo, tmax = None, None, max_travel
    for p in range(pages):
        cand, ovf = cull(o3, d3, active, tmax, tbl, kslots, lo=lo)
        ha_p = closest_hit(map_cand_inst(cand, tbl, kslots), od, tbl.blocks,
                           kslots, max_travel, noprune, xf=tbl.xf,
                           micro=tbl.omm_word if omm else None)
        ha = ha_p if ha is None else torch.where(
            ha_p[HA_T:HA_T + 1] < ha[HA_T:HA_T + 1], ha_p, ha)
        if p + 1 < pages:
            lo = page_boundary(cand, kslots)
            tmax = torch.clamp(ha[HA_T], max=max_travel)
    return ha, ovf


def occluded_paged(shp, tbl, kslots: int, pages: int, omm: bool = False):
    """K5 over `pages` pages of the sorted shadow rays' candidate order; a
    lane takes part until a page occludes it, and the pages merge by OR;
    `omm`: K5's micromap variant. Returns (occ [N], the final page's cull
    overflow)."""
    # The cull's active mask stays the page-0 mask, so that each
    # cluster's hull entry (the page order) is the same on every page;
    # finished lanes drop out through tmax = -3e38 instead.
    dop = shp[SH_DO] > 0.5
    occ, lo = None, None
    for p in range(pages):
        part = dop if occ is None else dop & (occ < 0.5)
        shp_p = shp
        if occ is not None:
            shp_p = shp.clone()
            shp_p[SH_DO] = part.to(torch.float32)
        tmax_p = torch.where(part, shp[SH_DIST], -3e38)
        cand, ovf = cull(shp[SH_O:SH_O + 3], shp[SH_D:SH_D + 3], dop, tmax_p,
                         tbl, kslots, lo=lo)
        occ_p = occlusion(map_cand_inst(cand, tbl, kslots), shp_p,
                          tbl.blocks, kslots, xf=tbl.xf,
                          micro=tbl.omm_word if omm else None,
                          cover=tbl.omm_cov if omm else None)
        occ = occ_p if occ is None else torch.where(part, occ_p, occ)
        if p + 1 < pages:
            lo = page_boundary(cand, kslots)
    return occ, ovf


def per_row_unserved(scene, tables):
    """What the per-row route (`FLAT` false) does not serve on this scene,
    by name: what the JAX package's clustered_structural_ok leaves to the
    flat kernels (rtxpt_tpu/pt/dispatch.py:129-143). Empty under FLAT."""
    if FLAT:
        return []
    out = []
    if getattr(scene, "tri_opacity", None) is not None:
        out.append("opacity micromaps")
    if getattr(scene, "has_nested_priorities", False):
        out.append("nested priorities")
    if getattr(tables, "instanced", False):
        out.append("instanced cluster tables")
    return out


def trace_paths_clustered(scene, cfg, o, d, cone_spread, px, py,
                          sample_idx, neeat_state=None,
                          want_aux: bool = False):
    """Trace a wavefront of camera rays to completion on the clustered
    tier (bounce_clustered.trace_paths_clustered of the JAX package, the
    flat all-rows route), flat or
    instanced; textures go in-kernel with stochastic texture filtering
    only (`bounce_fused.use_tex`). `cfg` is resolved by
    `dispatch.resolve`, which sets kslots, pages and nee_external.

    Tables with micromaps run them with the texture path only
    (bounce_clustered.py:1579): K3, K4 and K5 take their micromap
    variants, the shadow rays carry each lane's alpha uniform (SH_UA,
    K4's or, on the external route, `bounce_fused.alpha_uniform`), and
    `cfg.passthrough_extra_iters` more rounds let pass-through lanes reach
    their max_bounces. A scene with nested priorities runs K4's priority
    variant and the same extra rounds (bounce_clustered.py:1974-1982).

    In the external-NEE modes (`cfg.nee_external`, or NEE-AT) K4 exports
    the shaded surface, `external_nee` selects and evaluates the light per
    lane (each lane's logical bounce keys its seed), its emission term is
    added, and its shadow requests, packed into the SH rows, go through
    the same sort, cull and K5 as the kernel's; with `neeat_state`, each
    bounce's NEE luminance is accumulated into the frame's NEE-AT feedback
    histogram ("rtxpt.nee" and "rtxpt.feedback" ranges, as on the fused
    tier). With an environment, the final round follows the last bounce.

    With `cfg.split_channels` (flat route only) K4 runs its split variant
    on the split rows fs2, which ride every sort; its SH_CDIFF rows (or
    external_nee's cdiff) split the unoccluded NEE contribution after K5,
    NEE-AT's deferred emission of the lanes past their first vertex goes
    to the first scatter's channel, and the result holds L_diff and L_spec
    [N,3] in the lanes' original order (bounce_clustered.py:1844-1861,
    :1953-1958, :2061-2067). With `want_aux` it holds the aux guide
    buffers of the bounce-0 hits, unsorted by that bounce's permutation
    (bounce_fused.first_hit_aux, bounce_clustered.py:2071-2095); on
    instanced tables the hits carry their instance, so that the buffers
    are in world space as on the TLAS route (the JAX tier's are in object
    space: ROADMAP F13).

    With `FLAT` false the per-row route runs instead (module docstring):
    K6 and K7 over one page each, `cfg.cluster_pages` unused.

    o, d [N,3]; cone_spread [N]; px, py [N] int. Returns dict(L [N,3],
    ray_count, occupancy [B+1], cull_overflow) with the counts as int64
    tensors, plus neeat_hist on the NEE-AT route and the split and aux
    buffers above."""
    tbl = scene.cluster_tables
    dev = o.device
    n = o.shape[0]
    npad = _round_up(max(n, FL), FL)
    kslots, pages = int(cfg.cluster_kslots), int(cfg.cluster_pages)
    if kslots < 1 or pages < 1:
        raise ValueError("trace_paths_clustered needs the kslots and pages "
                         "that dispatch.resolve sets")
    max_travel = float(cfg.max_ray_travel)
    noprune = bool(cfg.cluster_noprune)
    sort_rays = bool(cfg.sort_rays)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    use_nee = kcfg.nee_mode in (1, 2) and tbl.n_lights > 0
    ext = kcfg.external and tbl.n_lights > 0
    omm = tbl.omm and bf.use_tex(tbl, kcfg)
    prio = bool(getattr(scene, "has_nested_priorities", False))
    split = bool(cfg.split_channels)
    if not FLAT:
        unserved = per_row_unserved(scene, tbl) + (
            ["external NEE"] if ext else []) + (
            ["split diffuse/specular channels"] if split else [])
        if unserved:
            raise NotImplementedError("the per-row clustered route does not "
                                      "serve: " + ", ".join(unserved))
    hist = None
    if ext:
        from rtxpt_tpu_torch.lighting import neeat as na
        from rtxpt_tpu_torch.pt.nee_external import external_nee
        if kcfg.nee_mode == 3 and neeat_state is not None:
            hist = na.zero_hist(neeat_state)

    fs, is_ = bf.initial_state(_pad(o, npad), _pad(d, npad, 1.0),
                               _pad(cone_spread, npad), _pad(px, npad),
                               _pad(py, npad))
    is_[bf.IS_ACTIVE, n:] = 0
    src = torch.arange(npad, dtype=torch.int32, device=dev)
    bounds = scene_bounds(tbl)
    fs2 = torch.zeros((bf.NF2, npad), dtype=torch.float32, device=dev) \
        if split else None
    hit0 = src0 = None

    ray_count = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    occupancy = []
    extra = int(getattr(cfg, "passthrough_extra_iters", 2)) \
        if omm or prio else 0
    for b in range(cfg.max_bounces + extra):
        if sort_rays and split:
            fs, is_, src, fs2 = sort_wavefront(fs, is_, src, b == 0, bounds,
                                               fs2)
        elif sort_rays:
            fs, is_, src = sort_wavefront(fs, is_, src, b == 0, bounds)
        n_active = (is_[bf.IS_ACTIVE] > 0).sum(dtype=torch.int64)
        occupancy.append(n_active)
        if not FLAT:
            # one page: the cull, then K6 (closest hit and shading)
            cand, ovf = cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                             is_[bf.IS_ACTIVE] > 0, max_travel, tbl, kslots)
            fs, is_, sh, hitb = closest_shade(cand, fs, is_, tbl, kcfg,
                                              sample_idx, kslots, max_travel,
                                              noprune)
        else:
            ha, ovf = closest_paged(fs, is_, tbl, kslots, pages, max_travel,
                                    noprune, omm)
            ha = post_attr_inst(ha, tbl)
            d_in = fs[bf.FS_D:bf.FS_D + 3]
            prev_pdf_in = fs[bf.FS_PREVPDF]
            prev_delta_in = is_[bf.IS_PREVDELTA] > 0
            lb_in = is_[bf.IS_LBOUNCE]
            out = shade(ha, fs, is_, tbl, kcfg, sample_idx, omm=omm,
                        prio=prio, fs2=fs2)
            fs, is_, sh, hitb = out[:4]
            if split:
                fs2 = out[-1]
        if b == 0:
            hit0, src0 = hitb, src
            if FLAT and tbl.instanced:
                # the winners' instances: the aux rows in world space (F13)
                hit0 = torch.cat([hitb, ha[HA_INST:HA_INST + 1]])
        ray_count = ray_count + n_active
        overflow = overflow + ovf
        if ext:
            # hitb[5]: 0 = not shaded, 1 = shaded at lb == 0, 2 = at lb > 0
            with record_function("rtxpt.nee"):
                res = external_nee(scene, cfg, neeat_state, out[4], d_in,
                                   hitb[5] > 0.5, prev_pdf_in, prev_delta_in,
                                   is_[bf.IS_PX], is_[bf.IS_PY], sample_idx,
                                   0, first_spec=(fs2[bf.F2_FSPEC] > 0.5)
                                   if split else None, lb=lb_in)
                fs[bf.FS_L:bf.FS_L + 3] += res["em_add"].T
                if split and kcfg.nee_mode == 3:
                    # NEE-AT's deferred emission past the first vertex
                    em_t = torch.where(lb_in > 0, res["em_add"].T, 0.0)
                    fs2 = bf.split_add(fs2, torch.where(
                        fs2[bf.F2_FSPEC] > 0.5, 0.0, em_t), em_t)
                ua = bf.alpha_uniform(cfg, is_[bf.IS_PX], is_[bf.IS_PY],
                                      lb_in, sample_idx) if omm \
                    else torch.zeros((npad,), device=dev)
                sh = torch.cat([
                    res["shadow_o"].T, res["shadow_d"].T, res["sdist"][None],
                    res["contrib"].T, res["do_nee"].to(torch.float32)[None],
                    res["cdiff"].T if split else torch.zeros(
                        (SH_UA - SH_CDIFF, npad), device=dev),
                    ua[None]])
        if use_nee or ext:
            do = sh[SH_DO] > 0.5
            if sort_rays:
                shp, sperm = sort_shadows(sh, bounds)
            else:
                shp = sh
            if FLAT:
                occ, ovf = occluded_paged(shp, tbl, kslots, pages, omm)
            else:
                # one page: the cull up to each request's distance, then K7
                dop = shp[SH_DO] > 0.5
                cand, ovf = cull(shp[SH_O:SH_O + 3], shp[SH_D:SH_D + 3], dop,
                                 shp[SH_DIST], tbl, kslots)
                occ = occlusion_rows(cand, shp, tbl.blocks, kslots)
            if sort_rays:
                occ = unsort_rows(sperm, occ[None])[0]
            ok = do & (occ < 0.5)
            fs[bf.FS_L:bf.FS_L + 3] += torch.where(
                ok, sh[SH_CONTRIB:SH_CONTRIB + 3], 0.0)
            if split:
                fs2 = bf.split_add(
                    fs2, torch.where(ok, sh[SH_CDIFF:SH_CDIFF + 3], 0.0),
                    torch.where(ok, sh[SH_CONTRIB:SH_CONTRIB + 3], 0.0))
            ray_count = ray_count + do.sum(dtype=torch.int64)
            overflow = overflow + ovf
            if hist is not None:
                with record_function("rtxpt.feedback"):
                    c = sh[SH_CONTRIB:SH_CONTRIB + 3]
                    lum = c[0] * 0.2126 + c[1] * 0.7152 + c[2] * 0.0722
                    hist = na.accumulate_feedback(
                        neeat_state, hist, res["tile"], res["li"],
                        torch.clamp(lum, min=0.0), ok)
    if tbl.env is not None:
        # the final environment-only round for the rays still active
        with record_function("rtxpt.final"):
            n_active = (is_[bf.IS_ACTIVE] > 0).sum(dtype=torch.int64)
            if FLAT:
                ha, ovf = closest_paged(fs, is_, tbl, kslots, pages,
                                        max_travel, noprune, omm)
                ha = post_attr_inst(ha, tbl)
                out = shade(ha, fs, is_, tbl, kcfg, sample_idx,
                            final_env=True, fs2=fs2)
                fs, is_ = out[:2]
                if split:
                    fs2 = out[-1]
            else:
                cand, ovf = cull(fs[bf.FS_O:bf.FS_O + 3],
                                 fs[bf.FS_D:bf.FS_D + 3],
                                 is_[bf.IS_ACTIVE] > 0, max_travel, tbl,
                                 kslots)
                fs, is_, _, _ = closest_shade(cand, fs, is_, tbl, kcfg,
                                              sample_idx, kslots, max_travel,
                                              noprune, final_env=True)
            ray_count = ray_count + n_active
            overflow = overflow + ovf
    occupancy.append((is_[bf.IS_ACTIVE] > 0).sum(dtype=torch.int64))
    L = fs[bf.FS_L:bf.FS_L + 3]
    if sort_rays:
        L = unsort_rows(src, L)
    result = dict(L=L.T[:n], ray_count=ray_count,
                  occupancy=torch.stack(occupancy), cull_overflow=overflow)
    if split:
        f2 = fs2[bf.F2_LD:bf.F2_LS + 3]
        if sort_rays:
            f2 = unsort_rows(src, f2)
        result.update(L_diff=f2[0:3].T[:n], L_spec=f2[3:6].T[:n])
    if hist is not None:
        result["neeat_hist"] = hist
    if want_aux:
        if sort_rays:
            hit0 = unsort_rows(src0, hit0)
        result.update(bf.first_hit_aux(scene, cfg, hit0[:, :n], o, d,
                                       cone_spread, split))
    return result

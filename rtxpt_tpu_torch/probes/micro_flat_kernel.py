"""K11, the all-rows flat-lane clustered intersection probe (counterpart of
scripts/micro_flat_kernel.py).

The JAX package's probe of the flat form that became its clustered
closest-hit kernel K3: a group's 1024 rays arrive flat (od [G, 6, 1024]);
the ray operand [d, o x d, o, 1] is split once into r_hi = bf16(rvec) and
r_lo = rvec - r_hi; per visited cluster one product of the block's
split-bf16 rows (chi, clo) with [r_hi, r_lo, r_hi] gives det, u, v and t of
its 128 triangles for every lane, and one selection (sign, 2e-3 margins,
t = st / max(|det|, 1e-30), the minimum over the triangles and the first
triangle reaching it) updates the lane's winner when the cluster's t is
strictly smaller. The outputs are t and prim = cluster * 128 + triangle
(f32), lane r * 128 + l at [r, l] of [G, 8, 128].

`run` launches K11 (csrc/probe_flat.cu) on CUDA tensors and runs the plain
version `flat_reference` on CPU tensors; both sum the 30 live products in
the same order, so they agree bit for bit on the card. The products are
f32 with the operands as given: the JAX kernel's default-precision dot in
interpret mode on the CPU. A TPU would also round r_lo to bf16; the port
does not.

    python -m rtxpt_tpu_torch.probes.micro_flat_kernel [--device cpu]

prints the script's lines: its brute-force check (here in float64) on
sampled lanes of the first two groups (t within TOL_T * max(1, t)), which
at seed 0 sees no hit, then the same check on every lane of those groups
against the triangles the probe intersects (`local_tris`), the same on
rays aimed at those triangles (`aimed_rays`, the kernel's margins), and,
on the card, the time of 32 groups x 16 visits.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.probes import one_device

CT = 128
KSLOTS = 16
BIG = 1e30
FLAT = 1024               # rays per group, flat lanes
KC = 10                   # coefficient rows: d, o x d, o, 1
BLOCK_ROWS = 24           # rows of a cluster block (hi 0..9, lo 10..19)
CLUSTERS = 64             # the script's clusters
GROUPS = 32               # the script's groups on the card (2 on the CPU)
REPS = 20                 # timed runs (the script's)
LANE_STEP = 73            # the script's sampled lanes
TOL_T = 2e-2              # the script's limit on t
SCRIPT_MARGINS = (1e-3, 1e-3)   # the script's brute force: u, v >= -1e-3,
#                                u + v <= 1 + 1e-3
KERNEL_MARGINS = (2e-3, 4e-3)   # the kernel's selection: su, sv >= -2e-3
#                                |det|, su + sv <= |det| + 2 * 2e-3 |det|
MARGIN_SLACK = 1e-4             # the aimed check's margins, this much
#                                narrower and wider (the kernel's f32 u, v
#                                are off by ~1e-5 near an edge)
GRAZING = 1e-2                  # and its narrower brute force leaves out
#                                triangles whose plane the ray meets at
#                                |cos| < 1e-2 to the normal, where the
#                                split-bf16 det loses its sign
_CHUNK = 32               # groups per step of the plain version


def bf16_round_np(x):
    """Round f32 to the nearest bf16 (ties to even) as f32: the script's
    uint32 arithmetic (micro_flat_kernel.py:206-208)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(
        np.uint32).view(np.float32)


def bf16_split(x):
    """(hi, lo) = (x rounded to bf16, x - hi), both f32 (the script's
    _bf16_split)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, x - hi


def inputs(seed=0, groups=GROUPS):
    """The script's arrays, drawn with numpy in its order: cand [G, 1, 17]
    i32 (16, then 16 distinct clusters), od [G, 6, 1024] f32, blocks
    [64, 24, 512] f32 (the bf16 hi and lo rows of each cluster's
    coefficients), and for the brute-force checks tris [64, 128, 3, 3] and
    centers [64, 3] f32."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20, 20, (CLUSTERS, 3)).astype(np.float32)
    blocks = np.zeros((CLUSTERS, BLOCK_ROWS, 4 * CT), np.float32)
    tris = np.zeros((CLUSTERS, CT, 3, 3), np.float32)
    for c in range(CLUSTERS):
        v0 = centers[c] + rng.uniform(-2, 2, (CT, 3))
        e1 = rng.uniform(-0.5, 0.5, (CT, 3))
        e2 = rng.uniform(-0.5, 0.5, (CT, 3))
        tris[c, :, 0] = v0
        tris[c, :, 1] = v0 + e1
        tris[c, :, 2] = v0 + e2
        n = np.cross(e1, e2)
        v0l = v0 - centers[c]
        coef = np.zeros((KC, 4 * CT), np.float32)
        coef[0:3, 0 * CT:1 * CT] = -n.T
        coef[0:3, 1 * CT:2 * CT] = np.cross(v0l, e2).T
        coef[3:6, 1 * CT:2 * CT] = e2.T
        coef[0:3, 2 * CT:3 * CT] = -np.cross(v0l, e1).T
        coef[3:6, 2 * CT:3 * CT] = -e1.T
        coef[6:9, 3 * CT:4 * CT] = n.T
        coef[9, 3 * CT:4 * CT] = -np.einsum("tj,tj->t", v0l, n)
        hi = bf16_round_np(coef)
        blocks[c, 0:KC] = hi
        blocks[c, KC:2 * KC] = bf16_round_np(coef - hi)
    o = rng.uniform(-25, 25, (groups, 3, FLAT)).astype(np.float32)
    d = rng.standard_normal((groups, 3, FLAT)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cand = np.zeros((groups, 1, 1 + KSLOTS), np.int32)
    cand[:, 0, 0] = KSLOTS
    for g in range(groups):
        cand[g, 0, 1:] = rng.choice(CLUSTERS, KSLOTS, replace=False)
    od = np.concatenate([o, d], axis=1)
    return dict(cand=cand, od=od, blocks=blocks, tris=tris, centers=centers)


def _operand(od):
    """r_hi, r_lo [g, 10, 1024] of rays od [g, 6, 1024]."""
    o0, o1, o2, d0, d1, d2 = od.unbind(1)
    rvec = torch.stack([d0, d1, d2, o1 * d2 - o2 * d1, o2 * d0 - o0 * d2,
                        o0 * d1 - o1 * d0, o0, o1, o2,
                        torch.ones_like(o0)], dim=1)
    return bf16_split(rvec)


def flat_reference(cand, od, blocks):
    """The plain version of K11: (t, prim) [G, 8, 128] f32."""
    g = od.shape[0]
    dev = od.device
    t_out = torch.empty((g, FLAT), dtype=torch.float32, device=dev)
    p_out = torch.empty((g, FLAT), dtype=torch.float32, device=dev)
    iota = torch.arange(CT, device=dev)[None, :, None]
    for lo in range(0, g, _CHUNK):
        hi = min(g, lo + _CHUNK)
        r_hi, r_lo = _operand(od[lo:hi])
        r_hi, r_lo = r_hi[:, :, None, :], r_lo[:, :, None, :]
        count = cand[lo:hi, 0, 0]
        best_t = torch.full((hi - lo, FLAT), BIG, dtype=torch.float32,
                            device=dev)
        best_j = torch.zeros_like(best_t)
        best_c = torch.zeros_like(best_t)
        for i in range(KSLOTS):
            live = count > i
            if not bool(live.any()):
                break
            cid = cand[lo:hi, 0, 1 + i]
            blk = blocks[cid.long()][:, :, :, None]   # [g, 24, 512, 1]
            chi, clo = blk[:, 0:KC], blk[:, KC:2 * KC]
            p = chi[:, 0] * r_hi[:, 0]                # [g, 512, 1024]
            for k in range(1, KC):
                p = p + chi[:, k] * r_hi[:, k]
            for k in range(KC):
                p = p + chi[:, k] * r_lo[:, k]
            for k in range(KC):
                p = p + clo[:, k] * r_hi[:, k]
            det, un, vn, tn = p.split(CT, dim=1)
            sgn = torch.where(det >= 0.0, 1.0, -1.0)
            absd, su, sv, st = det * sgn, un * sgn, vn * sgn, tn * sgn
            mm = 2e-3 * absd
            valid = ((absd > 1e-30) & (su >= -mm) & (sv >= -mm)
                     & (su + sv <= (absd + mm) + mm) & (st > 0.0))
            t_m = torch.where(valid, st / torch.clamp_min(absd, 1e-30), BIG)
            t_c = torch.amin(t_m, dim=1)              # [g, 1024]
            jrow = torch.amin(torch.where(t_m <= t_c[:, None], iota, CT),
                              dim=1).to(torch.float32)
            better = live[:, None] & (t_c < best_t)
            best_t = torch.where(better, t_c, best_t)
            best_j = torch.where(better, jrow, best_j)
            best_c = torch.where(better, cid.to(torch.float32)[:, None],
                                 best_c)
        t_out[lo:hi] = best_t
        p_out[lo:hi] = best_j + best_c * float(CT)
    return t_out.view(g, 8, 128), p_out.view(g, 8, 128)


def run(cand, od, blocks):
    """K11 over cand [G, 1, 17] i32 (ids in [0, C)), od [G, 6, 1024] f32 and
    blocks [C, 24, 512] f32: (t, prim) [G, 8, 128] f32. CUDA tensors launch
    the kernel, CPU tensors run the plain version; operands on two devices,
    and build or launch errors, raise."""
    dev = one_device("micro_flat_kernel.run", cand=cand, od=od,
                     blocks=blocks)
    if dev.type == "cpu":
        return flat_reference(cand, od, blocks)
    if dev.type != "cuda":
        raise ValueError(f"micro_flat_kernel.run: no kernel for {dev}")
    g, n_c = od.shape[0], blocks.shape[0]
    kernels.check_tensor("cand", cand, torch.int32, (g, 1, 1 + KSLOTS), dev)
    kernels.check_tensor("od", od, torch.float32, (g, 6, FLAT), dev)
    kernels.check_tensor("blocks", blocks, torch.float32,
                         (n_c, BLOCK_ROWS, 4 * CT), dev)
    t = torch.empty((g, 8, 128), dtype=torch.float32, device=dev)
    prim = torch.empty_like(t)
    with torch.cuda.device(dev):
        kernels.PROBE_FLAT.launch(
            "rtxpt_probe_flat", cand.data_ptr(), od.data_ptr(),
            blocks.data_ptr(), t.data_ptr(), prim.data_ptr(), g,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.launches["probe_flat"] += 1
    return t, prim


def local_tris(arrays):
    """The triangles as the probe intersects them (float64): each cluster's
    shifted by minus its center. The blocks hold coefficients of v0 - center
    while the ray operand is built from the world origin (the script's
    :94, :60-70), so the probe's hits are those of these triangles, not of
    the world triangles its brute-force check uses (ROADMAP F15)."""
    return (arrays["tris"].astype(np.float64)
            - arrays["centers"].astype(np.float64)[:, None, None, :])


def aimed_rays(arrays, seed=1):
    """od [G, 6, 1024] f32 of rays aimed at the triangles the probe
    intersects (`local_tris`): lane l of group g starts 1 to 10 units
    before a point (barycentrics u, v in [0.1, 0.4]) of a random triangle
    of its group's candidate slot l % 16, so nearly every lane hits (often
    an earlier triangle of the dense clusters)."""
    rng = np.random.default_rng(seed)
    loc = local_tris(arrays)
    od = arrays["od"].astype(np.float64)
    slot = np.arange(FLAT) % KSLOTS
    for g in range(od.shape[0]):
        tri = loc[arrays["cand"][g, 0, 1 + slot],
                  rng.integers(0, CT, FLAT)]                  # [L, 3, 3]
        u, v = rng.uniform(0.1, 0.4, (2, FLAT, 1))
        p = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2]
                                                           - tri[:, 0])
        d = rng.standard_normal((FLAT, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        od[g, 0:3] = (p - rng.uniform(1, 10, (FLAT, 1)) * d).T
        od[g, 3:6] = d.T
    return od.astype(np.float32)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _pairs(cand, od, tris, g, lanes):
    """(u, v, t, |det|, |e1 x e2|) in float64, [L, T], of lanes `lanes`
    of group g against its candidate clusters' triangles `tris`."""
    tri = tris[cand[g, 0, 1:]].astype(np.float64).reshape(-1, 3, 3)
    v0 = tri[:, 0].T[:, None, :]                      # [3, 1, T]
    e1 = tri[:, 1].T[:, None, :] - v0
    e2 = tri[:, 2].T[:, None, :] - v0
    o = od[g, 0:3][:, lanes].astype(np.float64)[:, :, None]   # [3, L, 1]
    d = od[g, 3:6][:, lanes].astype(np.float64)[:, :, None]
    pv = _cross(d, e2)
    det = _dot(e1, pv)
    safe = np.where(np.abs(det) >= 1e-12, det, 1.0)
    tv = o - v0
    qv = _cross(tv, e1)
    return (_dot(tv, pv) / safe, _dot(d, qv) / safe, _dot(e2, qv) / safe,
            np.abs(det), np.sqrt(_dot(*(_cross(e1, e2),) * 2)))


def _nearest(pairs, margins, min_cos=0.0):
    """The nearest t > 0 per lane ([L], inf for none) among `pairs` whose
    u, v >= -m and u + v <= 1 + s (`margins` (m, s)) and whose plane the
    ray meets at |cos| >= min_cos to the normal."""
    u, v, t, absd, nrm = pairs
    m, s = margins
    ok = ((absd >= np.maximum(1e-12, min_cos * nrm)) & (u >= -m) & (v >= -m)
          & (u + v <= 1 + s) & (t > 0))
    return np.where(ok, t, np.inf).min(1)


def brute_force(cand, od, tris, groups=2, lane_step=LANE_STEP,
                margins=SCRIPT_MARGINS):
    """The script's check (micro_flat_kernel.py:236-257) in float64, over
    all candidate triangles at once: (g, lane, t) of each lane (every
    `lane_step`-th) of the first `groups` groups that hits one of `tris`
    [C, 128, 3, 3] (the nearest t > 0; `margins` (m, s): u, v >= -m and
    u + v <= 1 + s, the script's 1e-3 or the kernel's KERNEL_MARGINS)."""
    hits = []
    lanes = np.arange(0, FLAT, lane_step)
    for g in range(min(groups, od.shape[0])):
        best = _nearest(_pairs(cand, od, tris, g, lanes), margins)
        hits += [(g, int(lane), float(bt)) for lane, bt in zip(lanes, best)
                 if bt < np.inf]
    return hits


def check(t_out, hits):
    """The brute-force hits (g, lane, t) that t_out [G, 8, 128] misses or
    places farther than TOL_T * max(1, t) away: (g, lane, t_out, t)."""
    bad = []
    for g, lane, bt in hits:
        kt = float(t_out[g, lane // 128, lane % 128])
        if abs(kt - bt) > TOL_T * max(1.0, bt):
            bad.append((g, lane, kt, bt))
    return bad


def _within(kt, t):
    """kt within TOL_T x max(1, t) of a finite t."""
    return (t < np.inf) & (np.abs(kt - t) <= TOL_T * np.maximum(1.0, t))


def aimed_check(t_out, arrays, od):
    """(hits, bad) of rays `od` (`aimed_rays`) against the triangles the
    probe intersects, every lane of groups 0-1 in float64: the brute force
    selects with the kernel's margins made MARGIN_SLACK narrower (and
    without the GRAZING triangles) and wider, and a lane passes when t_out
    matches either within TOL_T x max(1, t) (or misses where the narrower
    finds nothing), so a hit at the very edge of a margin, or on a plane
    the ray grazes, may go either way. hits: the wider brute force's."""
    loc = local_tris(arrays)
    (m, s), e = KERNEL_MARGINS, MARGIN_SLACK
    lanes = np.arange(FLAT)
    hits, bad = 0, []
    for g in range(min(2, od.shape[0])):
        pairs = _pairs(arrays["cand"], od, loc, g, lanes)
        narrow = _nearest(pairs, (m - e, s - 2 * e), GRAZING)
        wide = _nearest(pairs, (m + e, s + 2 * e))
        kt = t_out[g].reshape(FLAT).astype(np.float64)
        with np.errstate(invalid="ignore"):
            ok = (_within(kt, narrow) | _within(kt, wide)
                  | ((narrow == np.inf) & (kt >= BIG)))
        hits += int((wide < np.inf).sum())
        bad += [(g, int(lane), float(kt[lane]), float(wide[lane]))
                for lane in np.nonzero(~ok & (wide < np.inf))[0]]
    return hits, bad


def _to(arrays, dev):
    return {k: torch.from_numpy(arrays[k]).to(dev)
            for k in ("cand", "od", "blocks")}


def main(argv=None) -> int:
    import rtxpt_tpu_torch

    ap = argparse.ArgumentParser(description="K11, the flat-lane probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, default) or cpu (the plain "
                    "version)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = rtxpt_tpu_torch.device(args.device)
    groups = GROUPS if dev.type == "cuda" else 2      # the script's sizes
    arrays = inputs(args.seed, groups)
    ops = _to(arrays, dev)
    t_out, _ = run(**ops)
    t_host = t_out.cpu().numpy()
    cand, od = arrays["cand"], arrays["od"]
    # the script's check: world triangles, every 73rd lane of groups 0, 1
    bad = check(t_host, brute_force(cand, od, arrays["tris"]))
    for g, lane, kt, bt in bad:
        print(f"MISMATCH g={g} lane={lane}: {kt} vs {bt}")
    print("correctness:", "FAIL" if bad else "OK", flush=True)
    # the triangles the probe intersects, every lane of groups 0, 1
    hits = brute_force(cand, od, local_tris(arrays), lane_step=1)
    bad_local = check(t_host, hits)
    print(f"cluster-local check: {len(hits)} brute-force hits on the "
          f"{2 * FLAT} lanes of groups 0-1, {len(bad_local)} not matched "
          f"within {TOL_T} x max(1, t); the probe hits "
          f"{int((t_host[:2] < BIG).sum())}: "
          f"{'FAIL' if bad_local else 'OK'}", flush=True)
    # rays aimed at those triangles, every lane of groups 0, 1, against
    # the kernel's own margins
    od_aim = aimed_rays(arrays, args.seed + 1)
    t_aim = run(ops["cand"], torch.from_numpy(od_aim).to(dev),
                ops["blocks"])[0].cpu().numpy()
    n_aim, bad_aim = aimed_check(t_aim, arrays, od_aim)
    print(f"aimed check: {n_aim} brute-force hits on the {2 * FLAT} "
          f"aimed lanes of groups 0-1, {len(bad_aim)} not matched; the "
          f"probe hits {int((t_aim[:2] < BIG).sum())}: "
          f"{'FAIL' if bad_aim else 'OK'}", flush=True)
    if bad or bad_local or bad_aim:
        return 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(REPS):
            t_out, _ = run(**ops)
        torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / REPS
        per_visit = dt / (groups * KSLOTS)
        print(f"{dt*1e3:.3f} ms for {groups} groups x {KSLOTS} visits "
              f"({per_visit*1e9:.0f} ns/visit, all 1024 rays)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K6's and K7's tensor-core form (csrc/cluster_rows.cu) on the CPU.

K6 (per-row closest hit and shading) and K7 (per-row shadow any-hit) take
K3's and K5's form (csrc/cluster_mma.cuh): each visit's det, u and v
numerators as the stacked split-bf16 matrix product of the per-row operand
(`make_operand_rows`, o x d of the shifted origin), K3's screen on them
(edge margins widened 4x, any t), and the screened pairs resolved with the
plain version's f32 sums: K6 through the selection with t = t_num / |det|
(`consider<true>`), K7 through the strict test in triangle order. The
walks keep the plain row gates: K6 votes each warp's largest committed t
bits, a row is done once its maximum falls below a slot's hull entry, and
it visits a slot whose entry bits are at most its maximum; K7 skips a warp
whose row's entry is +inf or whose lanes are all occluded.

The cases are the small city's per-row lists at bounces 0 and 1 of 2,048
camera rays (two groups), sorted and culled as the per-row route does, and
the shadow requests of bounce 0. Models of both kernels' walks in torch
give `closest_shade_reference`'s winners and row visits and
`occlusion_rows_reference`'s occ and test counts bit for bit. The product
and screen checks are the "k6-" and "k7-" cases of the parametrised tests
of tests/test_torch_k3_product.py, which take their slots from
`row_slots` and `shadow_row_slots`. No JAX: the plain K6 and K7 are held
to the JAX kernels in tests/test_torch_cluster_rows.py."""

import functools

import pytest
import torch

from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP

COLS, ROWS = 64, 32      # 2,048 camera rays: two groups
LIST = 8                 # screened candidates a thread keeps per ray
SCREEN = 4 * BC.MARGIN   # K3's screen margin, of |det|
INF_BITS = 0x7F800000
THREAD = (torch.arange(BC.CT) >> 1) & 3   # the quad thread of triangle j


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def row_case():
    """(tables, cfg, kslots, [(cand, fs, is_, plain walk)] at bounces 0
    and 1, (cand_s, shp, plain occlusion) of bounce 0's requests): the
    small city from above (shadowed ground), the per-row route's sort and
    cull, `closest_shade_reference` carrying the state."""
    host = TP.city_scene(tri_budget=4000, seed=1, blocks=2)
    host.camera = dict(position=[10.0, 30.0, 10.5], target=[10.0, 0.0, 10.0],
                       up=[0, 1, 0], fov_y_deg=45.0)
    tbl = prepare(host, device="cpu").cluster_tables
    cfg = PathTracerConfig(max_bounces=2)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    kslots = min(BC.DEFAULT_KSLOTS, tbl.n_clusters)
    mt = float(cfg.max_ray_travel)
    bounds = BC.scene_bounds(tbl)
    cam = TP.default_camera(host, COLS, ROWS)
    px, py = _pixel_grid(COLS, ROWS, "cpu")
    fs, is_ = bf.initial_state(*camera_rays(cam, cfg, px, py, 1), px, py)
    src = torch.arange(fs.shape[1], dtype=torch.int32)
    walks, shadow = [], None
    for b in range(2):
        fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0, bounds)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, mt, tbl, kslots)
        plain = BC._closest_rows(cand, fs, is_, tbl.blocks, kslots, mt)
        walks.append((cand, fs, is_, plain))
        fs, is_, sh, _ = BC.closest_shade_reference(cand, fs, is_, tbl, kcfg,
                                                    1, kslots, mt)
        if b == 0:
            shp, _ = BC.sort_shadows(sh, bounds)
            dop = shp[BC.SH_DO] > 0.5
            cand_s, _ = BC.cull(shp[BC.SH_O:BC.SH_O + 3],
                                shp[BC.SH_D:BC.SH_D + 3], dop,
                                torch.where(dop, shp[BC.SH_DIST], -3e38), tbl,
                                kslots)
            shadow = (cand_s, shp, BC.occlusion_rows_reference(
                cand_s, shp, tbl.blocks, kslots, stats=True))
    return tbl, cfg, kslots, walks, shadow


def _slot_rows(tbl, cand, o, d, i, rows):
    """Slot i's blocks and per-row operand (hi, lo; 10 rows of [p, 128])
    for the 128-lane rows `rows` [p]; o, d [3, G * R, 128]."""
    blk = tbl.blocks[cand[rows // BC.R, 0, 1 + i].long()]
    return (*BC._operand_rows(d[:, rows], o[:, rows], *BC._center(blk)),
            blk)


def _rays(x, o_row, d_row):
    """Origins and directions [3, G * R, 128] of rows o_row, d_row of x."""
    o = x[o_row:o_row + 3].reshape(3, -1, 128)
    d = x[d_row:d_row + 3].reshape(3, -1, 128)
    return o, d


@functools.lru_cache(maxsize=None)
def row_slots(bounce):
    """[(hi, lo, blocks)] of every (row, slot) that K6's plain walk visits
    at `bounce`, one entry per slot (its visiting rows as the batch). The
    operand is zero on lanes where it is not finite (terminated lanes'
    rays past bounce 0): the kernel's NaN products there pass no screen,
    and the plain selection finds no valid candidate."""
    tbl, _, kslots, walks, _ = row_case()
    cand, fs, _, plain = walks[bounce]
    visited = plain[3]
    o, d = _rays(fs, bf.FS_O, bf.FS_D)
    out = []
    for i in range(kslots):
        rows = visited[:, i].nonzero()[:, 0]
        if rows.numel():
            hi, lo, blk = _slot_rows(tbl, cand, o, d, i, rows)
            keep = torch.stack([torch.isfinite(x) for x in hi + lo]).all(0)
            hi = [torch.where(keep, h, 0.0) for h in hi]
            lo = [torch.where(keep, r, 0.0) for r in lo]
            out.append((hi, lo, blk))
    assert len(out) >= 4, bounce
    return out


@functools.lru_cache(maxsize=None)
def shadow_row_slots():
    """[(hi, lo, blocks, dist, requested)] of every slot K7 may visit: the
    rows whose entry bits are below +inf, in groups whose list holds the
    slot (a superset of its walk's). The operand is zero on lanes without
    a request, as the kernel's A row of an occluded lane."""
    tbl, _, kslots, _, (cand_s, shp, _) = row_case()
    o, d = _rays(shp, BC.SH_O, BC.SH_D)
    req = (shp[BC.SH_DO] > 0.5).reshape(-1, 128)
    dist = (shp[BC.SH_DIST] * (1.0 - BC.SHADOW_T_EPS)).reshape(-1, 128)
    te = BC._row_entries(cand_s, kslots)
    out = []
    for i in range(kslots):
        on = (te[:, i] < INF_BITS) & (cand_s[:, 0, :1] > i)
        rows = on.reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        hi, lo, blk = _slot_rows(tbl, cand_s, o, d, i, rows)
        keep = req[rows]
        hi = [torch.where(keep, h, 0.0) for h in hi]
        lo = [torch.where(keep, r, 0.0) for r in lo]
        out.append((hi, lo, blk, dist[rows], keep))
    assert len(out) >= 4
    return out


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def tensor_core_quantities(hi, lo, blk):
    """(det, u_num, v_num) [p, CT, 128] as the stacked split-bf16 products
    summed in float64 and rounded to f32: a model of the tensor cores' f32
    accumulation of the same exact products."""
    cols = []
    for h, r in zip(hi, lo):
        l1 = _bf16(r)
        cols += [h, l1, r - l1, h]
    a = torch.stack(cols, -1).double()                     # [p, 128, 40]
    out = []
    for qn, rows in enumerate(BC.Q_ROWS[:3]):
        lanes = slice(qn * BC.CT, (qn + 1) * BC.CT)
        b = blk.new_zeros(blk.shape[0], 40, BC.CT)
        for c in rows:
            for st in range(4):
                b[:, 4 * c + st] = blk[:, c + (10 if st == 3 else 0), lanes]
        out.append(torch.einsum("pfk,pkt->ptf", a, b.double()).float())
    return out


def k3_screen(det, un, vn):
    """csrc/cluster_mma.cuh `screen`: inside the edge margins widened 4x,
    any t; |det| > 0."""
    absd, su, sv, _ = BC._signed(det, un, vn, torch.zeros_like(det))
    w = SCREEN * absd
    return (absd > 0) & (su >= -w) & (sv >= -w) & (su + sv <= absd + w + w)


def listed(passed):
    """The candidates each thread resolves: its screened ones, or all 32
    of its triangles when more than LIST passed for the ray (the list's
    overflow rule). passed [p, CT, 128] -> (listed, overflowed [p, 4,
    128])."""
    per_thread = torch.stack([passed[:, THREAD == q].sum(1)
                              for q in range(4)], 1)
    over = per_thread > LIST
    return passed | over[:, THREAD], over


@functools.lru_cache(maxsize=None)
def k6_model(bounce):
    """K6's walk in torch at `bounce`: per slot each warp's largest
    committed t bits of its active lanes (0 for inactive ones), the row
    maxima of its 4 warps, a row done for good once its maximum is below
    the slot's hull entry, a row visiting the slot while its entry bits
    are at most its maximum; a visiting row's det, u, v on the tensor
    cores (`tensor_core_quantities`), K3's screen, the lists with their
    overflow rule, the listed candidates through the plain selection
    with t = t_num / |det| (the least t, the lowest triangle on ties: the
    threads' scans in increasing j and the quad reduction), and the
    slot's winner kept where its t is below the committed one. Returns
    (best_t, best_c, best_j [G, FL], visited [G * R, kslots], counts)."""
    tbl, cfg, kslots, walks, _ = row_case()
    cand, fs, is_, _ = walks[bounce]
    mt = float(cfg.max_ray_travel)
    G = cand.shape[0]
    o, d = _rays(fs, bf.FS_O, bf.FS_D)
    act = (is_[bf.IS_ACTIVE] > 0).reshape(G * BC.R, 128)
    te = BC._row_entries(cand, kslots).reshape(G, kslots, BC.R)
    best_t = torch.full((G * BC.R, 128), BC._BIG)
    best_c = torch.zeros((G * BC.R, 128), dtype=torch.int64)
    best_j = torch.zeros((G * BC.R, 128), dtype=torch.int64)
    alive = torch.ones((G, BC.R), dtype=torch.bool)
    visited = torch.zeros((G, BC.R, kslots), dtype=torch.bool)
    counts = dict(pairs=0, passed=0, overflowed=0)
    for i in range(kslots):
        bits = torch.where(act, best_t, 0.0).view(torch.int32)
        warp = bits.view(G * BC.R, 4, 32).amax(2)             # the votes
        bound = warp.amax(1).view(G, BC.R)
        alive &= (i < cand[:, 0, :1]) & (bound >= cand[:, 0, 1 + kslots + i,
                                                        None])
        vis = alive & (te[:, i] <= bound)
        visited[:, :, i] = vis
        rows = vis.reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        hi, lo, blk = _slot_rows(tbl, cand, o, d, i, rows)
        passed = k3_screen(*tensor_core_quantities(hi, lo, blk))
        take, over = listed(passed)
        absd, su, sv, st = BC._signed(*BC._quantities(blk, hi, lo))
        valid, tt = BC._select(absd, su, sv, st, mt, divide=True)
        t_c, j_c = BC._closest_in_block(valid & take, tt)
        improved = t_c < best_t[rows]
        cid = cand[rows // BC.R, 0, 1 + i].long()
        best_t[rows] = torch.where(improved, t_c, best_t[rows])
        best_c[rows] = torch.where(improved, cid[:, None], best_c[rows])
        best_j[rows] = torch.where(improved, j_c, best_j[rows])
        counts["pairs"] += rows.numel() * 128 * BC.CT
        counts["passed"] += int(passed.sum())
        counts["overflowed"] += int(over.sum())
    return (best_t.view(G, BC.FL), best_c.view(G, BC.FL),
            best_j.view(G, BC.FL), visited.reshape(G * BC.R, kslots), counts)


@functools.lru_cache(maxsize=None)
def k7_model():
    """K7's walk in torch: lanes without a request start occluded; per
    slot the group runs while a lane is unoccluded (the block vote); a
    warp takes the slot when its row's entry bits are below +inf and one
    of its lanes is unoccluded; its unoccluded lanes' A rows (zero rows
    for the others), the tensor cores' det, u, v, K3's screen, the lists
    with their overflow rule, the plain strict test on the listed pairs,
    the least occluding j of the lane, and j + 1 (or CT) tested pairs on
    its unoccluded lanes. Returns (occ [N], tests [G], counts)."""
    tbl, _, kslots, _, (cand_s, shp, _) = row_case()
    G = cand_s.shape[0]
    o, d = _rays(shp, BC.SH_O, BC.SH_D)
    occ = ~(shp[BC.SH_DO] > 0.5).reshape(G * BC.R, 128)
    dist = (shp[BC.SH_DIST] * (1.0 - BC.SHADOW_T_EPS)).reshape(-1, 128)
    te = BC._row_entries(cand_s, kslots)
    tests = torch.zeros((G * BC.R,), dtype=torch.int32)
    counts = dict(pairs=0, passed=0, overflowed=0)
    for i in range(kslots):
        running = (cand_s[:, 0, 0] > i) & (~occ).view(G, -1).any(1)
        if not bool(running.any()):
            break
        warp_live = (~occ).view(G * BC.R, 4, 32).any(2)
        on = (running[:, None] & (te[:, i] < INF_BITS)).reshape(-1, 1) \
            & warp_live                                       # [G*R, 4]
        rows = on.any(1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        lane_on = on[rows].repeat_interleave(32, 1) & ~occ[rows]
        hi, lo, blk = _slot_rows(tbl, cand_s, o, d, i, rows)
        hi = [torch.where(lane_on, h, 0.0) for h in hi]
        lo = [torch.where(lane_on, r, 0.0) for r in lo]
        passed = k3_screen(*tensor_core_quantities(hi, lo, blk))
        passed &= on[rows].repeat_interleave(32, 1)[:, None]
        take, over = listed(passed)
        absd, su, sv, st = BC._signed(*BC._quantities(blk, hi, lo))
        exact = take & BC._strict_hit(absd, su, sv, st, dist[rows][:, None])
        found = exact.any(1)
        first = torch.where(found, exact.to(torch.int32).argmax(1), BC.CT)
        tested = torch.where(found, first + 1, BC.CT)
        tests[rows] += torch.where(lane_on, tested, 0).sum(
            1, dtype=torch.int32)
        occ[rows] |= found & lane_on
        counts["pairs"] += int(lane_on.sum()) * BC.CT
        counts["passed"] += int(passed.sum())
        counts["overflowed"] += int(over.sum())
    return (occ.reshape(-1).to(torch.float32),
            tests.view(G, BC.R).sum(1, dtype=torch.int32), counts)


@pytest.mark.parametrize("bounce", [0, 1])
def test_k6_walk_model_matches_closest_shade_reference(bounce, capsys):
    """The model of K6's walk gives the plain per-row walk's committed t,
    winning cluster and triangle on every lane and its row visits, bit for
    bit, so the refit and the shading that follow read the same winners;
    the screen passes few pairs (printed with -s for PERF.md)."""
    best_t, best_c, best_j, visited, counts = k6_model(bounce)
    _, _, _, walks, _ = row_case()
    p_t, p_c, p_j, p_vis = walks[bounce][3]
    assert torch.equal(best_t.view(torch.int32), p_t.view(torch.int32))
    assert torch.equal(best_c, p_c) and torch.equal(best_j, p_j)
    assert torch.equal(visited, p_vis)
    hits = int((p_t < BC._BIG).sum())
    assert hits >= (500 if bounce == 0 else 100) and int(p_vis.sum()) >= 20, (
        hits, int(p_vis.sum()))
    share = counts["passed"] / counts["pairs"]
    with capsys.disabled():
        print(f"\nK6 screen bounce {bounce}: {counts['passed']} of "
              f"{counts['pairs']} pairs pass ({share:.5%}), "
              f"{counts['overflowed']} lists overflow; {int(p_vis.sum())} "
              f"row visits, {hits} lanes hit")
    assert 0 < share < 0.01


def test_k7_walk_model_matches_occlusion_rows_reference(capsys):
    """The model of K7's walk gives occlusion_rows_reference's occ and
    per-group test counts bit for bit, with lanes occluded and lanes
    walking whole slots; the screen passes few pairs (printed)."""
    occ_m, tests_m, counts = k7_model()
    _, _, _, _, (_, shp, (occ_p, tests_p)) = row_case()
    assert torch.equal(occ_m, occ_p)
    assert torch.equal(tests_m, tests_p)
    req = shp[BC.SH_DO] > 0.5
    assert int(req.sum()) >= 300
    assert int((occ_p[req] > 0.5).sum()) >= 40
    assert int((occ_p[req] < 0.5).sum()) >= 100
    share = counts["passed"] / counts["pairs"]
    with capsys.disabled():
        print(f"\nK7 screen: {counts['passed']} of {counts['pairs']} pairs "
              f"pass ({share:.5%}), {counts['overflowed']} lists overflow; "
              f"{int(req.sum())} requests, {int(tests_p.sum())} pairs "
              f"tested")
    assert 0 < share < 0.01 and counts["pairs"] >= int(tests_p.sum())

"""K5's tensor-core form (csrc/cluster_shadow.cu) on the CPU.

K5 takes each visit's det, u and v numerators as K3's stacked split-bf16
matrix product (csrc/cluster_mma.cuh), screens the pairs on them with K3's
screen (edge margins widened 4x, any t) and resolves the pairs that pass
with the plain version's f32 sums and strict test, in triangle order. The
cases here are the shadow requests that `shade_reference` emits on
`closest_hit_reference`'s bounce-0 hits of 1,024 camera rays, sorted and
culled as the clustered tier does, on the small city (flat), the instanced
city (object-frame operands) and the 40 x 40 curtain (micromaps). The
product and screen checks shared with K3 are cases of the parametrised
tests of tests/test_torch_k3_product.py, which take their K5 slots from
`shadow_slots`; this file holds a model of the kernel's resolve against
`occlusion_reference` and the screen's pass share. No JAX: the plain K5 is
held to the JAX kernel in tests/test_torch_cluster.py,
tests/test_torch_instancing.py and tests/test_torch_omm_kernels.py."""

import functools

import pytest
import torch

from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP

SIDE = 32                # 1,024 camera rays: one group
LIST = 8                 # screened candidates a thread keeps per ray
SCREEN = 4 * BC.MARGIN   # K3's screen margin, of |det|
CASES = ("city", "instanced", "curtain")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _look(host, position, target):
    host.camera = dict(position=position, target=target, up=[0, 1, 0],
                       fov_y_deg=45.0)
    return host


def _host(name):
    """The case's scene, with a camera that sees shadowed ground (the
    small city from above, the instanced city from behind its towers)."""
    if name == "city":
        return _look(TP.city_scene(tri_budget=4000, seed=1, blocks=2),
                     [10.0, 30.0, 10.5], [10.0, 0.0, 10.0])
    if name == "instanced":
        return _look(TP.instanced_city(grid=2, subdiv=6), [0.0, 2.5, -5.0],
                     [-0.8, 0.0, -1.6])
    return TP.curtain_cornell(True, grid=40)


@functools.lru_cache(maxsize=None)
def shadow_case(name):
    """(tables, cand, shp, kslots, omm): the sorted shadow rows of the
    case's bounce-0 requests and their candidate rows (pool block ids and
    instances on instanced tables), as trace_paths_clustered builds them
    for K5."""
    host = _host(name)
    omm = name == "curtain"
    tbl = prepare(host, device="cpu").cluster_tables
    cfg = PathTracerConfig(max_bounces=2, stochastic_texture_filtering=omm)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    kslots = min(BC.DEFAULT_KSLOTS, tbl.n_clusters)
    bounds = BC.scene_bounds(tbl)
    cam = TP.default_camera(host, SIDE, SIDE)
    px, py = _pixel_grid(SIDE, SIDE, "cpu")
    fs, is_ = bf.initial_state(*camera_rays(cam, cfg, px, py, 1), px, py)
    src = torch.arange(fs.shape[1], dtype=torch.int32)
    fs, is_, _ = BC.sort_wavefront(fs, is_, src, True, bounds)
    cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                      is_[bf.IS_ACTIVE] > 0, cfg.max_ray_travel, tbl, kslots)
    ha = BC.closest_hit_reference(
        BC.map_cand_inst(cand, tbl, kslots), BC.ray_operand(fs, is_),
        tbl.blocks, kslots, cfg.max_ray_travel, xf=tbl.xf,
        micro=tbl.omm_word if omm else None)
    sh = BC.shade_reference(BC.post_attr_inst(ha, tbl), fs, is_, tbl, kcfg,
                            1, omm=omm)[2]
    shp, _ = BC.sort_shadows(sh, bounds)
    dop = shp[BC.SH_DO] > 0.5
    cand_s, _ = BC.cull(shp[BC.SH_O:BC.SH_O + 3], shp[BC.SH_D:BC.SH_D + 3],
                        dop, torch.where(dop, shp[BC.SH_DIST], -3e38), tbl,
                        kslots)
    return tbl, BC.map_cand_inst(cand_s, tbl, kslots), shp, kslots, omm


def _slot_operand(tbl, cand, rays, kslots, i, gs):
    """The split-bf16 operand (hi, lo) and blocks of slot i of groups gs,
    in each slot's instance frame on instanced tables."""
    cid = cand[gs, 0, 1 + i].long()
    blk = tbl.blocks[cid]
    ray = tuple(x[:, gs] for x in rays)
    if tbl.instanced:
        iid = cand[gs, 0, BC.inst_base(kslots) + i].long()
        ray = BC.object_operand(tbl.xf[iid][:, None], *ray)
    return (*BC._operand(*ray, *BC._center(blk)), blk, cid)


def _shadow_rays(shp, groups):
    shg = shp.view(BC.SH_ROWS, groups, BC.FL)
    o, d = shg[BC.SH_O:BC.SH_O + 3], shg[BC.SH_D:BC.SH_D + 3]
    return (d, BC.W.cross3(o, d), o), shg


@functools.lru_cache(maxsize=None)
def shadow_slots(name):
    """[(hi, lo, blocks, dist, requested)] of every candidate slot of
    every group of the case (a superset of the slots a walk visits). The
    operand is zero on lanes without a request, as the kernel's A row of
    an occluded lane; dist is SH_DIST * (1 - SHADOW_T_EPS)."""
    tbl, cand, shp, kslots, _ = shadow_case(name)
    rays, shg = _shadow_rays(shp, cand.shape[0])
    req = shg[BC.SH_DO] > 0.5
    dist = shg[BC.SH_DIST] * (1.0 - BC.SHADOW_T_EPS)
    out = []
    for i in range(kslots):
        gs = (cand[:, 0, 0] > i).nonzero()[:, 0]
        if gs.numel() == 0:
            break
        hi, lo, blk, _ = _slot_operand(tbl, cand, rays, kslots, i, gs)
        keep = req[gs]
        hi = [torch.where(keep, h, 0.0) for h in hi]
        lo = [torch.where(keep, r, 0.0) for r in lo]
        out.append((hi, lo, blk, dist[gs], keep))
    assert len(out) >= 8, name
    return out


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def tensor_core_quantities(hi, lo, blk):
    """(det, u_num, v_num, t_num) [g, CT, FL] as the stacked split-bf16
    products summed in float64 and rounded to f32: a model of the tensor
    cores' f32 accumulation of the same exact products (the t numerators
    too, which the kernel does not take)."""
    cols = []
    for h, r in zip(hi, lo):
        l1 = _bf16(r)
        cols += [h, l1, r - l1, h]
    a = torch.stack(cols, -1).double()                     # [g, FL, 40]
    out = []
    for qn, rows in enumerate(BC.Q_ROWS):
        lanes = slice(qn * BC.CT, (qn + 1) * BC.CT)
        b = blk.new_zeros(blk.shape[0], 40, BC.CT)
        for c in rows:
            for st in range(4):
                b[:, 4 * c + st] = blk[:, c + (10 if st == 3 else 0), lanes]
        out.append(torch.einsum("gfk,gkt->gtf", a, b.double()).float())
    return out


def k3_screen(det, un, vn):
    """csrc/cluster_mma.cuh `screen`: inside the edge margins widened 4x,
    any t; |det| > 0."""
    absd, su, sv, _ = BC._signed(det, un, vn, torch.zeros_like(det))
    w = SCREEN * absd
    return (absd > 0) & (su >= -w) & (sv >= -w) & (su + sv <= absd + w + w)


def t_screen(det, un, vn, tn, dist):
    """The screen with the t numerator added: K3's, and t inside
    (0, dist) widened by the same relative margin."""
    absd, _, _, st = BC._signed(det, un, vn, tn)
    w = SCREEN * absd * dist
    return k3_screen(det, un, vn) & (st > -w) & (st < dist * absd + w)


@functools.lru_cache(maxsize=None)
def resolve_model(name, with_t=False):
    """The kernel's walk in torch: per slot, groups with an unoccluded lane
    (the block vote) and, within them, warps with one; each live lane's A
    row (a zero row for an occluded lane), the tensor cores' det, u, v
    (`tensor_core_quantities`), the screen, each thread's list of the
    triangles it screened in (thread q of a quad holds triangles j with
    (j >> 1) & 3 == q; past LIST entries the thread takes all 32 of its
    triangles), the exact recompute and plain test of the listed pairs
    (micromap rules included), the least occluding j of the lane, and
    j + 1 (or CT) tested pairs on lanes unoccluded before the slot.
    Returns (occ [N], tests [G], dict(pairs, passed, overflowed))."""
    tbl, cand, shp, kslots, omm = shadow_case(name)
    G = cand.shape[0]
    rays, shg = _shadow_rays(shp, G)
    dist = shg[BC.SH_DIST] * (1.0 - BC.SHADOW_T_EPS)
    ua = shg[BC.SH_UA]
    occ = ~(shg[BC.SH_DO] > 0.5)
    tests = torch.zeros((G,), dtype=torch.int32)
    counts = dict(pairs=0, passed=0, overflowed=0)
    thread = (torch.arange(BC.CT) >> 1) & 3
    for i in range(kslots):
        gs = ((cand[:, 0, 0] > i) & (~occ).any(1)).nonzero()[:, 0]
        if gs.numel() == 0:
            break
        live = ~occ[gs]                                     # [g, FL]
        warp_live = live.view(-1, BC.FL // 32, 32).any(2)
        hi, lo, blk, cid = _slot_operand(tbl, cand, rays, kslots, i, gs)
        hi = [torch.where(live, h, 0.0) for h in hi]
        lo = [torch.where(live, r, 0.0) for r in lo]
        tc = tensor_core_quantities(hi, lo, blk)
        dd = dist[gs][:, None]
        passed = t_screen(*tc, dd) if with_t else k3_screen(*tc[:3])
        passed &= warp_live.repeat_interleave(32, 1)[:, None]
        per_thread = torch.stack([passed[:, thread == q].sum(1)
                                  for q in range(4)], 1)    # [g, 4, FL]
        over = per_thread > LIST
        listed = passed | over[:, thread]
        absd, su, sv, st = BC._signed(*BC._quantities(blk, hi, lo))
        exact = listed & BC._strict_hit(absd, su, sv, st, dd)
        if omm:
            state, near = BC._candidate_states(exact, tbl.omm_word, cid, su,
                                               sv, absd)
            unk = (state == bf.MICRO_UNKNOWN) | near
            exact &= ((state != bf.MICRO_TRANSPARENT) | near) & (
                ~unk | (ua[gs][:, None] < tbl.omm_cov[cid][:, :, None]))
        found = exact.any(1)
        first = torch.where(found, exact.to(torch.int32).argmax(1), BC.CT)
        tested = torch.where(found, first + 1, BC.CT)
        tests[gs] += torch.where(live, tested, 0).sum(1, dtype=torch.int32)
        occ[gs] = occ[gs] | found
        counts["pairs"] += int(live.sum()) * BC.CT
        counts["passed"] += int(passed.sum())
        counts["overflowed"] += int(over.sum())
    return occ.reshape(-1).to(torch.float32), tests, counts


@functools.lru_cache(maxsize=None)
def _reference(name):
    tbl, cand, shp, kslots, omm = shadow_case(name)
    return BC.occlusion_reference(
        cand, shp, tbl.blocks, kslots, stats=True, xf=tbl.xf,
        micro=tbl.omm_word if omm else None,
        cover=tbl.omm_cov if omm else None)


@pytest.mark.parametrize("name", CASES)
def test_resolve_model_matches_occlusion_reference(name):
    """The model of the kernel's walk (K3's screen on the tensor cores'
    sums, the lists and their overflow rule, the exact resolve in triangle
    order, the quad's least occluder, the test counts, the skipped
    all-occluded warps) gives occlusion_reference's occ and per-group test
    counts bit for bit, with lanes occluded and lanes walking whole
    slots."""
    occ_m, tests_m, counts = resolve_model(name)
    occ_p, tests_p = _reference(name)
    assert torch.equal(occ_m, occ_p)
    assert torch.equal(tests_m, tests_p)
    _, _, shp, _, _ = shadow_case(name)
    req = shp[BC.SH_DO] > 0.5
    assert int(req.sum()) >= 300
    assert int((occ_p[req] > 0.5).sum()) >= 40
    assert int((occ_p[req] < 0.5).sum()) >= 100
    assert counts["passed"] > 0 and counts["pairs"] >= int(tests_p.sum())


@pytest.mark.parametrize("name", CASES)
def test_screen_pass_share_with_and_without_t(name, capsys):
    """The share of the screened pairs (128 per unoccluded lane and
    visit) that pass K3's screen, which the kernel keeps, and with the t
    numerator added to it: both stay far under 1%, so the kernel's exact
    pass is rare work; the t screen takes little off (its product would
    cost one more k-step per chunk). Printed for PERF.md (pytest -s)."""
    _, _, no_t = resolve_model(name)
    occ_t, tests_t, with_t = resolve_model(name, with_t=True)
    share = no_t["passed"] / no_t["pairs"]
    share_t = with_t["passed"] / with_t["pairs"]
    with capsys.disabled():
        print(f"\nK5 screen {name}: {no_t['passed']} of {no_t['pairs']} "
              f"pairs pass ({share:.5%}), {no_t['overflowed']} lists "
              f"overflow; with t {with_t['passed']} ({share_t:.5%})")
    assert 0 < share < 0.01 and share_t <= share
    # the t screen's walk would give the same results here
    occ_p, tests_p = _reference(name)
    assert torch.equal(occ_t, occ_p) and torch.equal(tests_t, tests_p)

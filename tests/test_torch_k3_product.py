"""K3's tensor-core product form (csrc/cluster_closest.cu) on the CPU.

The kernel takes the split-bf16 quantities as one bf16 matrix product per
visit: each operand component k stacks [r_hi, l1, l2, r_hi] against the
coefficients [c_hi, c_hi, c_hi, c_lo], with l1 = bf16(r_lo) and
l2 = r_lo - l1, at depth 4 k + stack, padded from 40 to 48. These tests
hold that form to the plain version on the small city's and the instanced
city's operands and blocks (every candidate slot of every group, a
superset of the slots a walk visits; the instanced ones in each slot's
object frame): the split is exact, and the stacked products, summed in
float64, equal the plain `_quantities` within the f32 rounding of its sums,
and the kernel's screen on them passes every candidate the plain version
finds valid. K5 (csrc/cluster_shadow.cu) takes the same products and
screen: the "k5-" cases run these checks on its shadow requests' slots
(tests/test_torch_k5_product.py `shadow_slots`: the small city, the
instanced city and the 40 x 40 curtain), where the screen must pass every
pair the plain strict any-hit test accepts. So do the per-row K6 and K7
(csrc/cluster_rows.cu): the "k6-" cases on the (row, slot) pairs K6's
plain walk visits at bounces 0 and 1 of the small city, with the per-row
operand, and "k7-city" on its shadow requests' rows
(tests/test_torch_k6_product.py `row_slots`, `shadow_row_slots`). They also hold the measure
that compares K3 with its plain version on the card
(`bounce_clustered.closest_agreement`) and the SASS count that shows the
tensor cores (`kernels.count_sass`). No JAX: the
plain K3 is held to the JAX kernel in tests/test_torch_cluster.py and
tests/test_torch_instancing.py."""

import pytest
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP

DEPTH = 48               # the kernel's padded depth (40 used)
# K3's visits, and K5's shadow-request slots
CASES = ["city", "instanced", "k5-city", "k5-instanced", "k5-curtain",
         "k6-bounce0", "k6-bounce1", "k7-city"]
U32 = 2.0 ** -24         # f32 unit roundoff
SIDE = 32                # 1,024 camera rays: one group


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _stacked_operand(hi, lo):
    """The kernel's A rows [g, FL, 48]: per component [r_hi, l1, l2, r_hi],
    then 8 zeros."""
    cols = []
    for h, r in zip(hi, lo):
        l1 = _bf16(r)
        cols += [h, l1, r - l1, h]
    return torch.stack(cols + [torch.zeros_like(hi[0])] * 8, -1)


def _stacked_coefficients(blk):
    """The kernel's B [g, 4, 48, CT] of each quantity: c_hi in stacks 0-2
    and c_lo in stack 3 of each component it reads (Q_ROWS), zero
    elsewhere."""
    out = blk.new_zeros(blk.shape[0], 4, DEPTH, BC.CT)
    for qn, rows in enumerate(BC.Q_ROWS):
        lanes = slice(qn * BC.CT, (qn + 1) * BC.CT)
        for c in rows:
            for st in range(4):
                out[:, qn, 4 * c + st] = blk[:, c + (10 if st == 3 else 0),
                                             lanes]
    return out


@pytest.fixture(scope="module")
def visits():
    """name -> [(hi, lo, blocks)] of every candidate slot of the groups of
    SIDE x SIDE camera rays, on the small city and the instanced city."""
    out = {}
    for name, host in (("city", TP.city_scene(tri_budget=4000, seed=1,
                                              blocks=2)),
                       ("instanced", TP.instanced_city(grid=2, subdiv=6))):
        scene = prepare(host, device="cpu")
        tbl = scene.cluster_tables
        cfg = PathTracerConfig(max_bounces=2)
        kslots = min(BC.DEFAULT_KSLOTS, tbl.n_clusters)
        cam = TP.default_camera(host, SIDE, SIDE)
        px, py = _pixel_grid(SIDE, SIDE, "cpu")
        fs, is_ = bf.initial_state(*camera_rays(cam, cfg, px, py, 1), px, py)
        src = torch.arange(fs.shape[1], dtype=torch.int32)
        fs, is_, _ = BC.sort_wavefront(fs, is_, src, True,
                                       BC.scene_bounds(tbl))
        od = BC.ray_operand(fs, is_)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, cfg.max_ray_travel, tbl,
                          kslots)
        cand = BC.map_cand_inst(cand, tbl, kslots)
        odg = od.view(BC.OD_ROWS, -1, BC.FL)
        slots = []
        for i in range(kslots):
            gs = (cand[:, 0, 0] > i).nonzero()[:, 0]
            if gs.numel() == 0:
                break
            blk = tbl.blocks[cand[gs, 0, 1 + i].long()]
            ray = (odg[BC.OD_D:BC.OD_D + 3, gs],
                   odg[BC.OD_OXD:BC.OD_OXD + 3, gs],
                   odg[BC.OD_O:BC.OD_O + 3, gs])
            if tbl.instanced:
                iid = cand[gs, 0, BC.inst_base(kslots) + i].long()
                ray = BC.object_operand(tbl.xf[iid][:, None], *ray)
            hi, lo = BC._operand(*ray, *BC._center(blk))
            slots.append((hi, lo, blk))
        assert len(slots) >= 4, name
        out[name] = slots
    return out


def _slots(request, name):
    """[(hi, lo, blocks, ...)] of the case: K3's visits, K5's slots (hi,
    lo, blocks, dist, requested), K6's visited (row, slot) pairs with the
    per-row operand or K7's slots."""
    if name.startswith("k5-"):
        import test_torch_k5_product as k5
        return k5.shadow_slots(name[3:])
    if name.startswith(("k6-", "k7-")):
        import test_torch_k6_product as k6
        return (k6.row_slots(int(name[-1])) if name.startswith("k6-")
                else k6.shadow_row_slots())
    return request.getfixturevalue("visits")[name]


@pytest.mark.parametrize("name", CASES)
def test_residual_splits_into_two_exact_bf16_parts(request, name):
    """l1 = bf16(r_lo) and l2 = r_lo - l1 are bf16-exact and l1 + l2 ==
    r_lo exactly, on every lane and slot; r_hi and the coefficient rows
    are bf16-exact, so every stacked operand is."""
    lanes = 0
    for hi, lo, blk, *_ in _slots(request, name):
        assert torch.equal(_bf16(blk[:, 0:20]), blk[:, 0:20])
        for h, r in zip(hi, lo):
            assert torch.isfinite(r).all()
            l1 = _bf16(r)
            l2 = r - l1
            assert torch.equal(_bf16(h), h)
            assert torch.equal(_bf16(l2), l2)
            assert torch.equal(l1 + l2, r)
            assert torch.equal(l1.double() + l2.double(), r.double())
        lanes += hi[0].numel()
    assert lanes >= 4 * BC.FL


@pytest.mark.parametrize("name", CASES)
def test_stacked_products_equal_the_plain_quantities(request, name):
    """The stacked coefficients are the block rows in the stacked order,
    and the stacked products summed in float64 equal the plain version's
    f32 sums within their rounding: |q_f32 - q_64| <= (n - 1) * 2^-24 *
    1.01 * sum |c * r| over the n = 3 x len(Q_ROWS[q]) products that it
    adds (the f64 sum of exact products is exact to 2^-53 relative)."""
    for hi, lo, blk, *_ in _slots(request, name):
        b = _stacked_coefficients(blk)
        for qn, rows in enumerate(BC.Q_ROWS):
            lanes = slice(qn * BC.CT, (qn + 1) * BC.CT)
            for c in range(10):
                got = b[:, qn, 4 * c:4 * c + 4]
                want = (blk[:, c, lanes], blk[:, c, lanes],
                        blk[:, c, lanes], blk[:, 10 + c, lanes])
                for st in range(4):
                    assert torch.equal(got[:, st], want[st] if c in rows
                                       else torch.zeros_like(want[st]))
        a = _stacked_operand(hi, lo).double()
        q64 = torch.einsum("gfk,gqkt->gqtf", a, b.double())
        mag = torch.einsum("gfk,gqkt->gqtf", a.abs(), b.double().abs())
        plain = BC._quantities(blk, hi, lo)
        for qn, rows in enumerate(BC.Q_ROWS):
            n = 3 * len(rows)
            bound = (n - 1) * U32 * 1.01 * mag[:, qn] + 1e-300
            err = (plain[qn].double() - q64[:, qn]).abs()
            assert bool((err <= bound).all()), (qn, float(
                (err / bound).max()))
            # the f64 sum of the plain version's own products: the split
            # loses nothing
            lanes = slice(qn * BC.CT, (qn + 1) * BC.CT)
            exact = sum(blk[:, k, lanes].double()[:, :, None]
                        * (hi[k].double() + lo[k].double())[:, None]
                        + blk[:, 10 + k, lanes].double()[:, :, None]
                        * hi[k].double()[:, None] for k in rows)
            assert torch.allclose(q64[:, qn], exact, rtol=0.0,
                                  atol=1e-14 * float(mag[:, qn].max()))


@pytest.mark.parametrize("name", CASES)
def test_screen_passes_every_valid_candidate(request, name):
    """K3's screen (csrc/cluster_mma.cuh `screen`: |det| > 0, inside the
    edge margins widened 4x, any sign of t) on the stacked sums, rounded
    from float64 to f32 as an f32 accumulation of the exact products:
    every candidate that the plain version finds valid passes it (K3: the
    closest-hit test with its margins; K5: the strict any-hit test at
    0 < t < dist, on the lanes with a request), so the kernel's exact pass
    over the screened candidates picks the plain version's winner or
    first occluder; and it passes few of the pairs."""
    max_travel = PathTracerConfig().max_ray_travel
    screened = valid_n = pairs = 0
    for hi, lo, blk, *shadow in _slots(request, name):
        q = torch.einsum("gfk,gqkt->gqtf", _stacked_operand(hi, lo).double(),
                         _stacked_coefficients(blk).double()).float()
        absd, su, sv, _ = BC._signed(*q.unbind(1))
        w = 4 * BC.MARGIN * absd
        passed = (absd > 0) & (su >= -w) & (sv >= -w) & (su + sv <= absd
                                                          + w + w)
        plain = BC._signed(*BC._quantities(blk, hi, lo))
        if shadow:
            dist, requested = shadow
            valid = BC._strict_hit(*plain, dist[:, None]) \
                & requested[:, None]
        else:
            valid, _ = BC._select(*plain, max_travel)
        assert not bool((valid & ~passed).any())
        screened += int(passed.sum())
        valid_n += int(valid.sum())
        pairs += passed.numel()
    assert valid_n > 100 and screened < 0.1 * pairs, (valid_n, screened,
                                                       pairs)


def _plain_city_k3():
    """K3's plain (ha, visits) on one group of the small city."""
    host = TP.city_scene(tri_budget=4000, seed=1, blocks=2)
    tbl = prepare(host, device="cpu").cluster_tables
    cfg = PathTracerConfig(max_bounces=2)
    cam = TP.default_camera(host, SIDE, SIDE)
    px, py = _pixel_grid(SIDE, SIDE, "cpu")
    fs, is_ = bf.initial_state(*camera_rays(cam, cfg, px, py, 1), px, py)
    od = BC.ray_operand(fs, is_)
    cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                      is_[bf.IS_ACTIVE] > 0, cfg.max_ray_travel, tbl, 16)
    return BC.closest_hit_reference(cand, od, tbl.blocks, 16,
                                    cfg.max_ray_travel, stats=True)


def test_closest_agreement_holds_the_kernel_to_its_tolerance():
    """closest_agreement passes identical results and one lane whose
    winner moved to a near-tie, and fails a lane switched to a far hit, a
    bit flipped in a row of a lane with the same winner, and a visit
    count off in the only group."""
    ha, vis = _plain_city_k3()
    hit = (ha[BC.HA_PRIM] >= 0).nonzero()[:, 0]
    assert hit.numel() > 100
    same = BC.closest_agreement(ha.clone(), vis.clone(), ha, vis)
    assert same["ok"] and same["differ"] == 0 and same["key_equal"] == 1.0
    lane = int(hit[0])

    def moved(scale):
        k = ha.clone()
        k[BC.HA_PRIM, lane] = ha[BC.HA_PRIM, lane] + 1
        k[BC.HA_T, lane] = ha[BC.HA_T, lane] * scale
        return BC.closest_agreement(k, vis, ha, vis)
    near = moved(1.0 + 1e-4)
    assert near["ok"] and near["differ"] == 1
    assert not moved(1.01)["ok"]
    k = ha.clone()
    k[BC.HA_U, lane] = torch.nextafter(ha[BC.HA_U, lane],
                                       torch.tensor(2.0))
    flipped = BC.closest_agreement(k, vis, ha, vis)
    assert not flipped["ok"] and flipped["hit_rows_differ"] == 1
    assert not BC.closest_agreement(ha, vis + 1, ha, vis)["ok"]


def test_count_sass_counts_tensor_core_instructions():
    """count_sass reads a cuobjdump -sass listing per function, predicated
    instructions included."""
    listing = """
        Function : _ZN12_GLOBAL__N_122cluster_closest_kernelILb0ELb0EEEvPKi
    .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0ab0*/                   HMMA.16816.F32.BF16 R12, R4, R8, RZ ;
        /*0ac0*/               @P0 HMMA.16816.F32.BF16 R16, R4, R10, R16 ;
        /*0ad0*/                   FFMA R2, R3, R4, R5 ;
        Function : _ZN12_GLOBAL__N_121cluster_shadow_kernelILb0ELb0EEEvPKi
        /*0000*/                   FADD R1, R2, R3 ;
"""
    counts = kernels.count_sass(listing, kernels.TENSOR_OPCODES)
    flat = [v for k, v in counts.items()
            if kernels.CLUSTER_CLOSEST_ENTRIES["cluster_closest"] in k]
    assert flat == [dict(HMMA=2, HGMMA=0)]
    assert sum(sum(v.values()) for v in counts.values()) == 2

"""K1's tensor-core form (csrc/bounce_fused_mma.cuh) on the CPU.

K1 takes each pair's det, u and v numerators as split-bf16 matrix
products on the tensor cores: the ray's components r = [d | o x d] split
exactly into r_hi + l1 + l2, the triangle's f32 coefficients c into
c_hi + c_lo (bounce_fused.coefficient_tile, which leaves out at most
2^-16 |c| of each), stacked [r_hi | l1 | l2 | r_hi] x [c_hi | c_hi | c_hi |
c_lo]. It screens the pairs on them with K3's edge margins widened by an
error term (SCREEN_EPS x the triangle's scale x the ray's largest
component) and resolves the pairs that pass with the plain f32 test. The
cases are the Cornell box, rooms_scene(16), kitchen_scene() and the
curtain Cornell box (micromaps) at 2,048 camera rays: the closest hits of
bounce 0 and of bounce 1 (bounce_reference's own state), and the NEE
shadow rays bounce_reference traces in nee slot 2 (on the kitchen too,
whose 513 lights a render sends through the external route instead).
This file holds a torch model of the
operand, the products summed exactly (float64), the screen and the
resolve, and checks it against bounce_reference's closest hits and
occlusions (on the curtain too, whose 14 triangles the kernel tests with
its exact loops: bounce_fused.EXACT_TRIS). No JAX: the plain K1 is held to the JAX kernel in
tests/test_torch_fused.py and the feature files.

K2 (csrc/shadow_occlusion.cu) runs the same screen on the external
route's shadow requests, packed per block: a model of its packing (the
requesting lanes of each block, in lane order, in batches of 32) and of
its per-lane result (the lowest occluder of the first group of 128
triangles that holds one, and the pairs up to it) is held to
occlusion_reference's occ and tests on the rooms' NEE-AT requests and the
kitchen's external power-NEE requests of bounces 0 and 1."""

import functools

import pytest
import torch

from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import wide as W
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP

COLS, ROWS = 64, 32          # 2,048 camera rays
CASES = ("cornell", "rooms", "kitchen", "curtain")
GROUP = 128                  # triangles between the kernel's resolves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(name):
    if name == "cornell":
        return TP.cornell_box()
    if name == "rooms":
        return TP.rooms_scene(16)
    if name == "kitchen":
        return TP.kitchen_scene()
    return TP.curtain_cornell(True)


@functools.lru_cache(maxsize=None)
def case(name):
    """(tables, queries): bounce_reference's closest-hit and shadow
    queries over bounces 0 and 1 of 2,048 camera rays, each (kind, o, d,
    tmax, u_alpha, result, lanes): `_intersect` and `_occluded` wrapped to
    record their inputs and results; `lanes` the lanes whose result the
    kernel writes (the shadow rays of the lanes with a request)."""
    host = _host(name)
    tables = prepare(host, device="cpu").bounce_tables
    cfg = PathTracerConfig(max_bounces=3, nee=NEEMode.POWER,
                           stochastic_texture_filtering=name == "curtain")
    kcfg = bf.KernelConfig.from_cfg(cfg)
    cam = TP.default_camera(host, COLS, ROWS)
    px, py = _pixel_grid(COLS, ROWS, "cpu")
    fs, is_ = bf.initial_state(*camera_rays(cam, cfg, px, py, 1), px, py)
    queries = []
    intersect, occluded = bf._intersect, bf._occluded

    def rec_intersect(tb, o, d, tmax, omm=False):
        res = intersect(tb, o, d, tmax, omm)
        queries.append(("closest", o, d, tmax, None, res, None))
        return res

    def rec_occluded(tb, o, d, tmax, stats=False, u_alpha=None):
        res = occluded(tb, o, d, tmax, stats, u_alpha)
        queries.append(("shadow", o, d, tmax, u_alpha, res, None))
        return res

    bf._intersect, bf._occluded = rec_intersect, rec_occluded
    try:
        for _ in range(2):
            n_before = len(queries)
            out = bf.bounce_reference(fs, is_, tables, kcfg, 1)
            for k in range(n_before, len(queries)):
                kind, o, d, tmax, ua, res, _ = queries[k]
                lanes = (out[2][5] > 0.5) if kind == "shadow" else \
                    torch.ones(o.shape[1], dtype=torch.bool)
                queries[k] = (kind, o, d, tmax, ua, res, lanes)
            fs, is_ = out[0], out[1]
    finally:
        bf._intersect, bf._occluded = intersect, occluded
    return tables, queries


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def tile_parts(tables):
    """(c_hi, c_lo) [T8, 15] f32 of det (3), u (6), v (6) read back from
    the tile, and the f32 coefficients c [T8, 15] they split."""
    t8 = tables.tri_tile.shape[1]
    tile = tables.tri_tile.float()
    his, los, cs = [], [], []
    for q, start in enumerate((bf.TC_DET, bf.TC_U, bf.TC_V)):
        b, nc = bf.TT_BASE[q], bf.TT_COMPS[q]
        his.append(tile[b:b + nc].T)
        los.append(tile[b + nc:b + 2 * nc].T)
        cs.append(tables.tri_coef[:t8, start:start + nc])
    return torch.cat(his, 1), torch.cat(los, 1), torch.cat(cs, 1)


def operand(o, d):
    """The lane's components r [6, N] = [d | o x d] (f32, as the kernel's
    cross3) and their exact split r_hi + l1 + l2."""
    r = torch.cat([d, W.cross3(o, d)], 0)
    hi = _bf16(r)
    l1 = _bf16(r - hi)
    return r, hi, l1, (r - hi) - l1


# the components each quantity reads, as columns of tile_parts
QCOLS = ((0, 3, (0, 1, 2)), (3, 9, range(6)), (9, 15, range(6)))


def tensor_core_quantities(tables, o, d):
    """(det, u_num, v_num) [T8, N] as the stacked products summed exactly
    (float64) and rounded to f32: a model of the tensor cores' sums of
    the same products."""
    c_hi, c_lo, _ = tile_parts(tables)
    _, hi, l1, l2 = operand(o, d)
    out = []
    for lo_col, hi_col, comps in QCOLS:
        ch = c_hi[:, lo_col:hi_col].double()
        cl = c_lo[:, lo_col:hi_col].double()
        rk = hi[list(comps)].double()
        full = (hi + l1 + l2)[list(comps)].double()
        out.append((ch @ full + cl @ rk).float())
    return out


def plain_numerators(tables, o, d):
    """(det, u_num, v_num) [T8, N] as the plain test sums them (f32, in
    its order) and its accept mask (tri_test: inside, |det| > 1e-12,
    t > 0) with u, v, t."""
    t8 = tables.tri_tile.shape[1]
    c = tables.tri_coef[:t8]
    oxd = W.cross3(o, d)
    un = bf._coef_dot(c, bf.TC_U, (d[0], d[1], d[2], oxd[0], oxd[1], oxd[2]))
    vn = bf._coef_dot(c, bf.TC_V, (d[0], d[1], d[2], oxd[0], oxd[1], oxd[2]))
    ok, u, v, t, det = bf._tri_params(c, o, d, oxd)
    accept = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return (det, un, vn), accept, u, v, t


def error_term(tables, o, d):
    """The screen's error term [T8, N]: SCREEN_EPS x scale x max |r_k|
    (f32, as the kernel forms it)."""
    r = operand(o, d)[0]
    # the kernel's fmaxf passes over a NaN component (a lane whose ray
    # origin is NaN: its products are NaN and fail the screen anyway)
    me = bf.SCREEN_EPS * r.abs().nan_to_num(nan=0.0).amax(0)
    return tables.tri_scale[:, None] * me.float()[None]


def screen(det, un, vn, e):
    """csrc/bounce_fused_mma.cuh `screen`."""
    absd = det.abs()
    s = torch.where(det >= 0.0, 1.0, -1.0)
    su, sv = un * s, vn * s
    w = bf.SCREEN_MARGIN * absd + e
    lim = absd + 2.0 * (w + e)
    unknown_sign = (absd < e) & (un.abs() + vn.abs() <= lim)
    return unknown_sign | ((absd >= e) & (absd > 0.0) & (su >= -w)
                           & (sv >= -w) & (su + sv <= lim))


def kernel_masks(passed):
    """The kernel's screen bits regrouped as its resolve reads them: per
    group of 128 triangles, ray and quad thread qs, the mask whose bit
    2c + e % 2 holds triangle j0 + 8c + 2 qs + e % 2; returns the set of
    (triangle, ray) pairs the masks name, [T8, N]."""
    t8, n = passed.shape
    out = torch.zeros_like(passed)
    j = torch.arange(t8)
    for j0 in range(0, t8, GROUP):
        jj = j[j0:j0 + GROUP]
        qs = (jj >> 1) & 3
        bit = 2 * ((jj - j0) >> 3) + (jj & 1)
        for q in range(4):
            sel = qs == q
            masks = (passed[j0:j0 + GROUP][sel].long()
                     << bit[sel][:, None]).sum(0)          # [N]
            for b in range(32):
                tri = j0 + 8 * (b >> 1) + 2 * q + (b & 1)
                if tri < t8:
                    out[tri] |= ((masks >> b) & 1).bool()
    return out


@functools.lru_cache(maxsize=None)
def screened(name):
    """Per query: (passed [T8, N], accept [T8, N], u, v, t, model
    quantities, plain numerators, error term)."""
    tables, queries = case(name)
    out = []
    for kind, o, d, tmax, ua, res, lanes in queries:
        tc = tensor_core_quantities(tables, o, d)
        plain, accept, u, v, t = plain_numerators(tables, o, d)
        e = error_term(tables, o, d)
        live = lanes[None]
        passed = screen(*tc, e) & live
        out.append((passed, accept & live, u, v, t, tc, plain, e))
    return out


def test_screen_constants_match_the_kernel():
    """csrc/bounce_fused_mma.cuh spells out the screen's margin, its error
    term's factor, the exact-loop threshold and the largest table that
    bounce_fused states."""
    import re
    from pathlib import Path
    src = (Path(bf.__file__).resolve().parents[1] / "csrc"
           / "bounce_fused_mma.cuh").read_text()
    chunks = int(re.search(r"kExactChunks = (\d+);", src).group(1))
    assert 8 * chunks == bf.EXACT_TRIS
    assert int(re.search(r"kMaxTris = (\d+);", src).group(1)) == bf.MAX_TRIS
    assert "kEps = 1.0f / 8192.0f" in src and bf.SCREEN_EPS == 1 / 8192
    assert "kScreen = 4.0f * (float)2e-3" in src
    assert bf.SCREEN_MARGIN == 4.0 * 2e-3


def test_coefficient_split_leaves_out_what_the_bound_counts():
    """c_hi = bf16(c) and c_lo = bf16(c - c_hi) on every case's table: the
    parts keep what coefficient_tile's bound assumes (|c - c_hi| <=
    2^-8 |c|, |c - c_hi - c_lo| <= 2^-16 |c|), the padding triangles are
    zero rows with zero scale, and each scale is at least its triangle's
    largest L1 row norm."""
    for name in CASES:
        tables, _ = case(name)
        c_hi, c_lo, c = tile_parts(tables)
        assert torch.all((c - c_hi).abs() <= 2.0 ** -8 * c.abs())
        assert torch.all((c - c_hi - c_lo).abs() <= 2.0 ** -16 * c.abs())
        pad = torch.arange(c.shape[0]) >= tables.n_tris
        assert torch.all(c_hi[pad] == 0) and torch.all(c_lo[pad] == 0)
        assert torch.all(tables.tri_scale[pad] == 0)
        norms = torch.stack([c[:, a:b].double().abs().sum(1)
                             for a, b, _ in QCOLS]).amax(0)
        assert torch.all(tables.tri_scale.double() >= norms)
        assert tables.tri_tile.dtype == torch.bfloat16
        assert tables.tri_tile.shape == (bf.TT_ROWS, -(-tables.n_tris // 8)
                                         * 8)


@pytest.mark.parametrize("name", CASES)
def test_stacked_products_within_the_stated_error(name):
    """The stacked products (summed exactly) differ from the plain f32
    numerators by at most half the error term on every pair with a
    finite ray (a NaN origin makes both NaN): the other half is the
    tensor cores' f32 accumulation's."""
    for _, _, _, _, _, tc, plain, e in screened(name):
        for q_tc, q_plain in zip(tc, plain):
            both_nan = torch.isnan(q_tc) & torch.isnan(q_plain)
            diff = (q_tc.double() - q_plain.double()).abs()
            ok = (diff <= 0.5 * e.double()) | both_nan
            assert torch.all(ok), \
                float((diff / e.double().clamp(min=1e-30))[~ok].max())


@pytest.mark.parametrize("name", CASES)
def test_screen_passes_every_pair_the_plain_test_accepts(name):
    """Every (ray, triangle) pair that tri_test accepts (inside, any
    t > 0) passes the screen, on every query of the case; the kernel's
    masks name exactly the pairs that pass."""
    n_accept = 0
    for passed, accept, *_ in screened(name):
        assert not torch.any(accept & ~passed)
        assert torch.equal(kernel_masks(passed), passed)
        n_accept += int(accept.sum())
    assert n_accept > 0


def resolve_closest(passed, accept, u, v, t, tmax, tables, omm):
    """The kernel's closest-hit resolve: over the screened pairs the exact
    test accepts with t < tmax (micro-TRANSPARENT rejected), the least
    (t, triangle index). Returns (t, prim, u, v) [N]."""
    valid = passed & accept & (t < tmax)
    if omm:
        st = bf.micro_states(tables, 0, t.shape[0], u, v)
        valid &= st != bf.MICRO_TRANSPARENT
    tt = torch.where(valid, t, bf._BIG)
    best = tt.amin(0)
    iota = torch.arange(t.shape[0])[:, None]
    j = torch.where(valid & (tt == best), iota, t.shape[0]).amin(0)
    hit = best < bf._BIG
    jj = j.clamp(max=t.shape[0] - 1)[None]
    pick = lambda x: torch.gather(x, 0, jj)[0]   # noqa: E731
    return (torch.where(hit, best, bf._BIG), torch.where(hit, j, -1),
            torch.where(hit, pick(u), 0.0), torch.where(hit, pick(v), 0.0))


@pytest.mark.parametrize("name", CASES)
def test_resolve_model_matches_bounce_reference(name):
    """The model's closest hits (t, prim, u, v) and occlusions equal the
    plain version's bit for bit on the lanes the kernel writes, with hits
    and (where there are shadow rays) occluded and lit lanes."""
    tables, queries = case(name)
    n_shadow = n_occluded = 0
    for (kind, o, d, tmax, ua, res, lanes), (passed, accept, u, v, t, *_) \
            in zip(queries, screened(name)):
        if kind == "closest":
            mt, mp, mu, mv = resolve_closest(passed, accept, u, v, t, tmax,
                                             tables, tables.omm)
            pt, pp, pu, pv = res[:4]
            assert torch.equal(mt, pt) and torch.equal(mp, pp)
            assert torch.equal(mu, pu) and torch.equal(mv, pv)
            assert int((pp >= 0).sum()) > 0
            continue
        valid = passed & accept & (t < tmax[None])
        if ua is not None and tables.omm:
            st = bf.micro_states(tables, 0, t.shape[0], u, v)
            valid &= (st != bf.MICRO_TRANSPARENT) & (
                (st != bf.MICRO_UNKNOWN)
                | (ua[None] < tables.tri_cover[:t.shape[0], None]))
        occ = valid.any(0)
        assert torch.equal(occ[lanes], res[lanes])
        n_shadow += int(lanes.sum())
        n_occluded += int(occ[lanes].sum())
    if name != "kitchen":
        assert n_shadow >= 500 and 0 < n_occluded < n_shadow


@pytest.mark.parametrize("name", CASES)
def test_screen_pass_share(name, capsys):
    """The share of the screened pairs (every triangle of the tile per
    lane) that pass, closest hits and shadow rays apart: a few percent at
    most, so the exact resolve is rare work. Printed for PERF.md
    (pytest -s)."""
    tables, queries = case(name)
    shares = {}
    for (kind, *_, lanes), (passed, accept, *_) in zip(queries,
                                                       screened(name)):
        got = shares.setdefault(kind, [0, 0, 0])
        got[0] += int(passed.sum())
        got[1] += int(lanes.sum()) * passed.shape[0]
        got[2] += int(accept.sum())
    with capsys.disabled():
        for kind, (p, pairs, acc) in shares.items():
            print(f"\nK1 screen {name} {kind}: {p} of {pairs} pairs pass "
                  f"({p / pairs:.5%}; {acc} accepted by the exact test)")
    for p, pairs, _ in shares.values():
        assert 0 < p / pairs < (0.3 if tables.n_tris < 64 else 0.03)


# K2's packing (csrc/shadow_occlusion.cu kSpan) and its screen kernel's
# block (bounce_fused_mma.cuh kThreads)
K2_SPAN, K2_THREADS = 4, 512


@functools.lru_cache(maxsize=None)
def k2_requests(name):
    """(tables, [sh [SR_ROWS, N]]): the shadow requests that external_nee
    builds on bounce_reference's exported surfaces at bounces 0 and 1 of
    2,048 camera rays (rooms: NEE-AT, nee slot 3; kitchen: power NEE on
    the external route, slot 5)."""
    from rtxpt_tpu_torch.lighting import neeat as na
    from rtxpt_tpu_torch.pt import dispatch
    from rtxpt_tpu_torch.pt.nee_external import external_nee
    host = _host(name)
    scene = prepare(host, device="cpu")
    tables = scene.bounce_tables
    nee = NEEMode.NEEAT if name == "rooms" else NEEMode.POWER
    state = na.init_state(COLS, ROWS, scene.lights.count, device="cpu") \
        if nee == NEEMode.NEEAT else None
    cfg = dispatch.resolve(scene, PathTracerConfig(
        max_bounces=3, nee=nee, stochastic_texture_filtering=True), "cpu",
        state)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode in (3, 5)
    cam = TP.default_camera(host, COLS, ROWS)
    px, py = _pixel_grid(COLS, ROWS, "cpu")
    fs, is_ = bf.initial_state(*camera_rays(cam, cfg, px, py, 1), px, py)
    out = []
    for b in range(2):
        res = bf.bounce_reference(fs, is_, tables, kcfg, 1)
        ext = external_nee(scene, cfg, state, res[3], fs[bf.FS_D:bf.FS_D + 3],
                           res[2][5] > 0.5, fs[bf.FS_PREVPDF],
                           is_[bf.IS_PREVDELTA] > 0, res[1][bf.IS_PX],
                           res[1][bf.IS_PY], 1, b)
        out.append(bf.shadow_requests(ext["shadow_o"], ext["shadow_d"],
                                      ext["sdist"], ext["do_nee"]))
        fs, is_ = res[0], res[1]
    return tables, out


def k2_packed(req):
    """The kernel's packing of request flags req [N]: block b of G takes
    the K = K2_SPAN x K2_THREADS / 32 segments of 32 lanes b, b + G, ...,
    b + (K - 1) G, and its requesting lanes in that order are cut into
    batches of 32 (one warp's). Returns [the list of batches (lane index
    tensors) of each block]."""
    n = req.shape[0]
    k = K2_SPAN * K2_THREADS // 32
    g = -(-n // (32 * k))
    blocks = []
    for b in range(g):
        lanes = ((b + torch.arange(k)[:, None] * g) * 32
                 + torch.arange(32)[None]).reshape(-1)
        lanes = lanes[lanes < n]
        blocks.append(list(torch.split(lanes[req[lanes]], 32)))
    return blocks


def k2_model(tables, sh):
    """occ [N] f32 and tests [N] i32 as K2's screen kernel writes them: a
    lane without a request 1 and 0; a packed request screened on the model
    products, its passing pairs resolved group by group (GROUP triangles)
    in table order, the lowest occluder of the first group that holds one
    (tests = its index + 1), or none (tests = n_tris)."""
    req = sh[bf.SR_DO] > 0.5
    occ = torch.ones(sh.shape[1])
    tests = torch.zeros(sh.shape[1], dtype=torch.int32)
    for lanes in sum(k2_packed(req), []):
        o, d = sh[bf.SR_O:bf.SR_O + 3, lanes], sh[bf.SR_D:bf.SR_D + 3, lanes]
        tmax = sh[bf.SR_DIST, lanes]
        passed = screen(*tensor_core_quantities(tables, o, d),
                        error_term(tables, o, d))
        _, accept, u, v, t = plain_numerators(tables, o, d)
        assert not torch.any(accept & ~passed)
        valid = passed & accept & (t < tmax[None])
        first = torch.full((lanes.numel(),), -1, dtype=torch.int64)
        for j0 in range(0, valid.shape[0], GROUP):
            g = valid[j0:j0 + GROUP]
            low = torch.where(g, torch.arange(g.shape[0])[:, None] + j0,
                              1 << 30).amin(0)
            first = torch.where((first < 0) & g.any(0), low, first)
            if bool((first >= 0).all()):
                break                        # the warp's walk ends early
        occ[lanes] = (first >= 0).float()
        tests[lanes] = torch.where(first >= 0, first + 1,
                                   tables.n_tris).int()
    return occ, tests


def test_k2_packing_constants_match_the_kernel():
    from pathlib import Path
    csrc = Path(bf.__file__).resolve().parents[1] / "csrc"
    assert f"kSpan = {K2_SPAN};" in (csrc / "shadow_occlusion.cu").read_text()
    assert "kThreads = 32 * kWarps;" in (csrc / "bounce_fused_mma.cuh"
                                          ).read_text()
    assert f"kWarps = {K2_THREADS // 32};" in (csrc / "bounce_fused_mma.cuh"
                                               ).read_text()


@pytest.mark.parametrize("name", ["rooms", "kitchen"])
def test_k2_packed_screen_matches_occlusion_reference(name, capsys):
    """The model of K2's packed screen gives occlusion_reference's occ and
    tests on every lane of the external requests; the packing takes each
    requesting lane once, and the batches are full but for each block's
    last."""
    tables, shs = k2_requests(name)
    assert tables.n_tris > bf.EXACT_TRIS
    for b, sh in enumerate(shs):
        req = sh[bf.SR_DO] > 0.5
        blocks = k2_packed(req)
        batches = sum(blocks, [])
        packed = torch.cat(batches)
        assert torch.equal(packed.sort().values, torch.nonzero(req)[:, 0])
        assert all(x.numel() == 32 for bl in blocks for x in bl[:-1])
        occ_m, tests_m = k2_model(tables, sh)
        occ_p, tests_p = bf.occlusion_reference(tables, sh, stats=True)
        assert torch.equal(occ_m, occ_p) and torch.equal(tests_m, tests_p)
        assert 0 < int((occ_p[req] > 0.5).sum()) < int(req.sum())
        with capsys.disabled():
            print(f"\nK2 packed {name} bounce {b}: {int(req.sum())} requests "
                  f"of {req.numel()} lanes in {len(batches)} batches "
                  f"(unpacked: {-(-req.numel() // 32)} warps), "
                  f"{int((occ_p[req] > 0.5).sum())} occluded")

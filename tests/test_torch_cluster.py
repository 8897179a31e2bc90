"""The clustered tier of the port (scenes above 2048 triangles) against the
JAX package, on the CPU: the city scene, the cluster build, the cull, the
wavefront sort keys, the plain versions of K3, K4 and K5 against the JAX
Pallas kernels in interpret mode, and the slice end to end.

Every comparison feeds both packages the same numpy inputs, made from a
seed, on the JAX test's small city (city_scene(4000, seed=1, blocks=2):
3,512 triangles, 46 clusters). The slice matched the JAX package on every
pixel at rtol = atol = 2e-3 with image means within 3e-7 relative, and
with the same ray counts, occupancies and cull overflow (48x32, 3 bounces,
kslots 64 and 8)."""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.accel import cluster as JCL
from rtxpt_tpu.accel.cull import cull_candidates as j_cull
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.ops import wavefront as JW
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel import cluster as TCL
from rtxpt_tpu_torch.accel.cull import cull_candidates as t_cull
from rtxpt_tpu_torch.apps import cli
from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.ops import wavefront as TW
from rtxpt_tpu_torch.prepare import cluster_scene_from_numpy, prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import wide as W
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.pt.integrator import render_sample
from rtxpt_tpu_torch.scene import procedural as TP

TOL = 2e-3
KSLOTS = 64              # the default; the small city has 46 clusters
SAMPLE = 1
W_IMG, H_IMG = 64, 32    # 2048 camera rays = 2 groups of 1024 lanes
CLUSTER_CUH = Path(BC.__file__).resolve().parents[1] / "csrc" / "cluster.cuh"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores, and the barriers of
    oversubscribed threads made these [2, 128, 1024] ops a hundred times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_city(mod):
    return mod.city_scene(tri_budget=4000, seed=1, blocks=2)


@pytest.fixture(scope="module")
def city():
    """(JAX host, JAX scene, port host, port scene on the CPU)."""
    jh, th = _small_city(JP), _small_city(TP)
    return jh, j_prepare(jh), th, prepare(th, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_cluster_tables(jscene):
    jt = jscene.cluster_tables
    return dict(blocks=np.asarray(jt.blocks), aabb_lo=np.asarray(jt.aabb_lo),
                aabb_hi=np.asarray(jt.aabb_hi),
                mat_rows=np.asarray(jt.mat_rows),
                light_rows=np.asarray(jt.light_rows),
                offsets=np.asarray(jt.offsets), n_clusters=jt.n_clusters,
                n_tris=jt.n_tris, n_lights=jt.n_lights, env_rows=jt.env_rows,
                tex_ct=jt.tex_ct, omm=jt.omm, instanced=jt.instanced)


# ---------------------------------------------------------------------------
# Host side: scene, Morton order, cluster build
# ---------------------------------------------------------------------------


def test_city_scene_identical(city):
    jh, _, th, _ = city
    assert len(jh.instances) == len(th.instances) == 1
    for field in ("positions", "normals", "uvs", "indices", "material"):
        np.testing.assert_array_equal(getattr(jh.instances[0], field),
                                      getattr(th.instances[0], field),
                                      err_msg=field)
    for field in ("base_color", "metallic", "roughness", "ior",
                  "transmission", "emissive", "specular_f0_scale"):
        np.testing.assert_array_equal(_np(getattr(jh.materials, field)),
                                      _np(getattr(th.materials, field)),
                                      err_msg=field)
    for field in ("kind", "direction", "intensity"):
        np.testing.assert_array_equal(
            _np(getattr(jh.analytic_lights, field)),
            _np(getattr(th.analytic_lights, field)), err_msg=field)
    assert jh.camera == th.camera
    assert len(th.instances[0].indices) == 3512


def test_city_camera_stands_inside_a_tower():
    """The benchmark city's own camera (seed 0, the default 8 blocks)
    stands inside the tower of block (2, 6), so its frame is black in
    both packages; city_overview raises it above every roof."""
    host = TP.city_scene(350_000, seed=0)
    pos = host.instances[0].positions
    idx = host.instances[0].indices
    mat = host.instances[0].material
    cam = np.asarray(host.camera["position"], np.float32)
    towers = mat != 0                       # material 0 is the ground
    tri = pos[idx[towers]]                  # [T, 3, 3]
    # the tower of block (2, 6) is centred on x = 25, z = 65
    near = (np.abs(tri[:, :, 0] - 25.0) < 5.0).all(1) & \
        (np.abs(tri[:, :, 2] - 65.0) < 5.0).all(1)
    lo, hi = tri[near].reshape(-1, 3).min(0), tri[near].reshape(-1, 3).max(0)
    assert ((lo < cam) & (cam < hi)).all(), (lo, cam, hi)
    raised = TP.city_overview(TP.city_scene(350_000, seed=0)).camera
    assert raised["position"][1] > pos[:, 1].max()
    assert raised["target"] == host.camera["target"]


@pytest.mark.parametrize("flag", ["textured", "normal_mapped"])
def test_city_scene_refuses_unported_variants(flag):
    """The city's textured and normal-mapped variants, refused until the
    texture slice, are the JAX package's: the same textures and material
    texture ids."""
    jh = JP.city_scene(4000, seed=1, blocks=2, **{flag: True})
    th = TP.city_scene(4000, seed=1, blocks=2, **{flag: True})
    assert len(th.textures) == len(jh.textures) > 0
    for a, b in zip(th.textures, jh.textures):
        np.testing.assert_array_equal(a, b)
    for field in ("base_color_tex", "normal_tex", "metal_rough_tex",
                  "emissive_tex"):
        np.testing.assert_array_equal(
            getattr(th.materials, field).numpy(),
            np.asarray(getattr(jh.materials, field)), err_msg=field)


def test_city_scene_with_env_matches_jax():
    """city_scene(with_env=True) carries the JAX package's sky."""
    jh = JP.city_scene(4000, seed=1, blocks=2, with_env=True)
    th = TP.city_scene(4000, seed=1, blocks=2, with_env=True)
    np.testing.assert_array_equal(th.envmap_image, jh.envmap_image)
    assert th.envmap_image.shape == (64, 128, 3)
    assert th.envmap_scale == jh.envmap_scale == 0.5


def test_morton_order_identical(city):
    jh = city[0]
    pos = jh.instances[0].positions
    idx = jh.instances[0].indices
    np.testing.assert_array_equal(TCL.morton_permutation(pos, idx),
                                  np.asarray(JCL.morton_permutation(pos, idx)))
    cen = pos[idx].mean(axis=1)
    codes = np.sort(TCL.morton_codes(cen))
    np.testing.assert_array_equal(codes, np.sort(JCL.morton_codes(cen)))
    for size in (128, 16):
        np.testing.assert_array_equal(TCL.radix_cut_offsets(codes, size),
                                      JCL.radix_cut_offsets(codes, size))


def test_cluster_tables_identical(city):
    """prepare's cluster tables equal the JAX package's exactly: the build
    is the same numpy code on the same Morton-ordered arrays."""
    _, js, _, ts = city
    jt, tt = js.cluster_tables, ts.cluster_tables
    assert ts.bounce_tables is None and tt is not None
    for field in ("blocks", "aabb_lo", "aabb_hi", "mat_rows", "light_rows",
                  "offsets"):
        a = np.asarray(getattr(jt, field))
        b = getattr(tt, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    assert (tt.n_clusters, tt.n_tris, tt.n_lights) == \
        (jt.n_clusters, jt.n_tris, jt.n_lights) == (46, 3512, 9)


def test_kernel_row_maps_match_header():
    """csrc/cluster.cuh spells out the row maps and the attribute row
    order that K3 writes; they must be the Python ones."""
    text = CLUSTER_CUH.read_text()
    rows = re.search(r"kAttrRows\[HA_NATTR\] = \{([^}]*)\}", text).group(1)
    assert tuple(int(x) for x in rows.split(",")) == BC.ATTR_ROWS
    consts = dict((k, int(v)) for k, v in re.findall(
        r"\b((?:OD|HA|SH)_[A-Z]+) = (\d+)", text))
    for name, value in consts.items():
        if name == "HA_NATTR":
            assert value == bf.AT_ROWS
        else:
            assert getattr(BC, name) == value, name
    assert len(consts) == 5 + 10 + 8


# ---------------------------------------------------------------------------
# Cull and wavefront keys
# ---------------------------------------------------------------------------


def _cull_inputs(seed):
    """Random beams against random boxes; a third of the boxes contain the
    origins' region, so many hull entries tie at 0."""
    g = np.random.default_rng(seed)
    C, G, R = 40, 3, 8
    lo = g.uniform(-10, 9, (C, 3)).astype(np.float32)
    hi = lo + g.uniform(0.2, 2.0, (C, 3)).astype(np.float32)
    lo[::3] = -12.0
    hi[::3] = 12.0
    o = g.uniform(-4, 4, (3, G, R, 128)).astype(np.float32)
    d = g.standard_normal((3, G, R, 128)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1])                  # one sign-pure group
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    active = g.uniform(size=(G, R, 128)) < 0.9
    active[2, 3] = False                       # an empty row
    tmax = g.uniform(1.0, 30.0, (G, R, 128)).astype(np.float32)
    return o, d, active, tmax, lo, hi


@pytest.mark.parametrize("tmax_kind", ["scalar", "per_ray"])
@pytest.mark.parametrize("paged", [False, True])
def test_cull_candidates_identical(tmax_kind, paged):
    o, d, active, tmax, lo, hi = _cull_inputs(3)
    if tmax_kind == "scalar":
        tmax = np.float32(25.0)
    k = 8
    j_in = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(active),
            jnp.asarray(tmax), jnp.asarray(lo), jnp.asarray(hi))
    t_in = (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(active),
            float(tmax) if tmax_kind == "scalar" else torch.from_numpy(tmax),
            torch.from_numpy(lo), torch.from_numpy(hi))
    jc, jo = j_cull(*j_in, kslots=k)
    tc, to = t_cull(*t_in, kslots=k)
    if paged:
        jc, jo = j_cull(*j_in, kslots=k, lo=JBC._page_boundary(jc, k))
        tc, to = t_cull(*t_in, kslots=k, lo=BC.page_boundary(tc, k))
    jc = np.asarray(jc)
    assert jc[:, 0, 0].max() == k           # the lists saturate
    assert (jc[:, 0, 1 + 2 * k:] == 0).any()  # entries at 0.0 tie
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert int(to) == int(jo)


def test_pixel_morton_key_identical():
    g = np.random.default_rng(5)
    px = g.integers(0, 4096, 5000).astype(np.int32)
    py = g.integers(0, 4096, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        TW.pixel_morton_key(torch.from_numpy(px), torch.from_numpy(py)),
        np.asarray(JW.pixel_morton_key(jnp.asarray(px), jnp.asarray(py))))


def test_ray_coherence_key_sort_and_unsort_identical():
    g = np.random.default_rng(6)
    n = 4096
    o = g.uniform(-5, 25, (3, n)).astype(np.float32)
    d = g.standard_normal((3, n)).astype(np.float32)
    d[:, :50] = np.float32([0.0, 1.0, 0.0])[:, None]   # tied keys
    active = g.uniform(size=n) < 0.8
    lo = np.float32([-5, -5, -5])
    ext = np.float32([30, 30, 30])
    jk = JW.ray_coherence_key(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(lo), jnp.asarray(ext),
                              jnp.asarray(active))
    tk = TW.ray_coherence_key(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(lo), torch.from_numpy(ext),
                              torch.from_numpy(active))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    rows = g.standard_normal((4, n)).astype(np.float32)
    src = np.arange(n, dtype=np.int32)
    jkey, jrows = JW.sort_rows_by_key(jk, jnp.asarray(np.concatenate(
        [rows, src[None].view(np.float32)])))
    tkey, trows, perm = TW.sort_rows_by_key(tk, torch.from_numpy(rows))
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows)[:4])
    np.testing.assert_array_equal(perm.numpy().astype(np.int32),
                                  np.asarray(jrows)[4].view(np.int32))
    back = TW.unsort_rows(perm, trows)
    np.testing.assert_array_equal(back.numpy(), rows)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JW.unsort_rows(
            jnp.asarray(perm.numpy().astype(np.int32)), jnp.asarray(
                trows.numpy()))))


# ---------------------------------------------------------------------------
# K3, K4 and K5: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _groups(x, g):
    """[K, N] -> the JAX kernels' [G, K, FL]."""
    return jnp.asarray(np.ascontiguousarray(
        x.reshape(x.shape[0], g, BC.FL).swapaxes(0, 1)))


def _flat(x):
    """The JAX kernels' [G, K, FL] -> [K, N]."""
    x = np.asarray(x)
    return np.ascontiguousarray(x.swapaxes(0, 1).reshape(x.shape[1], -1))


def _tiles(x):
    return jnp.asarray(x.reshape(x.shape[0], -1, 128))


def _jcull(o3, d3, active, tmax, jt, g):
    def g4(x):
        return jnp.asarray(x.reshape(3, g, bp._R, 128))
    return j_cull(g4(o3), g4(d3), jnp.asarray(active.reshape(g, bp._R, 128)),
                  tmax if np.ndim(tmax) == 0 else
                  jnp.asarray(tmax.reshape(g, bp._R, 128)),
                  jt.aabb_lo, jt.aabb_hi, KSLOTS)[0]


@pytest.fixture(scope="module")
def jax_chain(city):
    """The JAX kernels along bounces 0 and 1 of 2048 unsorted camera rays:
    per bounce, the inputs and outputs of K3, K4 and K5."""
    jh, js, th, _ = city
    jt = js.cluster_tables
    cfg = JConfig(max_bounces=4)
    key = bp._cfg_key(cfg)
    # looking down on the blocks, so that most rays hit geometry
    aimed = _small_city(TP)
    aimed.camera = dict(position=[10.0, 16.0, 24.0], target=[10.0, 2.0, 10.0],
                        up=[0.0, 1.0, 0.0], fov_y_deg=30.0)
    cam = TP.default_camera(aimed, W_IMG, H_IMG)
    px, py = _pixel_grid(W_IMG, H_IMG)
    o, d, spread = camera_rays(cam, PathTracerConfig(), px, py, SAMPLE)
    fs, is_ = (x.numpy() for x in bf.initial_state(o, d, spread, px, py))
    n = fs.shape[1]
    g = n // BC.FL
    steps = []
    for b in range(2):
        o3, d3 = fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3]
        active = is_[bf.IS_ACTIVE] > 0
        od = np.concatenate([d3, W.cross3(_t(o3), _t(d3)).numpy(), o3,
                             active[None].astype(np.float32)])
        cand = _jcull(o3, d3, active, np.float32(cfg.max_ray_travel), jt, g)
        # each kernel is called with the keywords of the JAX clustered
        # tier's own call (bounce_clustered.py:1671, :1715, :1823), so that
        # test_render_sample_matches_jax_clustered_tier finds these
        # compiles in jit's cache
        ha = _flat(JBC._kernel_a1_call(
            cand, _groups(od, g), jt.blocks, KSLOTS,
            float(cfg.max_ray_travel), noprune=False, interpret=True,
            omm=False, xf=None))
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        fs2, is2, sh, hit, _, _ = (None if x is None else
                                   np.asarray(x).reshape(x.shape[0], -1)
                                   for x in JBC._kernel_a2_call(
            scal, _tiles(ha), _tiles(fs), _tiles(is_), jt.mat_rows,
            jt.light_rows, None, None, None, key, jt.n_lights, jt.tr, True,
            tex_maps=(1, 0, 0, 0), interpret=True, fs2=None, prio=False,
            omm=False, maxb=None))
        do = sh[BC.SH_DO] > 0.5
        cand_s = _jcull(sh[BC.SH_O:BC.SH_O + 3], sh[BC.SH_D:BC.SH_D + 3], do,
                        np.where(do, sh[BC.SH_DIST], np.float32(-3e38)),
                        jt, g)
        occ = np.asarray(JBC._kernel_b1_call(
            cand_s, _groups(sh, g), jt.blocks, KSLOTS, interpret=True,
            omm=False, xf=None)).reshape(-1)
        steps.append(dict(fs=fs, is_=is_, od=od, cand=np.asarray(cand),
                          ha=ha, out=(fs2, is2, sh, hit),
                          cand_s=np.asarray(cand_s), occ=occ))
        fs, is_ = fs2, is2
    return cfg, steps


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("bounce", [0, 1])
def test_k3_plain_matches_pallas_kernel(city, jax_chain, bounce):
    cfg, steps = jax_chain
    s = steps[bounce]
    tables = city[3].cluster_tables
    before = kernels.launches["cluster_closest"]
    ha, visits = BC.closest_hit(_t(s["cand"]), _t(s["od"]), tables.blocks,
                                KSLOTS, float(cfg.max_ray_travel),
                                stats=True)
    ha = ha.numpy()
    assert kernels.launches["cluster_closest"] == before
    # the prune visits a prefix of each list, and at least its first slot
    count = s["cand"][:, 0, 0]
    assert ((visits.numpy() <= count) & (visits.numpy() >= (count > 0))).all()
    jha = s["ha"]
    same = ha[BC.HA_PRIM] == jha[BC.HA_PRIM]
    assert same.mean() >= 0.999, same.mean()
    assert (jha[BC.HA_PRIM] >= 0).mean() > 0.1 + 0.7 * (bounce == 0)
    np.testing.assert_allclose(ha[:, same], jha[:, same], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bounce", [0, 1])
def test_k4_plain_matches_pallas_kernel(city, jax_chain, bounce):
    cfg, steps = jax_chain
    s = steps[bounce]
    tables = city[3].cluster_tables
    kcfg = bf.KernelConfig.from_cfg(cfg)
    before = kernels.launches["cluster_shade"]
    out = [x.numpy() for x in BC.shade(_t(s["ha"]), _t(s["fs"]), _t(s["is_"]),
                                       tables, kcfg, SAMPLE)]
    assert kernels.launches["cluster_shade"] == before
    jfs, jis, jsh, jhit = s["out"]
    tfs, tis, tsh, thit = out
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) \
        & (tsh[BC.SH_DO] == jsh[BC.SH_DO])
    assert same.mean() >= 0.995, same.mean()
    for name, a, b in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit)):
        np.testing.assert_allclose(a[:, same], b[:, same], rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert jsh[BC.SH_DO].mean() > 0.1                 # NEE requests made


@pytest.mark.parametrize("bounce", [0, 1])
def test_k5_plain_matches_pallas_kernel(city, jax_chain, bounce):
    _, steps = jax_chain
    s = steps[bounce]
    tables = city[3].cluster_tables
    before = kernels.launches["cluster_shadow"]
    occ, tests = BC.occlusion(_t(s["cand_s"]), _t(s["out"][2]), tables.blocks,
                              KSLOTS, stats=True)
    occ = occ.numpy()
    assert kernels.launches["cluster_shadow"] == before
    # each visited slot tests the lanes still unoccluded, each up to its
    # first occluder: at most every triangle of every listed slot for each
    # request, and some lane stops inside a cluster
    do_g = (s["out"][2][BC.SH_DO] > 0.5).reshape(-1, BC.FL).sum(1)
    tests = tests.numpy()
    assert (tests <= do_g * s["cand_s"][:, 0, 0] * BC.CT).all()
    assert tests.sum() >= do_g.sum()
    assert (tests % BC.CT != 0).any()
    same = occ == s["occ"]
    assert same.mean() >= 0.999, same.mean()
    do = s["out"][2][BC.SH_DO] > 0.5
    assert 0.0 < s["occ"][do].mean() < 1.0          # both outcomes occur


# ---------------------------------------------------------------------------
# Wrappers and dispatch
# ---------------------------------------------------------------------------


def test_wrappers_refuse_other_and_mixed_devices(city):
    tables = city[3].cluster_tables
    cand = torch.zeros((1, 1, 1 + (2 + BC.R) * 4), dtype=torch.int32)
    od = torch.zeros((BC.OD_ROWS, BC.FL), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        BC.closest_hit(cand, od, tables.blocks, 4, 1e27)
    sh = torch.zeros((BC.SH_ROWS, BC.FL), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        BC.occlusion(cand, sh, tables.blocks, 4)
    with pytest.raises(ValueError, match="same device"):
        BC.occlusion(cand.to("meta"), torch.zeros((BC.SH_ROWS, BC.FL)),
                     tables.blocks, 4)


def test_resolve_clustered_scene(city):
    """resolve sets the clustered tier's kslots and pages: the defaults
    (64, 2) clamp to the small city's 46 clusters, one page; kslots 8
    keeps two pages of the six the lists could fill."""
    scene = city[3]
    assert scene.cluster_tables.n_clusters == 46
    for device in ("cpu", "cuda"):
        cfg = dispatch.resolve(scene, PathTracerConfig(), device)
        assert (cfg.kernel_tier, cfg.cluster_kslots, cfg.cluster_pages) == \
            ("clustered", 46, 1)
        assert dispatch.resolve(scene, cfg, device) == cfg
    cfg = dispatch.resolve(scene, PathTracerConfig(cluster_kslots=8), "cpu")
    assert (cfg.cluster_kslots, cfg.cluster_pages) == (8, 2)
    cfg = dispatch.resolve(scene, PathTracerConfig(cluster_kslots=40,
                                                   cluster_pages=3), "cpu")
    assert (cfg.cluster_kslots, cfg.cluster_pages) == (40, 2)
    with pytest.raises(ValueError, match="cluster tables"):
        dispatch.resolve(scene, PathTracerConfig(kernel_tier="fused"), "cpu")


@pytest.mark.parametrize("case", ["environment", "textures", "priorities",
                                  "micromaps", "split"])
def test_clustered_tier_refuses_unserved_features(city, case, monkeypatch):
    """What the clustered tier does not serve raises by name; an
    environment light is refused only where the tables lack the
    environment table (prepare bakes it: test_clustered_tier_serves_the_
    environment). Nested priorities are served (K4's priority variant,
    tests/test_torch_prio.py): their case checks that. The split channels
    are served on the flat route (K4's split variant, tests/
    test_torch_split_clustered.py) and refused on the per-row route: their
    case checks both."""
    scene, cfg = city[3], PathTracerConfig()
    if case == "environment":
        sky = prepare(_small_city_env(), device="cpu")
        scene = sky.replace(cluster_tables=dataclasses.replace(
            sky.cluster_tables, env=None))
    elif case == "textures":
        # a pinned clustered tier without stochastic texture filtering
        # (the kernels' texture path); "auto" takes the general tier
        textured = prepare(TP.city_scene(tri_budget=4000, seed=1, blocks=2,
                                         textured=True), device="cpu")
        assert dispatch.resolve(textured, cfg, "cpu").kernel_tier == "xla"
        scene = textured
        cfg = PathTracerConfig(kernel_tier="clustered")
    elif case == "priorities":
        scene = scene.replace(has_nested_priorities=True)
        for c in (cfg, PathTracerConfig(kernel_tier="clustered")):
            assert dispatch.resolve(scene, c, "cpu").kernel_tier == \
                "clustered"
        return
    elif case == "micromaps":
        # tables without the micromaps, pinned ("auto" takes the general
        # tier, tests/test_torch_omm.py)
        scene = scene.replace(tri_opacity=object())
        cfg = PathTracerConfig(kernel_tier="clustered")
    else:
        cfg = PathTracerConfig(split_channels=True)
        assert dispatch.resolve(scene, cfg, "cpu").kernel_tier == "clustered"
        monkeypatch.setattr(BC, "FLAT", False)
    with pytest.raises(NotImplementedError,
                       match="clustered tier does not serve") as err:
        dispatch.resolve(scene, cfg, "cpu")
    if case == "split":
        assert "split diffuse/specular channels on the per-row route" in \
            str(err.value)


def _small_city_env():
    return TP.city_scene(tri_budget=4000, seed=1, blocks=2, with_env=True)


def test_clustered_tier_serves_the_environment():
    """The sky city gets cluster tables with the environment table and
    resolves to the clustered tier; its lights hold the environment."""
    scene = prepare(_small_city_env(), device="cpu")
    assert scene.cluster_tables.env.shape == (bf.ET_SIZE,)
    assert scene.lights.env_light >= 0
    cfg = dispatch.resolve(scene, PathTracerConfig(), "cpu")
    assert cfg.kernel_tier == "clustered" and not cfg.nee_external


def test_cluster_scene_from_numpy_refuses_unported_parts(city):
    """Opacity micromap tables are carried across with their micromap
    lanes (tests/test_torch_omm.py) and raise by name without them;
    instanced tables are carried across (tests/test_torch_instancing.py),
    but only with their world candidate lists and maps."""
    tables = _jax_cluster_tables(city[1])
    tables["omm"] = True
    with pytest.raises(ValueError, match="omm"):
        cluster_scene_from_numpy(tables, device="cpu")
    tables = _jax_cluster_tables(city[1])
    tables["instanced"] = True
    with pytest.raises(ValueError, match="wc_block"):
        cluster_scene_from_numpy(tables, device="cpu")


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kslots", [64, 8])
def test_render_sample_matches_jax_clustered_tier(city, kslots,
                                                  monkeypatch):
    """render_sample on the port's own cluster tables, which equal the JAX
    package's tables carried across, against the JAX clustered tier in
    interpret mode: >= 99% of pixels within 2e-3, image mean within 1e-3
    relative, and the same ray counts, occupancies and cull overflow.
    kslots 8 saturates the lists, so a second page runs. The JAX tier
    runs its bounce chain unrolled (its documented fallback, the same
    body as the lax.scan: RTXPT_TPU_CLUSTER_SCAN=0), so that its kernels
    compile once per configuration, the kslots-64 ones in jax_chain."""
    jh, js, th, ts = city
    w, h = 48, 32
    monkeypatch.setattr(JBC, "_SCAN", False)
    ref = jint.render_sample(
        js, JP.default_camera(jh, w, h),
        JConfig(max_bounces=3, kernel_tier="clustered",
                pallas_interpret=True, cluster_kslots=kslots,
                cluster_pages=2), w, h, jnp.uint32(SAMPLE))
    # the carried tables are the port's own, number for number, so one
    # render stands for both (rendering is deterministic on the CPU)
    carried = cluster_scene_from_numpy(_jax_cluster_tables(js),
                                       device="cpu").cluster_tables
    own = ts.cluster_tables
    for field in ("blocks", "aabb_lo", "aabb_hi", "mat_rows", "light_rows",
                  "offsets"):
        assert torch.equal(getattr(carried, field), getattr(own, field))
    assert (carried.n_clusters, carried.n_tris, carried.n_lights) == \
        (own.n_clusters, own.n_tris, own.n_lights)
    cfg = PathTracerConfig(max_bounces=3, cluster_kslots=kslots)
    out = render_sample(ts, TP.default_camera(th, w, h), cfg, w, h, SAMPLE)
    assert out["kernel_tier"] == "clustered"
    a, b = np.asarray(ref["L"]), out["L"].numpy()
    close = np.isclose(b, a, rtol=TOL, atol=TOL).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())
    assert int(out["ray_count"]) == int(ref["ray_count"])
    np.testing.assert_array_equal(out["occupancy"].numpy(),
                                  np.asarray(ref["occupancy"]))
    assert int(out["cull_overflow"]) == int(ref["cull_overflow"])
    if kslots == 8:
        assert int(ref["cull_overflow"]) > 0


def test_cli_renders_the_city(tmp_path):
    from PIL import Image

    out = tmp_path / "city.png"
    assert cli.main(["--scene", "city", "--tri-budget", "10000", "--device",
                     "cpu", "--width", "16", "--height", "12", "--spp", "1",
                     "--bounces", "2", "--out", str(out)]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (12, 16, 3) and img.max() > 0

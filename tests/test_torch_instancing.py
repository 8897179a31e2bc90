"""Instancing in the port (the two-level BVH and the instanced clustered tier)
against the JAX package, on the CPU: the same scenes and numpy-seeded rays
through both packages.

Scenes: the JAX package's instancing test scenes, built by the port's
procedural.instanced_boxes (tests/test_tlas.py `_instanced_scene`: 9 boxes
sharing one prototype, a floor, an emissive panel, a point light; 112 world
triangles, so it resolves to the TLAS walk) and procedural.instanced_city
(tests/test_cluster_instanced.py `_instanced_city` at grid 2, subdivision
6: 4 towers sharing one prototype and a floor, no emissive triangle;
2,928 world triangles, past the 2048 of the fused tier, so it gets
instanced cluster tables).

  - build_two_level, the lights bake over the expanded emissive list and
    build_cluster_tables_instanced are equal entry by entry (the cluster
    tables' M10 against the transpose of the JAX xf tile).
  - The M10 identity of test_xform_operand_map_exact, and the port's map
    of the ray operand against the direct object-frame operand.
  - The TLAS walk, closest and any-hit, against intersect_closest_tlas /
    intersect_any_tlas: prim, inst, front and occlusion equal on >= 99.9%
    of rays, t and uv within 1e-5 on >= 99.9% of the rays whose prims
    agree (tests/test_torch_bvh.py's limits for the BVH walk).
  - K3's and K5's instanced plain versions against _kernel_a1_call /
    _kernel_b1_call(..., xf=...) in interpret mode, on 2 groups at bounces
    0 and 2 (the state carried by the port's plain versions): prim ids
    equal on >= 99.9% of lanes and every HA row within rtol = atol = 2e-3
    on those lanes (HA_INST included), occlusion equal on >= 99.9%.
  - render through the instanced clustered tier against the JAX package's
    (interpret mode), and through the TLAS route against the JAX xla tier
    on the boxes, each 16x16, 2 spp, 2 bounces: >= 99% of pixels within
    2e-3, means within 1e-3 relative, the same ray counts.
  - F1: the TLAS route renders the city without emissive triangles (the
    JAX TLAS route crashes there, test_cluster_instanced.py's red test);
    it is held as that test holds it, against the instanced clustered
    tier, here the JAX package's render of the previous item, with that
    test's cross-tier limit (at most 2% of pixels outside
    1e-3 + 1e-2 |b|).

The JAX renders compile for 10-20 s each on the CPU, so the file makes
two: the instanced clustered tier's (both samples, and F1's reference)
and the xla tier's.
  - prepare's default instancing="auto" still flattens every
    single-instance scene the port served (Cornell, rooms, city).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.accel import tlas as JT
from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel import cluster as TCL
from rtxpt_tpu_torch.accel import tlas as TT
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.lighting.lights_baker import emissive_prim_index
from rtxpt_tpu_torch.prepare import cluster_scene_from_numpy, prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.scene import procedural as TP

TOL = 2e-3
WALK_TOL = 1e-5
SHARE = 0.999
PIXELS = 0.99
MEAN_RTOL = 1e-3
SAMPLE = 1
W_IMG, H_IMG = 64, 32          # 2048 camera rays = 2 groups of 1024 lanes
IMG = 16                       # the renders' width and height
CITY_CFG = dict(max_bounces=2, enable_russian_roulette=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_test_scenes():
    """The JAX package's test constructions. Importing
    test_cluster_instanced sets RTXPT_TPU_PALLAS_INTERPRET, which would
    change the JAX tier of later tests in this process: the environment is
    restored."""
    env = dict(os.environ)
    try:
        import test_cluster_instanced
        import test_tlas
    finally:
        os.environ.clear()
        os.environ.update(env)
    return test_tlas._instanced_scene, test_cluster_instanced._instanced_city


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX host, JAX scene, port host, port scene on the CPU)."""
    j_boxes, j_city = _jax_test_scenes()
    out = {}
    for name, jh, th in (("boxes", j_boxes(), TP.instanced_boxes()),
                         ("city", j_city(grid=2, subdiv=6),
                          TP.instanced_city(grid=2, subdiv=6))):
        out[name] = (jh, j_prepare(jh), th, prepare(th, device="cpu"))
    return out


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ---------------------------------------------------------------------------
# Host side: scenes, the two-level build, the light bake, cluster tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["boxes", "city"])
def test_instanced_scenes_identical(scenes, name):
    jh, _, th, _ = scenes[name]
    assert len(jh.instances) == len(th.instances)
    for ji, ti in zip(jh.instances, th.instances):
        for field in ("positions", "normals", "uvs", "indices", "material",
                      "transform"):
            _equal(getattr(ti, field), getattr(ji, field), field)
        assert ti.mesh_key == ji.mesh_key
    for field in ("base_color", "roughness", "emissive", "metallic"):
        _equal(getattr(th.materials, field), getattr(jh.materials, field),
               field)
    for field in ("kind", "position", "intensity", "cos_inner"):
        _equal(getattr(th.analytic_lights, field),
               getattr(jh.analytic_lights, field), field)
    assert th.force_instancing == jh.force_instancing


@pytest.mark.parametrize("name", ["boxes", "city"])
def test_build_two_level_identical(scenes, name):
    """The pool arrays, tri_base, the TLAS node table [N, 22], inst_pack
    [I, 21], inst_mesh, em_rank, inst_light_base and the expanded light
    positions equal the JAX package's."""
    jh, _, th, _ = scenes[name]
    jb = JT.build_two_level(jh)
    tb = TT.build_two_level(th, device="cpu")
    assert sorted(jb) == sorted(tb)
    for key, value in jb.items():
        if key != "tlas":
            _equal(tb[key], value, key)
    jt, tt = jb["tlas"], tb["tlas"]
    for f in TT.TLAS.__dataclass_fields__:
        a, b = getattr(jt, f), getattr(tt, f)
        if isinstance(b, int):
            assert a == b, f
        else:
            assert _np(a).dtype == _np(b).dtype, f
            _equal(b, a, f)
    assert tt.nodes.shape[1] == 22 and tt.inst_pack.shape[1] == 21
    # the carried TLAS is the built one
    carried = TT.tlas_from_numpy({f: _np(getattr(jt, f)) if not isinstance(
        getattr(jt, f), int) else getattr(jt, f)
        for f in TT.TLAS.__dataclass_fields__}, device="cpu")
    for f in TT.TLAS.__dataclass_fields__:
        a = getattr(carried, f)
        assert a == getattr(tt, f) if isinstance(a, int) \
            else torch.equal(a, getattr(tt, f)), f


@pytest.mark.parametrize("name", ["boxes", "city"])
def test_two_level_light_bake_identical(scenes, name):
    """prepare's lights, baked over the expanded (instance x emissive pool
    triangle) list, equal the JAX package's LightList; the city has no
    emissive triangle, so its list holds the point light alone and an
    empty tri_light."""
    _, js, _, ts = scenes[name]
    assert ts.tlas is not None and ts.bvh is None
    jl, tl = js.lights, ts.lights
    for field in ("kind", "p0", "p1", "p2", "emission", "extra", "normal",
                  "power", "cdf", "tri_light"):
        _equal(getattr(tl, field), getattr(jl, field), field)
    assert (tl.num, tl.env_light) == (int(np.asarray(jl.num)),
                                      int(np.asarray(jl.env_light)))
    n_emissive = 2 if name == "boxes" else 0
    assert tl.tri_light.numel() == n_emissive
    # the expanded list is indexed by (prim, inst): a hit without its
    # instance has no entry
    with pytest.raises(ValueError, match="instance"):
        emissive_prim_index(ts, torch.zeros(1, dtype=torch.int32), None)
    for field in ("tri_pack", "mat_pack"):
        _equal(getattr(ts, field), getattr(js, field), field)


def _jax_cluster_tables(jt):
    return dict(blocks=_np(jt.blocks), aabb_lo=_np(jt.aabb_lo),
                aabb_hi=_np(jt.aabb_hi), mat_rows=_np(jt.mat_rows),
                light_rows=_np(jt.light_rows), offsets=jt.offsets,
                n_clusters=jt.n_clusters, n_tris=jt.n_tris,
                n_lights=jt.n_lights, env_rows=jt.env_rows, tex_ct=jt.tex_ct,
                omm=jt.omm, instanced=jt.instanced,
                wc_block=_np(jt.wc_block), wc_inst=_np(jt.wc_inst),
                xf=_np(jt.xf), inst_post=_np(jt.inst_post))


def test_instanced_cluster_tables_identical(scenes):
    """build_cluster_tables_instanced equals the JAX package's: the
    prototypes' object-space blocks (pool triangle ids in AT_GIDX), the
    world candidate boxes, block and instance ids, inst_post, and M10 =
    the transpose of the JAX xf tile's [10, 10] corner; the tables carried
    across from the JAX package are the same tensors."""
    _, js, th, ts = scenes["city"]
    jt, tt = js.cluster_tables, ts.cluster_tables
    assert tt.instanced and jt.instanced and tt.offsets is None
    for field in ("blocks", "aabb_lo", "aabb_hi", "mat_rows", "light_rows",
                  "wc_block", "wc_inst", "inst_post"):
        _equal(getattr(tt, field), getattr(jt, field), field)
    xf = _np(jt.xf)
    assert xf.shape == (5, 16, 128) and not xf[:, 10:].any() \
        and not xf[:, :, 10:].any()
    _equal(tt.xf, xf[:, :10, :10].transpose(0, 2, 1), "xf")
    assert (tt.n_clusters, tt.n_tris, tt.n_lights) == \
        (jt.n_clusters, jt.n_tris, jt.n_lights) == (32, 1632, 1)
    # O(prototype) geometry: 20 pool blocks serve 32 world candidates
    assert tt.blocks.shape[0] == 20
    n_world = sum(len(i.indices) for i in th.instances)
    assert n_world == 2928 and tt.n_tris < n_world
    carried = cluster_scene_from_numpy(_jax_cluster_tables(jt),
                                       device="cpu").cluster_tables
    for field in ("blocks", "aabb_lo", "aabb_hi", "wc_block", "wc_inst",
                  "xf", "inst_post"):
        assert torch.equal(getattr(carried, field), getattr(tt, field)), \
            field
    assert carried.instanced and carried.n_clusters == tt.n_clusters


def test_xform_operand_map_exact():
    """The 10x10 world -> object map of the ray operand is the identity it
    claims (tests/test_cluster_instanced.py test_xform_operand_map_exact):
    M10 @ [d, o x d, o, 1] == [d_o, o_o x d_o, o_o, 1] in float64; and the
    port's f32 map (object_operand, the kernels' sums) lands within f32
    rounding of it. M[3:6, 3:6] = det(A)^-1 A^T is the block a transpose
    would break."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        A = rng.normal(size=(3, 3)) + np.eye(3) * 2.0
        if np.linalg.det(A) <= 0:
            A = -A
        t = rng.normal(size=3) * 5.0
        M, det_a = TCL.instance_operand_map(A, t)
        assert det_a == pytest.approx(np.linalg.det(A))
        np.testing.assert_allclose(M[3:6, 3:6], A.T / np.linalg.det(A),
                                   rtol=1e-12)
        a_inv = np.linalg.inv(A)
        t_o = -a_inv @ t
        o = rng.normal(size=3) * 3.0
        d = rng.normal(size=3)
        base = np.concatenate([d, np.cross(o, d), o, [1.0]])
        o_o, d_o = a_inv @ o + t_o, a_inv @ d
        want = np.concatenate([d_o, np.cross(o_o, d_o), o_o, [1.0]])
        np.testing.assert_allclose(M @ base, want, rtol=1e-9, atol=1e-9)
        got = BC.object_operand(
            torch.tensor(M, dtype=torch.float32),
            *(torch.tensor(base[k:k + 3, None], dtype=torch.float32)
              for k in (0, 3, 6)))
        np.testing.assert_allclose(torch.cat(got)[:, 0].numpy(), want[:9],
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The TLAS walk
# ---------------------------------------------------------------------------


def _walk_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.1, 3.0, n)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.full((n,), 1e-4, np.float32)
    tmax = rng.uniform(0.3, 1e3, n).astype(np.float32)
    return o, d, tmin, tmax


@pytest.mark.parametrize("any_hit", [False, True])
def test_tlas_walk_matches_jax(scenes, any_hit):
    """Closest hit: prim, inst and front equal on >= 99.9% of rays, t and
    uv within 1e-5 on >= 99.9% of the rays whose prims agree; any-hit:
    occlusion equal on >= 99.9% of rays."""
    _, js, _, ts = scenes["boxes"]
    args = _walk_rays(4096, 5)
    jargs = [jnp.asarray(x) for x in args]
    targs = [torch.from_numpy(x) for x in args]
    if any_hit:
        jo = _np(JT.intersect_any_tlas(js.tlas, *jargs))
        to = TT.intersect_any_tlas(ts.tlas, *targs).numpy()
        assert (jo == to).mean() >= SHARE
        assert 0.05 < to.mean() < 0.95
        return
    jh = JT.intersect_closest_tlas(js.tlas, *jargs)
    th = TT.intersect_closest_tlas(ts.tlas, *targs)
    same = _np(jh.prim) == th.prim.numpy()
    assert same.mean() >= SHARE
    assert (_np(jh.inst) == th.inst.numpy()).mean() >= SHARE
    assert (_np(jh.front) == th.front.numpy()).mean() >= SHARE
    hits = th.prim.numpy() >= 0
    assert 0.2 < hits.mean() < 0.9
    assert (th.inst.numpy()[hits] >= 0).all() \
        and (th.inst.numpy()[~hits] == -1).all()
    for what, a, b in (("t", th.t, jh.t), ("uv", th.bary, jh.bary)):
        ok = np.isclose(_np(a), _np(b), rtol=WALK_TOL, atol=WALK_TOL)
        ok = ok.reshape(len(same), -1).all(1)
        assert ok[same].mean() >= SHARE, what


# ---------------------------------------------------------------------------
# K3 and K5, instanced: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _groups(x, g):
    """[K, N] -> the JAX kernels' [G, K, FL]."""
    return jnp.asarray(np.ascontiguousarray(
        _np(x).reshape(x.shape[0], g, BC.FL).swapaxes(0, 1)))


def _flat(x):
    x = np.asarray(x)
    return np.ascontiguousarray(x.swapaxes(0, 1).reshape(x.shape[1], -1))


@pytest.fixture(scope="module")
def inst_chain(scenes):
    """Bounces 0..2 of 2048 camera rays of the instanced city, carried by
    the port's plain versions: per bounce the mapped candidate rows and
    the operands of K3 and K5, and the JAX kernels' results on them."""
    _, js, th, ts = scenes["city"]
    jt, tbl = js.cluster_tables, ts.cluster_tables
    cfg = dispatch.resolve(ts, PathTracerConfig(max_bounces=4,
                                                nee=NEEMode.POWER), "cpu")
    kslots, max_travel = cfg.cluster_kslots, float(cfg.max_ray_travel)
    assert (kslots, cfg.cluster_pages) == (32, 1)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    cam = TP.default_camera(th, W_IMG, H_IMG)
    px, py = tint._pixel_grid(W_IMG, H_IMG)
    o, d, spread = tint.camera_rays(cam, cfg, px, py, SAMPLE)
    fs, is_ = bf.initial_state(o, d, spread, px, py)
    g = fs.shape[1] // BC.FL
    steps = {}
    for b in range(3):
        od = BC.ray_operand(fs, is_)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, max_travel, tbl, kslots)
        cand = BC.map_cand_inst(cand, tbl, kslots)
        ha = BC.closest_hit_reference(cand, od, tbl.blocks, kslots,
                                      max_travel, xf=tbl.xf)
        fs2, is2, sh, _ = BC.shade_reference(BC.post_attr_inst(ha, tbl), fs,
                                             is_, tbl, kcfg, SAMPLE)
        do = sh[BC.SH_DO] > 0.5
        cand_s, _ = BC.cull(sh[BC.SH_O:BC.SH_O + 3], sh[BC.SH_D:BC.SH_D + 3],
                            do, torch.where(do, sh[BC.SH_DIST], -3e38), tbl,
                            kslots)
        cand_s = BC.map_cand_inst(cand_s, tbl, kslots)
        if b in (0, 2):
            jha = _flat(JBC._kernel_a1_call(
                jnp.asarray(cand.numpy()), _groups(od, g), jt.blocks, kslots,
                max_travel, noprune=False, interpret=True, omm=False,
                xf=jt.xf))
            jocc = np.asarray(JBC._kernel_b1_call(
                jnp.asarray(cand_s.numpy()), _groups(sh, g), jt.blocks,
                kslots, interpret=True, omm=False, xf=jt.xf)).reshape(-1)
            steps[b] = dict(cand=cand, od=od, ha=ha, jha=jha, cand_s=cand_s,
                            sh=sh, jocc=jocc)
        fs, is_ = fs2, is2
    return tbl, kslots, max_travel, steps


@pytest.mark.parametrize("bounce", [0, 2])
def test_k3_inst_plain_matches_pallas_kernel(inst_chain, bounce):
    tbl, kslots, max_travel, steps = inst_chain
    s = steps[bounce]
    before = kernels.launches["cluster_closest_inst"]
    ha, visits = BC.closest_hit(s["cand"], s["od"], tbl.blocks, kslots,
                                max_travel, stats=True, xf=tbl.xf)
    assert kernels.launches["cluster_closest_inst"] == before
    assert torch.equal(ha, s["ha"])
    count = s["cand"][:, 0, 0].numpy()
    assert ((visits.numpy() <= count) & (visits.numpy() >= (count > 0))).all()
    ha, jha = ha.numpy(), s["jha"]
    same = ha[BC.HA_PRIM] == jha[BC.HA_PRIM]
    assert same.mean() >= SHARE, same.mean()
    hit = jha[BC.HA_PRIM] >= 0
    assert hit.mean() > (0.5 if bounce == 0 else 0.02)
    # several instances win, and HA_INST is -1 exactly where nothing hit
    assert len(np.unique(jha[BC.HA_INST][hit])) >= (3 if bounce == 0 else 1)
    assert (ha[BC.HA_INST][~hit & same] == -1).all()
    np.testing.assert_allclose(ha[:, same], jha[:, same], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bounce", [0, 2])
def test_k5_inst_plain_matches_pallas_kernel(inst_chain, bounce):
    tbl, kslots, _, steps = inst_chain
    s = steps[bounce]
    before = kernels.launches["cluster_shadow_inst"]
    occ, tests = BC.occlusion(s["cand_s"], s["sh"], tbl.blocks, kslots,
                              stats=True, xf=tbl.xf)
    assert kernels.launches["cluster_shadow_inst"] == before
    do = s["sh"][BC.SH_DO].numpy() > 0.5
    assert int(tests.sum()) >= do.sum()
    same = occ.numpy() == s["jocc"]
    assert same.mean() >= SHARE, same.mean()
    assert 0.0 < s["jocc"][do].mean() < 1.0          # both outcomes occur


def test_map_cand_inst_and_post_attr_leave_flat_tables_alone(scenes):
    """Flat tables keep their candidate rows and HA rows as they are."""
    ts = prepare(TP.city_scene(tri_budget=4000, seed=1, blocks=2),
                 device="cpu")
    tbl = ts.cluster_tables
    assert not tbl.instanced and tbl.xf is None
    cand = torch.arange(2 * BC.inst_base(4), dtype=torch.int32).reshape(
        2, 1, -1)
    assert BC.map_cand_inst(cand, tbl, 4) is cand
    ha = torch.randn(BC.HA_ROWS, 8)
    assert BC.post_attr_inst(ha, tbl) is ha


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------


def _images_agree(got, want, what):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all(), what
    close = np.isclose(got, want, rtol=TOL, atol=TOL).all(-1)
    assert close.mean() >= PIXELS, (what, close.mean())
    rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-30)
    assert rel <= MEAN_RTOL, (what, rel)


@pytest.fixture(scope="module")
def jax_city_samples(scenes):
    """The JAX package's instanced clustered tier on the city, samples 0
    and 1 (interpret mode, through render_sample_jit as
    tests/test_cluster_instanced.py renders it, with its settings: one
    compile serves both), 16x16, 2 bounces, power NEE, no Russian
    roulette."""
    jh, js, _, _ = scenes["city"]
    jcfg = JConfig(nee=JNEE.POWER, kernel_tier="clustered",
                   pallas_interpret=True, cluster_pages=2, **CITY_CFG)
    cam = JP.default_camera(jh, IMG, IMG)
    return [jint.render_sample_jit(js, cam, jcfg, IMG, IMG, jnp.uint32(s))
            for s in range(2)]


def test_render_instanced_clustered_matches_jax(scenes, jax_city_samples,
                                                monkeypatch):
    """The instanced clustered tier against the JAX package's, 16x16,
    2 spp, 2 bounces, power NEE: pixels and means as above, the same ray
    counts, occupancy and cull overflow; K3 and K5 ran their instanced
    plain versions."""
    _, _, th, ts = scenes["city"]
    tcfg = PathTracerConfig(nee=NEEMode.POWER, **CITY_CFG)
    tcam = TP.default_camera(th, IMG, IMG)
    calls = []
    monkeypatch.setattr(BC, "closest_hit_reference", _counting(
        BC.closest_hit_reference, calls, "k3"))
    monkeypatch.setattr(BC, "occlusion_reference", _counting(
        BC.occlusion_reference, calls, "k5"))
    for s, ref in enumerate(jax_city_samples):
        out = tint.render_sample(ts, tcam, tcfg, IMG, IMG, s)
        assert out["kernel_tier"] == "clustered"
        _images_agree(out["L"], ref["L"], f"sample {s}")
        assert int(out["ray_count"]) == int(ref["ray_count"])
        np.testing.assert_array_equal(out["occupancy"].numpy(),
                                      _np(ref["occupancy"]))
        assert int(out["cull_overflow"]) == int(ref["cull_overflow"])
    assert calls.count(("k3", True)) == calls.count(("k5", True)) == 4
    assert float(out["L"].mean()) > 1e-3


def _counting(fn, calls, name):
    def wrapped(*args, **kw):
        calls.append((name, kw.get("xf") is not None))
        return fn(*args, **kw)
    return wrapped


def test_render_tlas_route_matches_jax_xla_tier(scenes):
    """The TLAS route (the boxes resolve to "xla") against the JAX xla
    tier, 16x16, 2 spp, 2 bounces, power NEE; the emissive panel's hits
    take the expanded light list's MIS weight."""
    jh, js, th, ts = scenes["boxes"]
    assert ts.cluster_tables is None and ts.bounce_tables is None
    cfg = PathTracerConfig(max_bounces=2, nee=NEEMode.POWER)
    assert dispatch.resolve(ts, cfg, "cpu").kernel_tier == "xla"
    jcfg = JConfig(max_bounces=2, nee=JNEE.POWER, kernel_tier="xla")
    jimg, _, jrays = jint.render(js, JP.default_camera(jh, 16, 16), jcfg,
                                 16, 16, spp=2)
    timg, _, trays = tint.render(ts, TP.default_camera(th, 16, 16), cfg,
                                 16, 16, spp=2)
    _images_agree(timg, jimg, "boxes")
    assert trays == jrays
    assert float(timg.mean()) > 1e-3


def test_f1_tlas_route_renders_the_city_without_emissive_triangles(
        scenes, jax_city_samples):
    """F1 in the port: the TLAS route renders the instanced city, whose
    light list has no triangle, finite and lit, and within the JAX test's
    cross-tier limit of the JAX package's instanced clustered render of
    the same sample (test_instanced_clustered_matches_tlas_path's own
    comparison, with the port's TLAS route in place of the JAX one)."""
    _, _, th, ts = scenes["city"]
    assert ts.lights.tri_light.numel() == 0
    tcfg = PathTracerConfig(nee=NEEMode.POWER, kernel_tier="xla",
                            **CITY_CFG)
    out = tint.render_sample(ts, TP.default_camera(th, IMG, IMG), tcfg, IMG,
                             IMG, 0)
    assert out["kernel_tier"] == "xla"
    a = out["L"].numpy()
    b = _np(jax_city_samples[0]["L"])
    assert np.isfinite(a).all() and a.mean() > 1e-3
    bad = np.abs(a - b) > 1e-3 + 1e-2 * np.abs(b)
    assert bad.mean() <= 2e-2, (bad.mean(), float(np.abs(a - b).max()))


# ---------------------------------------------------------------------------
# prepare
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "rooms", "city"])
def test_prepare_auto_flattens_single_instance_scenes(name):
    """Every scene the port served before is one instance: the default
    instancing="auto" flattens it, to the tables instancing="off" builds."""
    host = dict(cornell=TP.cornell_box, rooms=lambda: TP.rooms_scene(4),
                city=lambda: TP.city_scene(tri_budget=4000, seed=1,
                                           blocks=2))[name]()
    auto = prepare(host, device="cpu")
    off = prepare(host, device="cpu", instancing="off")
    assert auto.tlas is None and auto.bvh is not None
    tables = "cluster_tables" if name == "city" else "bounce_tables"
    first = "blocks" if name == "city" else "tri_rows"
    assert torch.equal(getattr(getattr(auto, tables), first),
                       getattr(getattr(off, tables), first))
    assert torch.equal(auto.bvh.nodes, off.bvh.nodes)


def test_prepare_instancing_modes(scenes):
    """"auto" builds the two-level scene for shared prototypes, "off"
    flattens it, "force" builds it without sharing, and a mode the JAX
    package does not know raises."""
    th = scenes["boxes"][2]
    off = prepare(th, device="cpu", instancing="off")
    assert off.tlas is None and off.bounce_tables is not None
    assert off.bvh.num_triangles == 12 * 9 + 4
    one = TP.cornell_box()
    forced = prepare(one, device="cpu", instancing="force")
    assert forced.tlas is not None and forced.tlas.n_instances == 1
    with pytest.raises(ValueError, match="instancing"):
        prepare(one, device="cpu", instancing="on")

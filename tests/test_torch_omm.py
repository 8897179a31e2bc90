"""Opacity micromaps and the alpha retrace in the port against the JAX
package, on the CPU: the same seeded inputs through both packages.

  (a) The bake (`bake_opacity_micromaps`): classes, words and coverages
      equal on the curtain Cornell box (an 8 x 8 checkerboard alpha), its
      40 x 40 grid form (a 64 x 64 checkerboard) and the foliage curtain
      (a 160 x 160 grid textured with `leaf_texture(64)`); `micro_index`
      equal on a grid of (u, v) in numpy and in f32.
  (b) `prepare`: the dropped TRANSPARENT triangles, the classes and words,
      the BVH's leaf-order words, the fused tables' rows and the cluster
      tables (the port's side table against the JAX 7-slot blocks) equal.
  (c) `intersect_closest_alpha` / `intersect_any_alpha` on 4,096 seeded
      rays: equal prims, t within 1e-5, on >= 99.9% of the rays, on the
      brute path (K8's plain version and the retrace) and on the BVH walk
      with BRUTE_MAX_TRIS lowered to 16 in both packages (the walk's
      micromap test).
  (d) The general tier ("xla") render of the curtain against the JAX
      package's: >= 99% of the pixels within 2e-3, means within 1e-3
      relative, ray counts and occupancy equal.
  (e) The cutout lets light through, against the solid curtain
      (tests/test_omm_alpha.py:68-86), on the fused and general tiers.
  (f) `dispatch.resolve` gives the JAX package's tier for each scene,
      with stochastic texture filtering on and off.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtxpt_tpu.accel import brute as jbrute
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import dispatch as jdispatch
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import omm as JO
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.scene.scene import MeshInstance as JMesh
from rtxpt_tpu_torch.accel import brute as tbrute
from rtxpt_tpu_torch.accel import cluster as TCL
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.scene import omm as TO
from rtxpt_tpu_torch.scene import procedural as TP

from test_omm_alpha import _alpha_scene

SAMPLE = 2
TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_grid_curtain(grid: int, texture=None):
    """tests/test_cluster_omm.py `_alpha_scene_big(True)` at grid x grid
    (a 64 x 64 checkerboard alpha), or with `texture`; built here without
    importing that module, whose import sets the JAX package's interpret
    switch for the whole process."""
    host = _alpha_scene(True)
    pos, nrm, uv, idx, mat = JP._quad_grid(
        [0.02, 0.02, 0.5], [0.98, 0.02, 0.5], [0.98, 0.98, 0.5],
        [0.02, 0.98, 0.5], grid, grid, 5)
    host.instances[-1] = JMesh(positions=pos, normals=nrm, uvs=uv,
                               indices=idx, material=mat, name="curtain")
    if texture is None:
        yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        texture = np.ones((64, 64, 4), np.float32)
        texture[..., :3] = 0.2
        texture[..., 3] = ((yy + xx) % 2).astype(np.float32)
    host.textures = [texture]
    return host


HOSTS = {
    "curtain": (lambda: _alpha_scene(True),
                lambda: TP.curtain_cornell(True)),
    "grid": (lambda: _jax_grid_curtain(40),
             lambda: TP.curtain_cornell(True, grid=40)),
    "leaf_grid": (lambda: _jax_grid_curtain(40, JP.leaf_texture(64)),
                  lambda: TP.curtain_cornell(True, grid=40,
                                             texture=TP.leaf_texture(64))),
    "foliage": (lambda: _jax_grid_curtain(160, JP.leaf_texture(64)),
                lambda: TP.curtain_cornell(True, grid=160,
                                           texture=TP.leaf_texture(64))),
}


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX host, JAX scene, port host, port scene), at first use."""
    made = {}

    def get(name):
        if name not in made:
            jh, th = (f() for f in HOSTS[name])
            made[name] = (jh, j_prepare(jh), th, prepare(th, device="cpu"))
        return made[name]
    return get


# ---------------------------------------------------------------------------
# (a) the bake
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["curtain", "grid", "foliage"])
def test_bake_matches_jax(name):
    jh, th = (f() for f in HOSTS[name])
    np.testing.assert_array_equal(th.textures[0], jh.textures[0])
    want = JO.bake_opacity_micromaps(jh, jh.flatten().materials, jh.textures)
    got = TO.bake_opacity_micromaps(th, th.flatten().materials, th.textures)
    for what, a, b in zip(("classes", "words", "covers"), got, want):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    counts = np.bincount(got[0], minlength=3)
    states = np.bincount(((got[1][got[0] == TO.MIXED, None].astype(np.int64)
                           >> (2 * np.arange(16))) & 3).ravel(), minlength=3)
    assert counts[TO.MIXED] > 0
    if name == "curtain":
        # each micro-cell spans 2 x 2 texels of the 8 x 8 checkerboard
        assert states[TO.MICRO_UNKNOWN] == states.sum()
    elif name == "grid":
        assert (states > 0).all()
    else:
        # every class; the 64 texels' edges fall on the 160 x 160 grid's
        # micro-cell edges, so no cell straddles one: no UNKNOWN cell
        assert counts[TO.OPAQUE] > 12 and counts[TO.TRANSPARENT] > 0
        assert states[TO.MICRO_UNKNOWN] == 0 and states[TO.MICRO_OPAQUE] > 0 \
            and states[TO.MICRO_TRANSPARENT] > 0


def test_micro_index_matches_jax():
    u, v = np.meshgrid(np.linspace(0.0, 1.0, 161), np.linspace(0.0, 1.0, 161))
    keep = u + v <= 1.0
    u, v = u[keep], v[keep]
    np.testing.assert_array_equal(TO.micro_index(u, v), JO.micro_index(u, v))
    uf, vf = u.astype(np.float32), v.astype(np.float32)
    got = TO.micro_index(torch.tensor(uf), torch.tensor(vf)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JO.micro_index(jnp.asarray(uf), jnp.asarray(vf))))
    assert set(got.tolist()) == set(range(16))


# ---------------------------------------------------------------------------
# (b) prepare
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["curtain", "leaf_grid", "grid"])
def test_prepare_matches_jax(scenes, name):
    jh, js, th, ts = scenes(name)
    for field in ("indices", "tri_material", "tri_subinstance"):
        np.testing.assert_array_equal(getattr(ts.geometry, field).numpy(),
                                      np.asarray(getattr(js.geometry, field)),
                                      err_msg=field)
    dropped = sum(len(i.indices) for i in th.instances) \
        - ts.geometry.num_triangles
    # the foliage card drops its TRANSPARENT triangles, below the fused
    # tier's 2048
    assert dropped == (1193 if name == "leaf_grid" else 0)
    np.testing.assert_array_equal(ts.tri_opacity.numpy(),
                                  np.asarray(js.tri_opacity))
    np.testing.assert_array_equal(ts.tri_micromap.numpy(),
                                  np.asarray(js.tri_micromap))
    np.testing.assert_array_equal(ts.bvh.tri_micro.numpy(),
                                  np.asarray(js.bvh.tri_micro))
    if ts.bounce_tables is not None:
        assert ts.bounce_tables.omm and js.bounce_tables.omm
        np.testing.assert_array_equal(ts.bounce_tables.tri_rows.numpy(),
                                      np.asarray(js.bounce_tables.tri_rows))
        return
    ct, jt = ts.cluster_tables, js.cluster_tables
    assert ct.omm and jt.omm
    blocks, word, cov = TCL.omm_blocks_to_port(np.asarray(jt.blocks))
    np.testing.assert_array_equal(ct.blocks.numpy(), blocks)
    np.testing.assert_array_equal(ct.omm_word.numpy(), word)
    np.testing.assert_array_equal(ct.omm_cov.numpy(), cov)


# ---------------------------------------------------------------------------
# (c) the queries
# ---------------------------------------------------------------------------


def _rays(n=4096):
    rs = np.random.default_rng(5)
    o = np.column_stack([rs.uniform(0.05, 0.95, n), rs.uniform(0.05, 0.95, n),
                         np.full(n, 0.95)]).astype(np.float32)
    d = np.column_stack([rs.uniform(-0.3, 0.3, n), rs.uniform(-0.3, 0.3, n),
                         -np.ones(n)])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("path", ["brute", "walk"])
def test_alpha_queries_match_jax(scenes, path, monkeypatch):
    if path == "brute":
        jh, js, th, ts = scenes("curtain")
        assert ts.bvh.brute is not None
    else:
        monkeypatch.setattr(jbrute, "BRUTE_MAX_TRIS", 16)
        monkeypatch.setattr(tbrute, "BRUTE_MAX_TRIS", 16)
        jh, th = (f() for f in HOSTS["grid"])
        js, ts = j_prepare(jh), prepare(th, device="cpu")
        assert ts.bvh.brute is None and js.bvh.brute is None
    o, d = _rays()
    n = len(o)
    tmax = np.full(n, 10.0, np.float32)
    # jitted, the JAX query compiles once instead of op by op; its
    # intersect_any_alpha is ~intersect_closest_alpha(...).miss, so the
    # occlusion below reuses the same compile
    closest = jax.jit(lambda *q: JO.intersect_closest_alpha(js, *q))
    want = closest(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n),
                   jnp.asarray(tmax))
    got = TO.intersect_closest_alpha(ts, torch.tensor(o), torch.tensor(d),
                                     torch.zeros(n), torch.tensor(tmax))
    wp, gp = np.asarray(want.prim), got.prim.numpy()
    same = (gp == wp) & np.isclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=1e-5, atol=1e-5)
    assert same.mean() >= 0.999, same.mean()
    # the retrace and the walk's test did work: rays that pass the curtain
    # (z = 0.5) through its cutouts reach the back wall
    curtain = ts.tri_opacity.numpy() == TO.MIXED
    through = (gp >= 0) & ~curtain[np.maximum(gp, 0)]
    assert 0.2 < through.mean() < 0.8, through.mean()
    short = np.full(n, 0.6, np.float32)            # just past the curtain
    occ_w = ~np.asarray(closest(jnp.asarray(o), jnp.asarray(d),
                                jnp.zeros(n), jnp.asarray(short)).miss)
    occ_g = TO.intersect_any_alpha(ts, torch.tensor(o), torch.tensor(d),
                                   torch.zeros(n), torch.tensor(short))
    assert (occ_g.numpy() == occ_w).mean() >= 0.999
    assert 0.2 < occ_w.mean() < 0.8


# ---------------------------------------------------------------------------
# (d) the general tier, (e) the cutout
# ---------------------------------------------------------------------------


def test_general_tier_render_matches_jax(scenes):
    jh, js, th, ts = scenes("curtain")
    w = h = 16
    kw = dict(max_bounces=2, kernel_tier="xla")
    want = jint.render_sample(js, JP.default_camera(jh, w, h),
                              JConfig(**kw), w, h, jnp.uint32(SAMPLE))
    got = tint.render_sample(ts, TP.default_camera(th, w, h), TConfig(**kw),
                             w, h, SAMPLE)
    a, b = np.asarray(want["L"]), got["L"].numpy()
    assert np.isfinite(b).all() and b.mean() > 0.01
    close = np.isclose(b, a, rtol=TOL, atol=TOL).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())
    assert int(got["ray_count"]) == int(want["ray_count"])
    np.testing.assert_array_equal(got["occupancy"].numpy(),
                                  np.asarray(want["occupancy"]))


@pytest.mark.parametrize("tier", ["torch", "xla"])
def test_cutout_lets_light_through(scenes, tier):
    """tests/test_omm_alpha.py:68-86 in the port: the cut-out curtain's
    image differs from the solid curtain's by more than 0.01 in mean
    absolute value."""
    _, _, th, ts = scenes("curtain")
    solid = TP.curtain_cornell(False)
    ss = prepare(solid, device="cpu")
    assert ss.tri_opacity is None          # every triangle OPAQUE
    cfg = TConfig(max_bounces=2, stochastic_texture_filtering=True,
                  kernel_tier="auto" if tier == "torch" else "xla")
    assert dispatch.resolve(ts, cfg, "cpu").kernel_tier == tier
    cam = TP.default_camera(th, 16, 16)
    a = tint.render(ts, cam, cfg, 16, 16, spp=2)[0].numpy()
    b = tint.render(ss, cam, cfg, 16, 16, spp=2)[0].numpy()
    assert np.isfinite(a).all()
    assert np.abs(a - b).mean() > 0.01


# ---------------------------------------------------------------------------
# (f) dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stf", [True, False])
@pytest.mark.parametrize("name", ["curtain", "grid"])
def test_resolve_matches_jax(scenes, name, stf, monkeypatch):
    """Under "auto" both packages pick the same tier (the JAX package
    considers its kernel tiers on the CPU in interpret mode only): a
    kernel tier with stochastic filtering, the general tier without; a
    pinned kernel tier without it raises, naming the reason."""
    jh, js, th, ts = scenes(name)
    monkeypatch.setenv("RTXPT_TPU_PALLAS_INTERPRET", "1")
    want = jdispatch.resolve(js, JConfig(stochastic_texture_filtering=stf))
    got = dispatch.resolve(ts, TConfig(stochastic_texture_filtering=stf),
                           "cuda")
    assert got.kernel_tier == want.kernel_tier
    pinned = "fused" if name == "curtain" else "clustered"
    assert got.kernel_tier == (pinned if stf else "xla")
    if not stf:
        with pytest.raises(NotImplementedError,
                           match="stochastic texture filtering"):
            dispatch.resolve(ts, TConfig(kernel_tier=pinned), "cpu")

"""The 'Bistro' stress scene (procedural.bistro_scene: textures, a normal
map, alpha-tested foliage, glass with nested priority 1 and more than 128
lights) in rtxpt_tpu_torch against the JAX package, on the CPU.

  (c) The scene: `bistro_scene(30_000, n_bulbs=150)` and
      `bistro_scene(15_000, n_bulbs=40, with_env=True)` equal to the JAX
      package's, host arrays and prepared tables alike: the cluster
      tables (the JAX 7-slot micromap blocks as the port's 4-slot blocks
      and side table), the micromaps, the light count and the priority
      flag.
  (d) One small render (15k budget, 150 bulbs, 32 x 24, 3 bounces, power
      NEE, stochastic texture filtering): the port's general tier against
      the JAX `render_sample` (the call of tests/test_bistro.py, which the
      JAX package resolves to its general tier on the CPU unless its
      interpret switch is set; pinned to that tier here, since another
      test module in the same process may set it): >= 99% of the
      pixels within 2e-3 and the means within 1e-3 relative, ray counts
      equal. The port's clustered tier takes the external-NEE route (301
      lights: 150 two-triangle bulbs and the sun) with K3's and K5's
      micromap variants and K4's omm_tex_prio variant; the JAX clustered
      route cannot be compared (F8). Its image is not held to the cross-tier bound of
      tests/test_cluster.py (RMSE < 2e-2, means within 5e-3): on this
      frame the JAX general tier's shadow rays find their own sampled
      bulb before the shadow distance on 8-9% of the requests (F10 in
      ROADMAP: the distance subtracts the ray offset's projection on the
      light direction, while the offset moves the origin along the
      surface normal), where the clustered tier's K5 does not, and the
      bulbs' radiance of 420 makes each such lane a large pixel error.
      The route is held lane by lane instead: at bounce 0 the clustered
      tier's K5 occlusion of the external route's requests equals the
      general tier's any-hit query on every request but those whose
      general-tier occluder is the sampled emitter itself and those whose
      first geometric hit is a MIXED foliage triangle (K5 tests the baked
      coverage against the alpha uniform, the general tier the texture's
      alpha: the micromap kernels against the alpha retrace); the bounce-0
      query overflows its cull lists at the default pages (F7) and not at
      ceil(clusters / kslots) pages; the frame renders finite and lit at
      the default pages (one bounce and the two pass-through rounds, to
      keep the plain K3 / K5 cheap).
  (e) `resolve` equal to the JAX package's on the Bistro scenes, with and
      without stochastic texture filtering (textures, micromaps,
      priorities, more than 128 lights; with the environment).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import dispatch as jdispatch
from rtxpt_tpu.pt.integrator import render_sample as j_render_sample
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel import cluster as TCL
from rtxpt_tpu_torch.accel.traverse import intersect_closest
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import (
    _pixel_grid, camera_rays, render_sample)
from rtxpt_tpu_torch.pt.nee_external import external_nee
from rtxpt_tpu_torch.scene import omm as TO
from rtxpt_tpu_torch.scene import procedural as TP

CONFIGS = {"30k": dict(tri_budget=30_000, n_bulbs=150),
           "15k_env": dict(tri_budget=15_000, n_bulbs=40, with_env=True)}
RENDER = dict(tri_budget=15_000, n_bulbs=150)
FRAME = (32, 24)
BOUNCES = 3
SAMPLE = 1
TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bistro():
    cache = {}

    def get(name):
        if name not in cache:
            kw = RENDER if name == "render" else CONFIGS[name]
            jh, th = JP.bistro_scene(**kw), TP.bistro_scene(**kw)
            cache[name] = (jh, j_prepare(jh), th, prepare(th, device="cpu"))
        return cache[name]
    return get


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# (c) the scene
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bistro_host_matches_jax(bistro, name):
    jh, _, th, _ = bistro(name)
    assert len(jh.instances) == len(th.instances) == 18
    for ji, ti in zip(jh.instances, th.instances):
        assert ji.name == ti.name
        for f in ("positions", "normals", "uvs", "indices", "material",
                  "transform"):
            np.testing.assert_array_equal(_np(getattr(ti, f)),
                                          _np(getattr(ji, f)), err_msg=f)
    for f in ("base_color", "metallic", "roughness", "ior", "transmission",
              "diffuse_transmission", "emissive", "specular_f0_scale",
              "thin", "alpha_cutoff", "volume_absorption", "base_color_tex",
              "emissive_tex", "metal_rough_tex", "normal_tex",
              "nested_priority"):
        np.testing.assert_array_equal(_np(getattr(th.materials, f)),
                                      _np(getattr(jh.materials, f)),
                                      err_msg=f)
    assert _np(th.materials.nested_priority)[TP.BISTRO_GLASS] == 1
    assert len(th.textures) == len(jh.textures) == 5
    for a, b in zip(th.textures, jh.textures):
        np.testing.assert_array_equal(a, b)
    for f in ("kind", "position", "direction", "intensity", "angular_size",
              "cos_inner", "cos_outer"):
        np.testing.assert_array_equal(_np(getattr(th.analytic_lights, f)),
                                      _np(getattr(jh.analytic_lights, f)),
                                      err_msg=f)
    assert th.camera == jh.camera
    if jh.envmap_image is None:
        assert th.envmap_image is None
    else:
        np.testing.assert_array_equal(th.envmap_image, jh.envmap_image)
        assert th.envmap_scale == jh.envmap_scale


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bistro_prepare_matches_jax(bistro, name):
    _, js, th, ts = bistro(name)
    assert ts.tlas is None and ts.bounce_tables is None   # flattened
    assert ts.has_nested_priorities and js.has_nested_priorities
    assert ts.lights.count == int(np.asarray(js.lights.count))
    assert ts.lights.count > (128 if name == "30k" else 80)
    for f in ("indices", "tri_material"):
        np.testing.assert_array_equal(getattr(ts.geometry, f).numpy(),
                                      np.asarray(getattr(js.geometry, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(ts.tri_opacity.numpy(),
                                  np.asarray(js.tri_opacity))
    np.testing.assert_array_equal(ts.tri_micromap.numpy(),
                                  np.asarray(js.tri_micromap))
    ct, jt = ts.cluster_tables, js.cluster_tables
    assert ct.omm and jt.omm
    assert (ct.n_clusters, ct.n_tris, ct.n_lights) == \
        (jt.n_clusters, jt.n_tris, jt.n_lights)
    blocks, word, cov = TCL.omm_blocks_to_port(np.asarray(jt.blocks))
    np.testing.assert_array_equal(ct.blocks.numpy(), blocks)
    np.testing.assert_array_equal(ct.omm_word.numpy(), word)
    np.testing.assert_array_equal(ct.omm_cov.numpy(), cov)
    for f in ("aabb_lo", "aabb_hi", "mat_rows", "light_rows", "offsets"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert (ct.env is not None) == (name == "15k_env")


# ---------------------------------------------------------------------------
# (d) a small render
# ---------------------------------------------------------------------------


def _cfg(**kw):
    return PathTracerConfig(max_bounces=BOUNCES, nee=NEEMode.POWER,
                            stochastic_texture_filtering=True, **kw)


@pytest.fixture(scope="module")
def jax_image(bistro):
    jh, js, _, _ = bistro("render")
    cfg = JConfig(max_bounces=BOUNCES, nee=JNEE.POWER,
                  stochastic_texture_filtering=True, kernel_tier="xla")
    w, h = FRAME
    out = j_render_sample(js, JP.default_camera(jh, w, h), cfg, w, h,
                          jnp.uint32(SAMPLE))
    return np.asarray(out["L"]).reshape(h, w, 3), int(out["ray_count"])


def test_bistro_general_tier_matches_jax(bistro, jax_image):
    _, _, th, ts = bistro("render")
    want, want_rays = jax_image
    w, h = FRAME
    cfg = _cfg(kernel_tier="xla")
    kernels.launches.clear()
    got = render_sample(ts, TP.default_camera(th, w, h), cfg, w, h, SAMPLE)
    assert not kernels.launches
    img = got["L"].numpy().reshape(h, w, 3)
    assert np.isfinite(img).all() and img.mean() > 1e-3
    close = np.isclose(img, want, rtol=TOL, atol=TOL).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    assert int(got["ray_count"]) == want_rays


def test_bistro_clustered_external_route(bistro):
    """The external route's bounce 0 on 32 x 32 camera rays (one group),
    lane by lane against the general tier's shadow query, then the frame
    at the default pages and at overflow-free ones."""
    _, _, th, ts = bistro("render")
    cfg = dispatch.resolve(ts, _cfg(), "cpu")
    tbl = ts.cluster_tables
    assert cfg.kernel_tier == "clustered" and cfg.nee_external
    free = -(-tbl.n_clusters // cfg.cluster_kslots)
    assert cfg.cluster_pages < free
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == 5 and bf.use_tex(tbl, kcfg) and tbl.omm
    cam = TP.default_camera(th, 32, 32)
    px, py = _pixel_grid(32, 32)
    o, d, spread = camera_rays(cam, cfg, px, py, SAMPLE)
    fs, is_ = bf.initial_state(o, d, spread, px, py)
    _, ovf = BC.closest_paged(fs, is_, tbl, cfg.cluster_kslots,
                              cfg.cluster_pages, float(cfg.max_ray_travel),
                              omm=True)
    assert int(ovf) > 0
    ha, ovf = BC.closest_paged(fs, is_, tbl, cfg.cluster_kslots, free,
                               float(cfg.max_ray_travel), omm=True)
    assert int(ovf) == 0
    fs2, is2, _, hitb, surf = BC.shade(ha, fs, is_, tbl, kcfg, SAMPLE,
                                       omm=True, prio=True)
    res = external_nee(ts, cfg, None, surf, fs[bf.FS_D:bf.FS_D + 3],
                       hitb[5] > 0.5, fs[bf.FS_PREVPDF],
                       is_[bf.IS_PREVDELTA] > 0, px, py, SAMPLE, 0,
                       lb=is_[bf.IS_LBOUNCE])
    ua = bf.alpha_uniform(cfg, px, py, is_[bf.IS_LBOUNCE], SAMPLE)
    n = fs.shape[1]
    sh = torch.cat([res["shadow_o"].T, res["shadow_d"].T, res["sdist"][None],
                    res["contrib"].T, res["do_nee"].to(torch.float32)[None],
                    torch.zeros((BC.SH_UA - BC.SH_CDIFF, n)), ua[None]])
    occ, _ = BC.occluded_paged(sh, tbl, cfg.cluster_kslots, free, omm=True)
    do = res["do_nee"]
    assert do.float().mean() > 0.2
    # the general tier's shadow query on the same requests, and the
    # triangle it stops at
    args = (res["shadow_o"], res["shadow_d"], torch.zeros(n), res["sdist"])
    occ_g = TO.intersect_any_alpha(ts, *args)
    first = TO.intersect_closest_alpha(ts, *args)
    own = ~first.miss & (ts.lights.tri_light[
        torch.clamp(first.prim, min=0).long()].long() == res["li"].long())
    geo = intersect_closest(ts.bvh.replace(tri_micro=None), *args)
    alpha = ~geo.miss & (ts.tri_opacity[
        torch.clamp(geo.prim, min=0).long()] == TO.MIXED)
    differ = do & ((occ > 0.5) != occ_g)
    assert not (differ & ~own & ~alpha).any(), int(
        (differ & ~own & ~alpha).sum())
    # the general tier stopped at the sampled bulb, before the shadow
    # distance, on some lanes that K5 leaves unoccluded (F10)
    f10 = differ & own & ~alpha
    assert (occ_g & ~(occ > 0.5))[f10].all()
    assert 0 < int(f10.sum()) < 0.2 * int(do.sum())

    # the frame: K3 / K5 micromap variants, K4 omm_tex_prio (plain
    # versions here), the pass-through rounds
    w, h = FRAME
    fcfg = PathTracerConfig(max_bounces=1, nee=NEEMode.POWER,
                            stochastic_texture_filtering=True)
    got = render_sample(ts, TP.default_camera(th, w, h), fcfg, w, h, SAMPLE)
    img = got["L"].numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-3
    assert len(got["occupancy"]) == 1 + 2 + 1
    assert int(got["cull_overflow"]) > 0


# ---------------------------------------------------------------------------
# (e) resolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stf", [True, False])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_bistro_resolve_matches_jax(bistro, name, stf, monkeypatch):
    """Both packages serve Bistro on the clustered tier with stochastic
    texture filtering (the external route past 128 lights) and on the
    general tier without it; the JAX package considers its kernel tiers
    on the CPU in interpret mode only."""
    _, js, _, ts = bistro(name)
    monkeypatch.setenv("RTXPT_TPU_PALLAS_INTERPRET", "1")
    want = jdispatch.resolve(js, JConfig(stochastic_texture_filtering=stf))
    got = dispatch.resolve(ts, PathTracerConfig(
        stochastic_texture_filtering=stf), "cuda")
    assert got.kernel_tier == want.kernel_tier == \
        ("clustered" if stf else "xla")
    assert got.nee_external == (stf and name == "30k")
    if stf:
        assert bool(want.nee_external) == got.nee_external
    if not stf:
        with pytest.raises(NotImplementedError,
                           match="stochastic texture filtering"):
            dispatch.resolve(ts, PathTracerConfig(kernel_tier="clustered"),
                             "cpu")

"""The clustered tier's texture switch against the JAX package, on the
CPU: the same numpy-seeded inputs through both packages, the JAX side as
its own tests run it (Pallas kernels in interpret mode), on the textured,
normal-mapped sky city (city_scene(4000, seed=1, blocks=2, textured=True,
normal_mapped=True, with_env=True): checker ground and facades, the ripple
normal map on the ground, tex_maps (1, 0, 0, 1)).

  (a) K4's plain texture switch (nee slot 2, the environment table,
      stochastic filtering) against `_kernel_a2_call` on the same
      2,048-lane HA rows (the port's K3 output) at bounces 0 and 1, the
      state carried by the JAX kernel: integer rows equal on >= 99.5% of
      lanes, float rows within rtol = atol = 2e-3.
  (b) K4 in nee slot 3 (NEE-AT's export): the SF_* rows and the next
      state against the JAX package's own `surface_and_shade` on the same
      HA rows, which `_kernel_a2` calls but whose export it never stores
      (ROADMAP F8), within 2e-3.
  (c) the city at 48x32, 1 spp, 2 bounces, on the clustered tier of both
      packages with stochastic filtering. The JAX tier carries the ray
      cone and spread through its sort as a bf16 pair (F4,
      bounce_clustered.py:659-668, about 2^-8 relative); the port keeps
      f32. The cone sets the MIP level floor(mip + ju0), which moves to a
      neighbouring level where mip + ju0 lies within the rounding of an
      integer: the port's image holds >= 97% of its pixels within 2e-3
      and its mean within 2e-3 relative. With the port's cone rounded
      through bf16 at each sort as the JAX tier does (in this test only)
      the levels agree: every pixel within 2e-3, the mean within 1e-4
      relative. Both hold with ray counts, occupancy and cull overflow
      equal. (On this frame no fetch changed level: both images agree
      with the JAX one to 2.1e-5; the wide 48x32 cones keep the ground
      at MIP 0.)
  (d) instanced cluster tables of a textured two-level city carry the
      JAX package's texture tables, resolve to the clustered tier with
      stochastic filtering and render through the texture switch.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import NEEMode as TNEE
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP

TOL = 2e-3
INT_LANES = 0.995
KSLOTS = 64
SAMPLE = 1
BOUNCES = 2
W, H = 48, 32             # the render's frame: 1,536 rays, 2,048 lanes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _city(mod):
    return mod.city_scene(tri_budget=4000, seed=1, blocks=2, textured=True,
                          normal_mapped=True, with_env=True)


@pytest.fixture(scope="module")
def city():
    jh, th = _city(JP), _city(TP)
    return jh, j_prepare(jh), th, prepare(th, device="cpu")


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _tiles(x):
    return jnp.asarray(x.reshape(x.shape[0], -1, 128))


def _rows(x):
    return np.asarray(x).reshape(x.shape[0], -1)


def _hit_rows(scene, fs, is_):
    """K3's plain version on the wavefront (one page)."""
    ha, _ = BC.closest_paged(torch.tensor(fs), torch.tensor(is_),
                             scene.cluster_tables, KSLOTS, 1, 1e27)
    return ha.numpy()


def _camera_state():
    """2,048 camera rays looking down on the blocks: they hit the
    textured ground and facades, the emitters, and the sky."""
    aimed = _city(TP)
    aimed.camera = dict(position=[10.0, 12.0, 26.0], target=[10.0, 2.0, 8.0],
                        up=[0.0, 1.0, 0.0], fov_y_deg=60.0)
    cam = TP.default_camera(aimed, 64, 32)
    px, py = _pixel_grid(64, 32)
    o, d, spread = camera_rays(cam, TConfig(), px, py, SAMPLE)
    return tuple(x.numpy() for x in bf.initial_state(o, d, spread, px, py))


def _cfgs(nee="POWER", **kw):
    """The same PathTracerConfig in the JAX package and in the port."""
    kw = dict(max_bounces=BOUNCES, stochastic_texture_filtering=True, **kw)
    return JConfig(nee=JNEE[nee], **kw), TConfig(nee=TNEE[nee], **kw)


@pytest.fixture(scope="module")
def k4_steps(city):
    """The JAX K4 (nee slot 2, environment, textures) at bounces 0 and 1
    on the port K3's hit rows. The calls carry the keywords of the JAX
    clustered tier's (bounce_clustered.py:1821-1829) and the render's
    wavefront shape, so that the render below finds them in jit's
    cache."""
    jh, js, th, ts = city
    jt = js.cluster_tables
    assert jt.tex_ct is not None and jt.tex_maps == (1, 0, 0, 1)
    cfg, _ = _cfgs()
    key = bp._cfg_key(cfg)
    fs, is_ = _camera_state()
    steps = []
    for b in range(BOUNCES):
        ha = _hit_rows(ts, fs, is_)
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        out = JBC._kernel_a2_call(
            scal, _tiles(ha), _tiles(fs), _tiles(is_), jt.mat_rows,
            jt.light_rows, jt.env_rows, jt.tex_ct, jt.tex_meta, key,
            jt.n_lights, jt.tr, True, tex_maps=jt.tex_maps, interpret=True,
            fs2=None, prio=False, omm=False, maxb=None)
        outs = tuple(_rows(x) for x in out[:4])
        steps.append(dict(fs=fs, is_=is_, ha=ha, out=outs))
        fs, is_ = outs[0], outs[1]
    return steps


@pytest.mark.parametrize("bounce", [0, 1])
def test_k4_texture_switch_matches_pallas_kernel(city, k4_steps, bounce):
    _, js, _, ts = city
    s = k4_steps[bounce]
    tables = ts.cluster_tables
    assert tables.tex_maps == (1, 0, 0, 1) and tables.env is not None
    mine = bf.tex_tables(np.asarray(js.cluster_tables.tex_ct),
                         np.asarray(js.cluster_tables.tex_meta))
    np.testing.assert_array_equal(tables.tex.numpy(), mine[0])
    np.testing.assert_array_equal(tables.tex_meta.numpy(), mine[1])
    _, cfg = _cfgs()
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert bf.use_tex(tables, kcfg) and kcfg.nee_mode == 2
    before = dict(kernels.launches)
    out = [x.numpy() for x in BC.shade(
        torch.tensor(s["ha"]), torch.tensor(s["fs"]), torch.tensor(s["is_"]),
        tables, kcfg, SAMPLE)]
    assert dict(kernels.launches) == before
    jfs, jis, jsh, jhit = s["out"]
    tfs, tis, tsh, thit = out
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) \
        & (tsh[BC.SH_DO] == jsh[BC.SH_DO])
    assert same.mean() >= INT_LANES, same.mean()
    for name, a, c in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit)):
        _close(a[:, same], c[:, same], TOL, name)
    # the textures reached the shading: the ground (material 0) lanes hit
    ground = (s["ha"][BC.HA_PRIM] >= 0) \
        & (s["ha"][BC.HA_ATTR + bf.AT_MID] == 0)
    assert ground.sum() > 50


def _jax_export_body(key, n_lights, tr, tex_maps):
    """The next state and the SF_* rows that `_kernel_a2` computes
    (bounce_pallas.surface_and_shade on the HA rows with the texture and
    environment tables, bounce_clustered.py:546-561), jitted once per
    configuration."""
    def body(ha, fs, is_, sample, bounce, mat, light, env, tex_ct,
             tex_meta):
        def attr(i, k=1):
            return ha[JBC.HA_ATTR + i] if k == 1 else \
                ha[JBC.HA_ATTR + i:JBC.HA_ATTR + i + k]
        t = ha[JBC.HA_T]
        s = bp.surface_and_shade(
            o=fs[0:3], d=fs[3:6], t=t, hit=t < bp._BIG,
            front=ha[JBC.HA_FRONT] > 0.0, bu=ha[JBC.HA_U], bv=ha[JBC.HA_V],
            attr=attr, thp=fs[6:9], L=fs[9:12], prev_pdf=fs[12],
            active=is_[0] > 0, prev_delta=is_[1] > 0, med0=is_[2],
            med1=is_[3], px=is_[4], py=is_[5], sample_idx=sample,
            bounce=bounce, mat_ref=mat, light_ref=light, cfg_key=key,
            n_lights=n_lights, first_emissive=True, env_ref=env,
            tex_refs=(tex_ct, tex_meta, tr), tex_maps=tex_maps,
            cone=fs[13], spread=fs[14], budget=is_[6], lbounce=is_[7])
        return s["surf"], jnp.concatenate(
            [s["o_new"], s["wi_world"], s["thp"], s["L"], s["prev_pdf"][None],
             s["cone"][None], s["spread"][None]])
    return jax.jit(body)


@pytest.fixture(scope="module")
def jax_export(city):
    jt = city[1].cluster_tables
    jcfg, _ = _cfgs(nee="NEEAT")
    key = bp._cfg_key(jcfg)
    assert key[0] == 3
    fn = _jax_export_body(key, jt.n_lights, jt.tr, jt.tex_maps)

    def run(ha, fs, is_, bounce):
        surf, fs_out = fn(_tiles(ha), _tiles(fs), _tiles(is_),
                          jnp.uint32(SAMPLE), jnp.int32(bounce), jt.mat_rows,
                          jt.light_rows, jt.env_rows, jt.tex_ct, jt.tex_meta)
        return _rows(surf), _rows(fs_out)
    return run


@pytest.mark.parametrize("bounce", [0, 1])
def test_k4_export_matches_jax_surface_and_shade(city, k4_steps, jax_export,
                                                 bounce):
    """K4 in slot 3 on the textured city: the SF_* rows (the textured
    base colour among them) and the next state."""
    ts = city[3]
    s = k4_steps[bounce]
    _, cfg = _cfgs(nee="NEEAT")
    surf_j, fs_j = jax_export(s["ha"], s["fs"], s["is_"], bounce)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    out = [x.numpy() for x in BC.shade(
        torch.tensor(s["ha"]), torch.tensor(s["fs"]), torch.tensor(s["is_"]),
        ts.cluster_tables, kcfg, SAMPLE)]
    assert len(out) == 5
    shaded = out[3][5] > 0.5
    assert shaded.mean() > 0.1
    _close(out[4][:, shaded], surf_j[:, shaded], TOL, "SF rows")
    # the rows the state carries without the NEE add (the export route
    # adds NEE outside the kernel)
    for r in range(bf.NF):
        if bf.FS_L <= r < bf.FS_L + 3:
            continue
        _close(out[0][r][shaded], fs_j[r][shaded], TOL, f"fs row {r}")
    ground = shaded & (out[4][bf.SF_MID] == 0)
    assert ground.sum() > 20
    # the checker: more than one base colour on the one ground material
    assert len(np.unique(out[4][bf.SF_BASE][ground].round(3))) > 1


@pytest.fixture(scope="module")
def jax_render(city, k4_steps):
    jh, js, _, _ = city
    jcfg, _ = _cfgs(kernel_tier="clustered", pallas_interpret=True,
                    cluster_kslots=KSLOTS, cluster_pages=2)
    mp = pytest.MonkeyPatch()
    mp.setattr(JBC, "_SCAN", False)
    try:
        return jint.render_sample(js, JP.default_camera(jh, W, H), jcfg, W,
                                  H, jnp.uint32(SAMPLE))
    finally:
        mp.undo()


def _bf16_sort(sort):
    """sort_wavefront with the cone and spread rounded through bf16, as
    the JAX tier's sort carries them."""
    def sort_bf16(fs, is_, src, first, bounds):
        fs, is_, src = sort(fs, is_, src, first, bounds)
        fs = fs.clone()
        rows = slice(bf.FS_CONE, bf.FS_SPREAD + 1)
        fs[rows] = fs[rows].to(torch.bfloat16).to(torch.float32)
        return fs, is_, src
    return sort_bf16


@pytest.mark.parametrize("cone", ["f32", "bf16"])
def test_textured_city_render_matches_jax_clustered_tier(city, jax_render,
                                                         cone, monkeypatch):
    jh, js, th, ts = city
    if cone == "bf16":
        monkeypatch.setattr(BC, "sort_wavefront",
                            _bf16_sort(BC.sort_wavefront))
    _, cfg = _cfgs()
    kernels.launches.clear()
    out = tint.render_sample(ts, TP.default_camera(th, W, H), cfg, W, H,
                             SAMPLE)
    assert not kernels.launches
    assert out["kernel_tier"] == "clustered"
    a, b = np.asarray(jax_render["L"]), out["L"].numpy()
    assert np.isfinite(b).all() and b.mean() > 0.01
    close = np.isclose(b, a, rtol=TOL, atol=TOL).all(-1)
    rel = abs(b.mean() - a.mean()) / abs(a.mean())
    if cone == "f32":
        # F4: the JAX tier's bf16 cone moves some fetches to a
        # neighbouring MIP level after bounce 0
        assert close.mean() >= 0.97, close.mean()
        assert rel <= 2e-3, rel
    else:
        assert close.all(), close.mean()
        assert rel <= 1e-4, rel
    assert int(out["ray_count"]) == int(jax_render["ray_count"])
    np.testing.assert_array_equal(out["occupancy"].numpy(),
                                  np.asarray(jax_render["occupancy"]))
    assert int(out["cull_overflow"]) == int(jax_render["cull_overflow"])


def _textured(host, mod):
    """The instanced city with the checker on the towers and the ripple
    normal map on the floor."""
    host.textures = [mod.checker_texture(64), mod.ripple_normal_texture(64)]
    ids = (jnp.asarray if mod is JP else torch.as_tensor)
    host.materials = host.materials.replace(
        base_color_tex=ids(np.asarray([0, -1], np.int32)),
        normal_tex=ids(np.asarray([-1, 1], np.int32)))
    return host


def _jax_instanced_city():
    """The JAX package's test construction (tests/test_cluster_instanced.py
    `_instanced_city`, which procedural.instanced_city equals at grid 2).
    Importing that module sets RTXPT_TPU_PALLAS_INTERPRET, which would
    change the JAX tier of later tests in this process: the environment
    is restored."""
    env = dict(os.environ)
    try:
        import test_cluster_instanced
    finally:
        os.environ.clear()
        os.environ.update(env)
    return test_cluster_instanced._instanced_city(grid=2, subdiv=6)


def test_textured_instanced_tables_resolve_and_render():
    jh = _textured(_jax_instanced_city(), JP)
    th = _textured(TP.instanced_city(grid=2, subdiv=6), TP)
    jt = j_prepare(jh).cluster_tables
    scene = prepare(th, device="cpu")
    tables = scene.cluster_tables
    assert tables.instanced and tables.tex_maps == jt.tex_maps == (1, 0, 0, 1)
    mine = bf.tex_tables(np.asarray(jt.tex_ct), np.asarray(jt.tex_meta))
    np.testing.assert_array_equal(tables.tex.numpy(), mine[0])
    np.testing.assert_array_equal(tables.tex_meta.numpy(), mine[1])
    cfg = TConfig(max_bounces=2, stochastic_texture_filtering=True)
    assert dispatch.resolve(scene, cfg, "cpu").kernel_tier == "clustered"
    assert dispatch.resolve(scene, dataclasses.replace(
        cfg, stochastic_texture_filtering=False), "cpu").kernel_tier == "xla"
    w = h = 16
    cam = TP.default_camera(th, w, h)
    img, _, rays = tint.render(scene, cam, cfg, w, h, spp=1)
    assert torch.isfinite(img).all() and rays > w * h
    flat = prepare(TP.instanced_city(grid=2, subdiv=6), device="cpu")
    base, _, _ = tint.render(flat, cam, cfg, w, h, spp=1)
    assert float((img - base).abs().max()) > 0.02

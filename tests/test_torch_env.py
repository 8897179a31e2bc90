"""Environment lighting in the port against the JAX package, on the CPU:
the same numpy-seeded inputs through both packages, the JAX side as its
own tests run it (Pallas kernels in interpret mode).

  (a) `bake_envmap` of make_sky(64, 32) and of a seeded random image with
      a rotation: every field within 1e-6 (they agree exactly).
  (b) `env_eval`, `env_pdf` and `env_sample` on 4,096 seeded directions
      and uniforms: texels equal, floats within 1e-5.
  (c) `make_sky` equal to the JAX package's.
  (d) `bake_lights` with an environment light, with env_quads = 8 and
      with a sphere light: fields equal; `sample_light` for each kind,
      `eval_light_sample`, `env_select_pdf`, `env_quad_of_dir` and
      `env_dir_pdf` within 1e-5.
  (e) K1's plain version with the environment table against
      `_bounce_call` at 1,024 lanes, bounces 0 and 1 and the final_env
      launch: integer rows equal on >= 99.5% of lanes, float rows within
      rtol = atol = 2e-3 (tests/test_torch_nee_external.py (b)).
  (g) renders against the same tier of the JAX package, every pixel
      within 2e-3, means within 1e-4 relative, ray counts equal: Cornell
      + make_sky(64, 32) on the fused tier ("torch" on the CPU), and on
      the general tier ("xla") the sky-lit triangle of
      tests/test_sky_env.py, the sphere-light triangle and env_quads = 4
      under NEE-AT (one bounce).
Resolution: the tier each scene resolves to, as in the JAX package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.lighting import envmap as JE
from rtxpt_tpu.lighting import lights_baker as JL
from rtxpt_tpu.lighting.sky import make_sky as j_make_sky
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.pt.integrator import EFFECT_LENS, _lds, _pixel_grid
from rtxpt_tpu.pt.restir import eval_light_sample as j_eval_light_sample
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.scene.camera import camera_ray
from rtxpt_tpu.utils import rng as jrng
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.apps import cli
from rtxpt_tpu_torch.config import NEEMode as TNEE
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.lighting import envmap as TE
from rtxpt_tpu_torch.lighting import lights_baker as TL
from rtxpt_tpu_torch.lighting import neeat as tna
from rtxpt_tpu_torch.lighting.sky import make_sky
from rtxpt_tpu_torch.prepare import prepare, scene_from_numpy
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.pt.restir import eval_light_sample
from rtxpt_tpu_torch.scene import procedural as TP

SIDE = 32                      # 1,024 camera rays, K1's wavefront
SAMPLE = 3
BOUNCES = 2
INT_LANES = 0.995
TOL = 2e-3
FIELD_TOL = 1e-5
LIGHT_FIELDS = ("kind", "p0", "p1", "p2", "emission", "extra", "normal",
                "power", "cdf", "tri_light", "env_light", "num",
                "env_quad_grid")
ENV_FIELDS = ("image", "row_cdf", "cond_cdf", "texel_pdf", "cos_rot",
              "sin_rot", "mean_radiance")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _mostly_close(got, want, what):
    """Within FIELD_TOL on >= 99% of the lanes and within TOL on all:
    XLA's CPU code contracts multiplies and adds into FMAs and torch does
    not, and the sphere's 1 - cos_max and 1 - cos^2 near cos = 1 amplify
    that last-bit rounding (15 of 4,096 sphere pdfs differ by 4e-4
    relative)."""
    got, want = _np(got), _np(want)
    ok = np.isclose(got, want, rtol=FIELD_TOL, atol=FIELD_TOL)
    assert ok.reshape(len(ok), -1).all(1).mean() >= 0.99, what
    _close(got, want, TOL, what)


def _port_env(jenv):
    return TE.envmap_from_numpy(**{k: _np(getattr(jenv, k))
                                   for k in ENV_FIELDS}, device="cpu")


def _port_lights(jlights):
    return TL.lights_from_numpy({k: _np(getattr(jlights, k))
                                 for k in LIGHT_FIELDS}, device="cpu")


# ---------------------------------------------------------------------------
# (a)-(c) the environment map and the sky
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(64, 32), (256, 128), (33, 17)])
def test_make_sky_matches_jax(size):
    kw = dict(sun_dir=(0.45, 0.72, -0.3), sun_intensity=40.0)
    np.testing.assert_array_equal(make_sky(*size), j_make_sky(*size))
    np.testing.assert_array_equal(make_sky(*size, bake_sun=False, **kw),
                                  j_make_sky(*size, bake_sun=False, **kw))


def _images():
    rs = np.random.default_rng(21)
    return {"sky": (j_make_sky(64, 32), 0.0, 1.0, None),
            "random_rotated": (rs.exponential(1.0, (16, 32, 3)).astype(
                np.float32), 0.7, 0.5, None),
            "cli_sky_resampled": (j_make_sky(), 0.3, 0.5,
                                  (bf.ENV_H, bf.ENV_W))}


@pytest.fixture(scope="module", params=list(_images()))
def envmaps(request):
    img, rot, scale, res = _images()[request.param]
    return (JE.bake_envmap(img, scale, rot, res=res),
            TE.bake_envmap(img, scale, rot, res=res, device="cpu"))


def test_bake_envmap_matches_jax(envmaps):
    jenv, tenv = envmaps
    for field in ENV_FIELDS:
        np.testing.assert_allclose(_np(getattr(tenv, field)),
                                   _np(getattr(jenv, field)), rtol=0,
                                   atol=1e-6, err_msg=field)
    assert tenv.has_radiance


def test_env_eval_pdf_sample_match_jax(envmaps):
    jenv, tenv = envmaps
    rs = np.random.default_rng(4)
    n = 4096
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u1, u2 = rs.uniform(size=(2, n)).astype(np.float32)
    # texels: the radiance lookup picks the same texel of an image whose
    # texels all differ
    h, w = tenv.shape
    yi, xi = TE._texel(tenv, torch.tensor(d))
    ju, jv = JE._dir_to_uv(jenv, jnp.asarray(d))
    np.testing.assert_array_equal(
        xi.numpy(), np.clip((np.asarray(ju) * w).astype(np.int32), 0, w - 1))
    np.testing.assert_array_equal(
        yi.numpy(), np.clip((np.asarray(jv) * h).astype(np.int32), 0, h - 1))
    _close(TE.env_eval(tenv, torch.tensor(d)), JE.env_eval(jenv, d), 0.0,
           "eval")
    want = np.asarray(JE.env_pdf(jenv, d))
    _close(TE.env_pdf(tenv, torch.tensor(d)) / want.max(), want / want.max(),
           FIELD_TOL, "pdf")
    jd, jrad, jpdf = JE.env_sample(jenv, u1, u2)
    td, trad, tpdf = TE.env_sample(tenv, torch.tensor(u1), torch.tensor(u2))
    _close(trad, jrad, 0.0, "sampled radiance (the same texel)")
    _close(td, jd, FIELD_TOL, "sampled direction")
    _close(tpdf / float(np.max(jpdf)), np.asarray(jpdf) / np.max(jpdf),
           FIELD_TOL, "sampled pdf")


def test_count_le_takes_the_tie_side_of_the_count():
    """The binary search over a CDF returns #{cdf <= u}, ties included."""
    cdf = torch.tensor([0.0, 0.25, 0.25, 0.5, 0.5, 0.5, 1.0])
    u = torch.tensor([0.0, 0.1, 0.25, 0.3, 0.5, 0.9, 0.99999])
    want = (cdf[None] <= u[:, None]).sum(1)
    assert torch.equal(TE.count_le(cdf, u), want)
    rows = cdf[None].repeat(len(u), 1)
    assert torch.equal(TE.count_le(rows, u), want)


# ---------------------------------------------------------------------------
# (d) the light bake and sampling of the environment and sphere kinds
# ---------------------------------------------------------------------------


def _light_host(mod, case):
    if case == "sphere":
        return mod.single_triangle("sphere")
    host = mod.single_triangle("point")
    host.envmap_image = j_make_sky(64, 32)
    host.envmap_rotation = 0.4
    host.env_quad_lights = 8 if case == "quads" else 0
    return host


@pytest.fixture(scope="module", params=["env", "quads", "sphere"])
def light_scenes(request):
    case = request.param
    jscene = j_prepare(_light_host(JP, case))
    tscene = prepare(_light_host(TP, case), device="cpu")
    return case, jscene, tscene


def test_bake_lights_env_kinds_match_jax(light_scenes):
    case, jscene, tscene = light_scenes
    for field in LIGHT_FIELDS:
        want, got = _np(getattr(jscene.lights, field)), \
            _np(getattr(tscene.lights, field))
        if want is None:
            assert got is None, field
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)
    kinds = {"env": TL.KIND_ENV, "quads": TL.KIND_ENVQUAD,
             "sphere": TL.KIND_SPHERE}[case]
    assert kinds in tscene.lights.kinds
    # the same tables as the JAX package: the general tier's only for the
    # kinds it alone samples, the fused tier's with the environment table
    if case == "env":
        env = tscene.bounce_tables.env.numpy()
        np.testing.assert_array_equal(
            env, bf.env_table(np.asarray(jscene.bounce_tables.env_rows)))
    else:
        assert tscene.bounce_tables is None
        assert jscene.bounce_tables is None


def test_sample_light_env_kinds_match_jax(light_scenes):
    case, jscene, tscene = light_scenes
    lights, env = _port_lights(jscene.lights), _port_env(jscene.envmap)
    rs = np.random.default_rng(8)
    n = 4096
    pos = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    u_sel, u1, u2 = rs.uniform(size=(3, n)).astype(np.float32)
    for uniform in (False, True):
        want = JL.sample_light(jscene.lights, jscene.envmap, pos, u_sel, u1,
                               u2, uniform=uniform)
        got = TL.sample_light(lights, env, torch.tensor(pos),
                              torch.tensor(u_sel), torch.tensor(u1),
                              torch.tensor(u2), uniform=uniform)
        for key in ("light_index", "is_delta", "valid"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
        for key in ("wi", "dist", "Li", "pdf"):
            w = np.asarray(want[key])
            scale = max(float(np.abs(w).max()), 1.0) if key == "pdf" else 1.0
            _mostly_close(got[key] / scale, w / scale,
                          f"{key} uniform={uniform}")
    li = rs.integers(0, lights.count, n)
    uv = rs.uniform(size=(n, 2)).astype(np.float32)
    want = j_eval_light_sample(jscene.lights, jscene.envmap, li, uv, pos)
    got = eval_light_sample(lights, env, torch.tensor(li), torch.tensor(uv),
                            torch.tensor(pos))
    for name, a, b in zip(("wi", "dist", "Li", "pdf"), got, want):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1.0)
        _mostly_close(a / scale, b / scale, f"eval_light_sample {name}")
    if case == "sphere":
        return
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for uniform in (False, True):
        assert TL.env_select_pdf(lights, uniform) == float(
            JL.env_select_pdf(jscene.lights, uniform))
        want = np.asarray(JL.env_dir_pdf(jscene.lights, jscene.envmap, d,
                                         uniform))
        got = TL.env_dir_pdf(lights, env, torch.tensor(d), uniform)
        _close(got / want.max(), want / want.max(), FIELD_TOL, "env_dir_pdf")
    if case == "quads":
        want = JL.env_quad_of_dir(jscene.lights, jscene.envmap, d)
        got = TL.env_quad_of_dir(lights, env, torch.tensor(d))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1], want[1], FIELD_TOL, "quad area")
        _close(got[2], want[2], FIELD_TOL, "quad sin theta")


# ---------------------------------------------------------------------------
# (e) K1's environment switches
# ---------------------------------------------------------------------------


def _sky_cornell(mod):
    host = mod.cornell_box()
    host.envmap_image = j_make_sky(64, 32)
    return host


@pytest.fixture(scope="module")
def sky_cornell():
    jhost = _sky_cornell(JP)
    return jhost, j_prepare(jhost)


def _initial_state(jhost, cfg):
    cam = JP.default_camera(jhost, SIDE, SIDE)
    px, py = _pixel_grid(SIDE, SIDE)
    u1, u2 = _lds(cfg, jnp.uint32(SAMPLE),
                  jrng.pixel_seed(px, py, 0, EFFECT_LENS), (0, 1))
    o, d, spread = camera_ray(cam, px, py, u1, u2)
    o, d = np.asarray(o), np.asarray(d)
    n = SIDE * SIDE
    fs = np.concatenate([o.T, d.T, np.ones((3, n)), np.zeros((3, n)),
                         np.zeros((2, n)), np.asarray(spread)[None]])
    is_ = np.concatenate([np.ones((2, n)), np.full((2, n), -1),
                          np.asarray(px)[None], np.asarray(py)[None],
                          np.full((1, n), bf._NO_BUDGET), np.zeros((1, n))])
    return fs.astype(np.float32), is_.astype(np.int32)


@pytest.fixture(scope="module")
def jax_env_bounces(sky_cornell):
    """The JAX kernel with the environment table at bounces 0 and 1 and
    the final environment round (state carried by the JAX kernel)."""
    jhost, jscene = sky_cornell
    jt = jscene.bounce_tables
    cfg = JConfig(max_bounces=BOUNCES)
    key = bp._cfg_key(cfg)
    fs, is_ = _initial_state(jhost, cfg)
    steps = []
    for b in range(BOUNCES + 1):
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        args = (scal, jnp.asarray(fs.reshape(bp.NF, -1, 128)),
                jnp.asarray(is_.reshape(bp.NI, -1, 128)), jt.tri_rows,
                jt.attr_rows, jt.mat_rows, jt.light_rows, jt.env_rows, None,
                None, key, jt.tc, jt.n_chunks, jt.n_lights, jt.tr, True)
        # the calls of trace_paths_pallas (bounce_pallas.py:1858, :1943),
        # keyword for keyword, so that the render test below finds these
        # compiles in jit's cache
        if b < BOUNCES:
            out = bp._bounce_call(
                *args, tex_maps=(1, 0, 0, 0), interpret=True, inj=None,
                fs2=None, omm=jt.omm, prio=jt.prio, maxb=cfg.max_bounces,
                first_direct=True)
        else:
            out = bp._bounce_call(*args, final_env=True, interpret=True,
                                  fs2=None)
        outs = tuple(np.asarray(x).reshape(x.shape[0], -1) for x in out[:3])
        steps.append(((fs, is_), outs))
        fs, is_ = outs[0], outs[1]
    return cfg, jscene, steps


def _carried(jscene):
    jt = jscene.bounce_tables
    tables = dict(tri_rows=_np(jt.tri_rows), attr_rows=_np(jt.attr_rows),
                  mat_rows=_np(jt.mat_rows), light_rows=_np(jt.light_rows),
                  tc=jt.tc, n_chunks=jt.n_chunks, n_lights=jt.n_lights,
                  n_tris=jt.n_tris, env_rows=_np(jt.env_rows))
    return scene_from_numpy(tables, lights=_port_lights(jscene.lights),
                            envmap=_port_env(jscene.envmap), device="cpu")


@pytest.mark.parametrize("step", ["bounce0", "bounce1", "final_env"])
def test_k1_env_plain_matches_pallas_kernel(jax_env_bounces, step):
    cfg, jscene, steps = jax_env_bounces
    b = ("bounce0", "bounce1", "final_env").index(step)
    (fs, is_), (jf, ji, jh) = steps[b]
    scene = _carried(jscene)
    tables = scene.bounce_tables
    assert tables.env is not None and scene.lights.env_light >= 0
    kcfg = bf.KernelConfig.from_cfg(TConfig(max_bounces=BOUNCES))
    before = dict(kernels.launches)
    tf, ti, th = (x.numpy() for x in bf.bounce(
        torch.tensor(fs), torch.tensor(is_), tables, kcfg, SAMPLE,
        final_env=step == "final_env"))
    assert dict(kernels.launches) == before
    same = (ji == ti).all(0) & (jh[1] == th[1])
    assert same.mean() >= INT_LANES, same.mean()
    for name, t_rows, j_rows in (("fs", tf, jf), ("hit", th, jh)):
        for r in range(t_rows.shape[0]):
            if name == "hit" and r == 1:
                continue
            _close(t_rows[r][same], j_rows[r][same], TOL, f"{name} row {r}")
    # the environment reached the image: after bounce 0 (where the box
    # fills the frame) lanes that miss gain radiance
    miss = (is_[bf.IS_ACTIVE] > 0) & (jh[1] < 0)
    gain = (tf[bf.FS_L:bf.FS_L + 3] - fs[bf.FS_L:bf.FS_L + 3]).sum(0)
    if b > 0:
        assert miss.sum() > 20 and (gain[miss] > 0).mean() > 0.9
    if step == "final_env":
        assert (ti[bf.IS_ACTIVE] == 0).all() and (th[5] == 0).all()


def test_env_table_from_rows_matches_own_bake(sky_cornell):
    _, jscene = sky_cornell
    tscene = prepare(_sky_cornell(TP), device="cpu")
    np.testing.assert_array_equal(
        tscene.bounce_tables.env.numpy(),
        bf.env_table(np.asarray(jscene.bounce_tables.env_rows)))
    # the kernels' texel of a direction: the polynomial's, not acos/atan2
    rs = np.random.default_rng(2)
    d = rs.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    env = tscene.bounce_tables.env
    yi, xi = bf.env_texel_of_dir(env, torch.tensor(d.T.copy()))
    z = np.asarray(bp._atan2_w(jnp.asarray(d[:, 2]), jnp.asarray(d[:, 0])))
    np.testing.assert_array_equal(bf.atan2_poly(torch.tensor(d[:, 2]),
                                                torch.tensor(d[:, 0])), z)
    ty, tx = TE._texel(tscene.envmap, torch.tensor(d))
    assert (yi == ty).float().mean() > 0.99 and (xi == tx).float().mean() > 0.99


# ---------------------------------------------------------------------------
# (g) renders
# ---------------------------------------------------------------------------


def _render_close(got, want, what):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    _close(got, want, TOL, what)
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean()), what


def test_fused_sky_render_matches_jax(sky_cornell, jax_env_bounces):
    """Cornell + make_sky(64, 32), 16x16, 2 spp, 2 bounces: the port's
    fused tier (its plain version on the CPU, "torch") against the JAX
    fused tier in interpret mode."""
    jhost, jscene = sky_cornell
    w = h = 16
    jcfg = JConfig(max_bounces=BOUNCES, kernel_tier="fused",
                   pallas_interpret=True)
    jcam = JP.default_camera(jhost, w, h)
    want = [jint.render_sample(jscene, jcam, jcfg, w, h, jnp.uint32(s))
            for s in range(2)]
    host = _sky_cornell(TP)
    scene = prepare(host, device="cpu")
    cfg = TConfig(max_bounces=BOUNCES)
    assert dispatch.resolve(scene, cfg, "cpu").kernel_tier == "torch"
    got = [tint.render_sample(scene, TP.default_camera(host, w, h), cfg, w,
                              h, s) for s in range(2)]
    assert all(g["kernel_tier"] == "torch" for g in got)
    _render_close((got[0]["L"] + got[1]["L"]) / 2,
                  (np.asarray(want[0]["L"]) + np.asarray(want[1]["L"])) / 2,
                  "image")
    for g, j in zip(got, want):
        assert int(g["ray_count"]) == int(j["ray_count"])
        np.testing.assert_array_equal(g["occupancy"].numpy(),
                                      np.asarray(j["occupancy"]))
    # the final round emptied the wavefront
    assert int(got[0]["occupancy"][-1]) == 0


def _general_host(mod, case):
    if case == "sphere":
        return mod.single_triangle("sphere")
    host = mod.single_triangle("point")
    host.analytic_lights = None
    host.envmap_image = j_make_sky(64, 32)
    host.env_quad_lights = 4 if case == "quads_neeat" else 0
    return host


@pytest.mark.parametrize("case", ["sky", "sphere", "quads_neeat"])
def test_general_tier_renders_match_jax(case):
    """The general tier ("xla") of both packages on the sky-lit triangle
    (tests/test_sky_env.py:61), the sphere-light triangle and env_quads =
    4 under NEE-AT (render_adaptive): 8x8, 2 spp, 1 bounce (the lone
    triangle has no second bounce to light: a second one leaves these
    images as they are and doubles the JAX compile). "auto"
    resolves each to "xla" in both packages: their lights have no kernel
    tables (sphere, quads) or the scene has only what the general tier
    serves."""
    w = h = 8
    neeat = case == "quads_neeat"
    jhost, host = _general_host(JP, case), _general_host(TP, case)
    jscene, scene = j_prepare(jhost), prepare(host, device="cpu")
    nee = "NEEAT" if neeat else "POWER"
    jcfg = JConfig(max_bounces=1, nee=JNEE[nee], kernel_tier="xla")
    cfg = TConfig(max_bounces=1, nee=TNEE[nee])
    jcam, cam = JP.default_camera(jhost, w, h), TP.default_camera(host, w, h)
    if case == "sky":
        # a flat scene with the sky keeps its fused tables; the general
        # tier is asked for, as the JAX test does on the CPU
        cfg = dataclasses.replace(cfg, kernel_tier="xla")
    state = None
    if neeat:
        state = tna.init_state(w, h, scene.lights.count, device="cpu")
    assert dispatch.resolve(scene, cfg, "cpu", state).kernel_tier == "xla"
    kernels.launches.clear()
    if neeat:
        want, jstate, jrays = jint.render_adaptive(jscene, jcam, jcfg, w, h,
                                                   spp=2)
        got, tstate, rays = tint.render_adaptive(scene, cam, cfg, w, h,
                                                 spp=2)
        _close(tstate.tile_pdf, jstate.tile_pdf, TOL, "tile_pdf")
    else:
        want, _, jrays = jint.render(jscene, jcam, jcfg, w, h, spp=2)
        got, _, rays = tint.render(scene, cam, cfg, w, h, spp=2)
    assert not kernels.launches
    _render_close(got, want, "image")
    assert rays == int(jrays)
    assert float(got.mean()) > 0.01


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_renders_a_sky(tmp_path):
    from PIL import Image

    out = tmp_path / "sky.png"
    assert cli.main(["--scene", "triangle", "--sky", "--device", "cpu",
                     "--width", "12", "--height", "8", "--spp", "1",
                     "--bounces", "2", "--out", str(out)]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (8, 12, 3) and img.max() > 0
    with pytest.raises(SystemExit):
        cli.main(["--envmap", "sky.hdr", "--device", "cpu"])

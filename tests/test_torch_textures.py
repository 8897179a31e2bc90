"""Textures, normal maps and stochastic texture filtering in the port
against the JAX package, on the CPU: the same numpy-seeded inputs through
both packages, the JAX side as its own tests run it (Pallas kernels in
interpret mode).

  (a) `bake_textures` field for field (equal) on the checker, wood and
      ripple textures and a seeded non-square image; the kernels' texture
      tables built from the port's atlas equal those carried from the JAX
      package's tex_ct / tex_meta.
  (b) `sample_texture` (bilinear) and `sample_texture_stochastic` on
      4,096 seeded lanes: the stochastic texels equal, bilinear within
      1e-6 (XLA's CPU code may contract the blend into FMAs).
  (c) K1's plain texture switch against `_bounce_call` with tex_maps
      (1, 1, 1, 1) and the environment table, at bounces 0 and 1: in nee
      slot 2 on the textured Cornell box (checker base colour,
      metal-rough, ripple normal map, and the light's emission textured)
      and in slot 5 on the kitchen with every map (its 512 panels take
      the external route; the SF_* rows, textured base colour, metallic
      and roughness among them, compared too): integer rows equal on
      >= 99.5% of lanes, float rows within rtol = atol = 2e-3 (the MIP
      level floor(mip + ju0) may flip on a lane where torch's and XLA's
      log2 differ by an ulp).
  (d) renders against the same tier of the JAX package, every pixel
      within 2e-3, means within 1e-4 relative, ray counts equal: the
      textured Cornell box at 16x16 on the fused tier ("torch" on the CPU)
      with stochastic filtering; the kitchen with every map at 32x32
      through the external route; the textured Cornell box on the general
      tier ("xla") with bilinear filtering and with stochastic filtering.
  (e) the normal map changes the image (tests/test_kernel_env_tex.py
      :112-128), on the fused and the general tier.
  (f) `dispatch.resolve` picks the JAX package's tier for the textured
      Cornell box, the kitchen and the textured, normal-mapped sky city,
      with stochastic filtering on and off.
The JAX fused tier runs with one 128-lane row per block here
(`bounce_pallas._R`, its RTXPT_TPU_FUSED_R knob, set for this module
only): the per-lane results do not depend on the tiling, and the
interpret-mode compile of the textured kernel takes less than half the
time. The kernel checks run on the renders' padded wavefronts, so the
renders find those compiles in jit's cache.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.lighting import envmap as JE
from rtxpt_tpu.lighting import lights_baker as JL
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import dispatch as jdispatch
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.pt.integrator import EFFECT_LENS, _lds, _pixel_grid
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.scene import textures as JT
from rtxpt_tpu.scene.camera import camera_ray
from rtxpt_tpu.utils import rng as jrng
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.apps import cli
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.lighting import envmap as TE
from rtxpt_tpu_torch.lighting import lights_baker as TL
from rtxpt_tpu_torch.prepare import prepare, scene_from_numpy
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.scene import textures as TT

SAMPLE = 3
BOUNCES = 2
INT_LANES = 0.995
TOL = 2e-3
ATLAS_FIELDS = ("data", "mip_offset", "width", "height", "n_mips")
LIGHT_FIELDS = ("kind", "p0", "p1", "p2", "emission", "extra", "normal",
                "power", "cdf", "tri_light", "env_light", "num",
                "env_quad_grid")
ENV_FIELDS = ("image", "row_cdf", "cond_cdf", "texel_pdf", "cos_rot",
              "sin_rot", "mean_radiance")
# (scene, frame) of each K1 case: the renders' frames below (the JAX
# external route cuts its wavefront into 1,024-lane chunks)
FRAMES = {"cornell": (16, 16), "kitchen": (32, 32)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_jax_row():
    """One intra-op thread for this module's torch ops (the test run puts
    several test processes on the machine's cores), and one row per block
    of the JAX fused tier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(bp, "_R", 1)
    yield
    mp.undo()
    torch.set_num_threads(n)


def _np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _ids(mod, ids):
    arr = np.asarray(ids, np.int32)
    return jnp.asarray(arr) if mod is JP else torch.as_tensor(arr)


def _cornell(mod):
    """The textured Cornell box with every map: checker base colour on
    the white material, metal-rough on the tall box, the ripple normal map
    on the white material, the sky, and the light's emission textured
    (no procedural scene sets emissive_tex)."""
    host = mod.textured_cornell(with_env=True, with_mr=True,
                                with_normal=True)
    host.materials = host.materials.replace(
        emissive_tex=_ids(mod, [-1, -1, -1, 1, -1]))
    return host


def _kitchen(mod):
    """The kitchen with every map: a metal-rough checker on the metal
    (glTF: G scales roughness by 1 or 0.6, B metallic by 1 or 0.5), the
    floor's checker on the panels' emission, a ripple normal map on the
    walls. The metal-rough map keeps the metal's roughness at 0.15-0.25:
    near a mirror (roughness 0.05, alpha 0.0026) the GGX pdf of a sampled
    direction moves by 10% when the direction moves by one ulp (XLA's CPU
    code contracts multiplies and adds into FMAs, torch does not), which no
    per-lane tolerance of 2e-3 can hold."""
    host = mod.kitchen_scene()
    host.textures = host.textures + [
        mod.ripple_normal_texture(64),
        mod.checker_texture(32, (0.0, 1.0, 1.0), (0.0, 0.6, 0.5), cells=4)]
    host.materials = host.materials.replace(
        metal_rough_tex=_ids(mod, [-1, -1, -1, 3, -1, -1, -1, -1]),
        emissive_tex=_ids(mod, [-1, -1, -1, -1, -1, 0, -1, -1]),
        normal_tex=_ids(mod, [2, -1, -1, -1, -1, -1, -1, -1]))
    return host


BUILDERS = {"cornell": _cornell, "kitchen": _kitchen}


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX host, JAX scene, port host, port scene), made at first
    use."""
    made = {}

    def get(name):
        if name not in made:
            jh, th = BUILDERS[name](JP), BUILDERS[name](TP)
            made[name] = (jh, j_prepare(jh), th, prepare(th, device="cpu"))
        return made[name]
    return get


def _jax_cfg(jscene, **kw):
    """The JAX fused tier's resolved config with stochastic filtering."""
    return jdispatch.resolve(jscene, JConfig(
        max_bounces=BOUNCES, stochastic_texture_filtering=True,
        kernel_tier="fused", pallas_interpret=True, **kw))


# ---------------------------------------------------------------------------
# (a), (b) the atlas and the samplers
# ---------------------------------------------------------------------------


def _images():
    rs = np.random.default_rng(13)
    return {"checker": [JP.checker_texture(64)],
            "wood": [JP.wood_texture(64)],
            "ripple": [JP.ripple_normal_texture(64)],
            "nonsquare": [rs.uniform(0, 1, (24, 40, 3)).astype(np.float32),
                          (rs.uniform(0, 1, (8, 16)) * 255).astype(np.uint8)]}


@pytest.mark.parametrize("name", list(_images()))
def test_bake_textures_matches_jax(name):
    images = _images()[name]
    for mine, theirs in zip(
            {"checker": [TP.checker_texture(64)],
             "wood": [TP.wood_texture(64)],
             "ripple": [TP.ripple_normal_texture(64)]}.get(name, images),
            images):
        np.testing.assert_array_equal(mine, theirs)
    ja = JT.bake_textures(images)
    ta = TT.bake_textures(images, device="cpu")
    for field in ATLAS_FIELDS:
        np.testing.assert_array_equal(_np(getattr(ta, field)),
                                      _np(getattr(ja, field)), err_msg=field)
    assert ta.count == ja.count
    # the kernels' tables: the port's bake and the JAX package's, carried
    mine = bf.build_tex_tables(ta)
    theirs = bp.build_tex_tables(ja, None)
    if name == "nonsquare":
        assert mine is None and theirs is None    # not a power of two
        return
    carried = bf.tex_tables(np.asarray(theirs[0]), np.asarray(theirs[1]))
    for a, b in zip(mine, carried):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampler", ["bilinear", "stochastic"])
def test_samplers_match_jax(sampler):
    images = [JP.checker_texture(64), JP.wood_texture(32),
              np.random.default_rng(2).uniform(0, 1, (24, 40, 4))
              .astype(np.float32)]
    ja = JT.bake_textures(images)
    ta = TT.bake_textures(images, device="cpu")
    rs = np.random.default_rng(9)
    n = 4096
    tid = rs.integers(-1, len(images), n).astype(np.int32)
    uv = rs.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    lod = rs.uniform(-2.0, 9.0, n).astype(np.float32)
    uj = rs.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    if sampler == "bilinear":
        want = JT.sample_texture(ja, jnp.asarray(tid), jnp.asarray(uv),
                                 jnp.asarray(lod))
        got = TT.sample_texture(ta, torch.tensor(tid), torch.tensor(uv),
                                torch.tensor(lod))
        _close(got, want, 1e-6, "bilinear")
    else:
        want = JT.sample_texture_stochastic(
            ja, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(lod),
            jnp.asarray(uj))
        got = TT.sample_texture_stochastic(
            ta, torch.tensor(tid), torch.tensor(uv), torch.tensor(lod),
            torch.tensor(uj))
        np.testing.assert_array_equal(_np(got), _np(want))
    assert (_np(got)[tid < 0] == 1.0).all()
    assert len(np.unique(_np(got)[tid >= 0, 0])) > 50


# ---------------------------------------------------------------------------
# (c) K1's texture switch
# ---------------------------------------------------------------------------


def _initial_state(jhost, cfg, w, h):
    cam = JP.default_camera(jhost, w, h)
    px, py = _pixel_grid(w, h)
    u1, u2 = _lds(cfg, jnp.uint32(SAMPLE),
                  jrng.pixel_seed(px, py, 0, EFFECT_LENS), (0, 1))
    o, d, spread = camera_ray(cam, px, py, u1, u2)
    o, d = np.asarray(o), np.asarray(d)
    n = w * h
    fs = np.concatenate([o.T, d.T, np.ones((3, n)), np.zeros((3, n)),
                         np.zeros((2, n)), np.asarray(spread)[None]])
    is_ = np.concatenate([np.ones((2, n)), np.full((2, n), -1),
                          np.asarray(px)[None], np.asarray(py)[None],
                          np.full((1, n), bf._NO_BUDGET), np.zeros((1, n))])
    return fs.astype(np.float32), is_.astype(np.int32)


def _carried(jscene):
    """The port's scene from the JAX package's tables, carried as numpy."""
    jt = jscene.bounce_tables
    tables = dict(tri_rows=_np(jt.tri_rows), attr_rows=_np(jt.attr_rows),
                  mat_rows=_np(jt.mat_rows), light_rows=_np(jt.light_rows),
                  tc=jt.tc, n_chunks=jt.n_chunks, n_lights=jt.n_lights,
                  n_tris=jt.n_tris, env_rows=_np(jt.env_rows),
                  tex_ct=_np(jt.tex_ct), tex_meta=_np(jt.tex_meta),
                  tex_maps=jt.tex_maps)
    lights = TL.lights_from_numpy({k: _np(getattr(jscene.lights, k))
                                   for k in LIGHT_FIELDS}, device="cpu")
    env = TE.envmap_from_numpy(**{k: _np(getattr(jscene.envmap, k))
                                  for k in ENV_FIELDS}, device="cpu")
    return scene_from_numpy(tables, lights=lights, envmap=env, device="cpu")


@pytest.fixture(scope="module")
def k1_steps(scenes):
    """name -> the JAX kernel's inputs and outputs at bounces 0 and 1 on
    the render's camera rays (state carried by the JAX kernel), made at
    first use. The calls are trace_paths_pallas's (bounce_pallas.py:1858),
    keyword for keyword, so that the render test finds them in jit's
    cache."""
    made = {}

    def get(name):
        if name in made:
            return made[name]
        jh, js, th, ts = scenes(name)
        jt = js.bounce_tables
        cfg = _jax_cfg(js)
        key = bp._cfg_key(cfg)
        fs, is_ = _initial_state(jh, cfg, *FRAMES[name])
        steps = []
        for b in range(BOUNCES):
            scal = jnp.stack([jnp.uint32(SAMPLE),
                              jnp.uint32(b)]).reshape(1, 2)
            out = bp._bounce_call(
                scal, jnp.asarray(fs.reshape(bp.NF, -1, 128)),
                jnp.asarray(is_.reshape(bp.NI, -1, 128)), jt.tri_rows,
                jt.attr_rows, jt.mat_rows, jt.light_rows, jt.env_rows,
                jt.tex_ct, jt.tex_meta, key, jt.tc, jt.n_chunks,
                jt.n_lights, jt.tr, True, tex_maps=jt.tex_maps,
                interpret=True, inj=None, fs2=None, omm=jt.omm,
                prio=jt.prio, maxb=cfg.max_bounces, first_direct=True)
            outs = tuple(np.asarray(x).reshape(x.shape[0], -1)
                         for x in out[:4] if x is not None)
            steps.append(((fs, is_), outs))
            fs, is_ = outs[0], outs[1]
        made[name] = (cfg, key, steps)
        return made[name]
    return get


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_k1_texture_switch_matches_pallas_kernel(scenes, k1_steps, name,
                                                 bounce):
    jh, js, th, ts = scenes(name)
    cfg, key, steps = k1_steps(name)
    (fs, is_), outs = steps[bounce]
    scene = _carried(js)
    tables = scene.bounce_tables
    assert tables.tex_maps == js.bounce_tables.tex_maps == (1, 1, 1, 1)
    assert tables.env is not None
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.stf and kcfg.nee_mode == key[0] == \
        {"cornell": 2, "kitchen": 5}[name]
    before = dict(kernels.launches)
    got = [x.numpy() for x in bf.bounce(torch.tensor(fs), torch.tensor(is_),
                                        tables, kcfg, SAMPLE)]
    assert dict(kernels.launches) == before
    assert len(got) == len(outs) == (4 if name == "kitchen" else 3)
    (tf, ti, th_), (jf, ji, jh_) = got[:3], outs[:3]
    same = (ji == ti).all(0) & (jh_[1] == th_[1])
    assert same.mean() >= INT_LANES, same.mean()
    names = ("fs", "hit") + (("surf",) if name == "kitchen" else ())
    for what, t_rows, j_rows in zip(names, (tf, th_) + tuple(got[3:]),
                                    (jf, jh_) + tuple(outs[3:])):
        for r in range(t_rows.shape[0]):
            if what == "hit" and r == 1:
                continue                    # prim ids: compared above
            _close(t_rows[r][same], j_rows[r][same], TOL, f"{what} row {r}")
    # the port's own prepare builds the tables the JAX package's carry
    own = ts.bounce_tables
    for field in ("tex", "tex_meta", "attr_rows", "mat_rows"):
        np.testing.assert_array_equal(_np(getattr(own, field)),
                                      _np(getattr(tables, field)),
                                      err_msg=field)
    assert own.tex_maps == tables.tex_maps
    if name == "kitchen":
        # the export carries the textured base colour, metallic, roughness
        surf = got[3]
        hit = (th_[5] > 0.5) & same
        mid = surf[bf.SF_MID][hit].astype(int)
        floor, metal = hit.copy(), hit.copy()
        floor[hit], metal[hit] = mid == 1, mid == 3
        if bounce == 0:
            assert floor.sum() > 4
            # the checker: two colours where the material is white
            assert len(np.unique(surf[bf.SF_BASE][floor].round(3))) > 1
        if metal.any():
            assert (surf[bf.SF_METAL][metal] < 1.0).any()


# ---------------------------------------------------------------------------
# (d) renders
# ---------------------------------------------------------------------------


def _render_close(got, want, what):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    _close(got, want, TOL, what)
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean()), what


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_fused_textured_render_matches_jax(scenes, k1_steps, name):
    """The port's fused tier (its plain version on the CPU, "torch")
    against the JAX fused tier in interpret mode, 2 spp, 2 bounces,
    stochastic filtering: the textured Cornell box at 16x16 (in-kernel
    NEE), the kitchen with every map at 32x32 (the external route: 512
    lights)."""
    jh, js, th, ts = scenes(name)
    cfg_j, _, _ = k1_steps(name)           # the kernel's compiles first
    w, h = FRAMES[name]
    jcam = JP.default_camera(jh, w, h)
    want = [jint.render_sample(js, jcam, cfg_j, w, h, jnp.uint32(s))
            for s in (SAMPLE, SAMPLE + 1)]
    cfg = TConfig(max_bounces=BOUNCES, stochastic_texture_filtering=True)
    resolved = dispatch.resolve(ts, cfg, "cpu")
    assert resolved.kernel_tier == "torch"
    assert resolved.nee_external == (name == "kitchen") == cfg_j.nee_external
    cam = TP.default_camera(th, w, h)
    got = [tint.render_sample(ts, cam, cfg, w, h, s)
           for s in (SAMPLE, SAMPLE + 1)]
    _render_close((got[0]["L"] + got[1]["L"]) / 2,
                  (np.asarray(want[0]["L"]) + np.asarray(want[1]["L"])) / 2,
                  "image")
    for g, j in zip(got, want):
        assert int(g["ray_count"]) == int(j["ray_count"])
        np.testing.assert_array_equal(g["occupancy"].numpy(),
                                      np.asarray(j["occupancy"]))
    assert float(got[0]["L"].mean()) > 0.01


@pytest.mark.parametrize("filtering", ["bilinear", "stochastic"])
def test_general_tier_textured_render_matches_jax(scenes, filtering):
    """The textured Cornell box on the general tier ("xla") of both
    packages, 16x16, 2 spp, 2 bounces: load_surface's textured branch,
    bilinear or stochastic."""
    jh, js, th, ts = scenes("cornell")
    w = h = 16
    stf = filtering == "stochastic"
    jcfg = JConfig(max_bounces=BOUNCES, kernel_tier="xla",
                   stochastic_texture_filtering=stf)
    cfg = TConfig(max_bounces=BOUNCES, stochastic_texture_filtering=stf)
    # "auto" takes the general tier without stochastic filtering; with it
    # the general tier is asked for, as the JAX test does
    if stf:
        cfg = dataclasses.replace(cfg, kernel_tier="xla")
    assert dispatch.resolve(ts, cfg, "cpu").kernel_tier == "xla"
    want, _, jrays = jint.render(js, JP.default_camera(jh, w, h), jcfg, w,
                                 h, spp=2)
    kernels.launches.clear()
    got, _, rays = tint.render(ts, TP.default_camera(th, w, h), cfg, w, h,
                               spp=2)
    assert not kernels.launches
    _render_close(got, want, "image")
    assert rays == int(jrays)


# ---------------------------------------------------------------------------
# (e) the normal map shows; (f) tier resolution; the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["fused", "xla"])
def test_normal_map_changes_the_image(tier):
    w = h = 16
    cfg = TConfig(max_bounces=2, stochastic_texture_filtering=True,
                  kernel_tier="torch" if tier == "fused" else "xla")
    images = []
    for normal in (True, False):
        host = TP.textured_cornell(with_env=False, with_normal=normal)
        scene = prepare(host, device="cpu")
        assert scene.bounce_tables.tex_maps[3] == int(normal)
        img, _, _ = tint.render(scene, TP.default_camera(host, w, h), cfg,
                                w, h, spp=2)
        images.append(img.numpy())
    assert float(np.abs(images[0] - images[1]).max()) > 0.02


def _city(mod):
    return mod.city_scene(tri_budget=4000, seed=1, blocks=2, textured=True,
                          normal_mapped=True, with_env=True)


@pytest.mark.parametrize("stf", [True, False])
@pytest.mark.parametrize("name", ["cornell", "kitchen", "city"])
def test_resolve_picks_the_jax_tier(scenes, name, stf, monkeypatch):
    """Under "auto" both packages pick the same tier: a kernel tier with
    stochastic filtering, the general tier without (the kernels' texture
    path is one stochastic texel); a pinned kernel tier without it raises,
    naming the reason."""
    if name == "city":
        jh, th = _city(JP), _city(TP)
        js, ts = j_prepare(jh), prepare(th, device="cpu")
    else:
        _, js, _, ts = scenes(name)
    monkeypatch.setenv("RTXPT_TPU_PALLAS_INTERPRET", "1")
    want = jdispatch.resolve(js, JConfig(
        stochastic_texture_filtering=stf)).kernel_tier
    got = dispatch.resolve(ts, TConfig(stochastic_texture_filtering=stf),
                           "cpu").kernel_tier
    assert {"torch": "fused"}.get(got, got) == want
    assert want == ({"city": "clustered"}.get(name, "fused") if stf
                    else "xla")
    tier = "clustered" if name == "city" else "fused"
    tables = ts.cluster_tables if name == "city" else ts.bounce_tables
    assert tables.tex is not None
    if not stf:
        with pytest.raises(NotImplementedError,
                           match="without stochastic texture filtering"):
            dispatch.resolve(ts, TConfig(kernel_tier=tier), "cpu")
    # an atlas past the kernels' cap leaves the tables without textures:
    # "auto" takes the general tier, a pinned kernel tier names the cap
    capped = ts.replace(**{
        "cluster_tables" if name == "city" else "bounce_tables":
            dataclasses.replace(tables, tex=None, tex_meta=None)})
    cfg = TConfig(stochastic_texture_filtering=True)
    assert dispatch.resolve(capped, cfg, "cpu").kernel_tier == "xla"
    with pytest.raises(NotImplementedError, match="atlas cap"):
        dispatch.resolve(capped, TConfig(stochastic_texture_filtering=True,
                                         kernel_tier=tier), "cpu")


def test_atlas_past_the_cap_builds_no_texture_tables():
    """The JAX package's eligibility rule: above 64k texels, a size that
    is not a power of two."""
    big = TT.bake_textures([np.ones((256, 256, 4), np.float32)],
                           device="cpu")             # 87,381 texels
    odd = TT.bake_textures([np.ones((8, 12, 4), np.float32)], device="cpu")
    assert bf.build_tex_tables(big) is None
    assert bf.build_tex_tables(odd) is None
    assert bp.build_tex_tables(JT.bake_textures(
        [np.ones((256, 256, 4), np.float32)]), None) is None


def test_cli_renders_the_textured_cornell(tmp_path):
    from PIL import Image

    out = tmp_path / "tc.png"
    assert cli.main(["--scene", "cornell-textured", "--stf", "--device",
                     "cpu", "--width", "12", "--height", "8", "--spp", "1",
                     "--bounces", "2", "--out", str(out)]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (8, 12, 3) and img.max() > 0

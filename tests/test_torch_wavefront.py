"""The general wavefront tier ("xla") of the port against the JAX package's,
on the CPU: the same numpy-seeded inputs through both packages.

  - `bsdf.bsdf_sample` and `make_bsdf_data` on seeded lobes (metals,
    dielectrics, transmission, smooth and delta roughness), directions and
    samples; `surface.load_surface` on seeded hits of the Cornell box with
    a medium stack; `lights_baker.light_pdf_for_tri_hit` (power and
    uniform): every float within rtol = atol = 1e-5, integer and boolean
    outputs equal; bsdf_sample's pdf within 1e-5 at the port's sampled
    direction and 1e-2 relative at each package's own (a peaked lobe
    amplifies last-bit sin / cos differences). An empty tri_light (a light
    list without triangles) gives pdf 0 instead of gathering from an
    empty table (the JAX package's F1 fault).
  - `render` / `render_adaptive` with kernel_tier="xla" against the JAX
    package's xla tier: (a) Cornell 16x16, 2 spp, 2 bounces, power NEE,
    the brute force with fused shadows; (b) the same with BRUTE_MAX_TRIS
    lowered to 16 in both packages, so the BVH walk and the any-hit
    shadow queries run; (a') (a) with material 0 anisotropic, which
    prepare leaves to the general tier (the port's config unpinned); (c)
    NEE-AT with WRS over K = 2 candidates on
    rooms_scene(4), 24x16, 2 spp through render_adaptive. Limits: >= 99%
    of pixels within rtol = atol = 2e-3, image means within 1e-3
    relative, ray counts and per-bounce occupancy equal (and (c)'s final
    tile pdf within 2e-3).
  - The analytic point- and directional-light checks of
    tests/test_integrator.py:17-47 through the port's general tier: the
    center pixel within 2% of albedo/pi * I cos/r^2; `first_emissive=False`
    drops exactly the emission the camera rays see.

One JAX compile per render configuration (module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.accel import brute as jbrute
from rtxpt_tpu.accel.traverse import Hit as JHit
from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.lighting import lights_baker as jlb
from rtxpt_tpu.lighting import neeat as jna
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bsdf as JB
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.pt import surface as jsurface
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.accel import brute as tbrute
from rtxpt_tpu_torch.accel.traverse import Hit
from rtxpt_tpu_torch.config import NEEMode as TNEE
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.lighting import lights_baker as tlb
from rtxpt_tpu_torch.lighting import neeat as tna
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bsdf as TB
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.pt import surface as tsurface
from rtxpt_tpu_torch.scene import procedural as TP

TOL = 1e-5
IMG_TOL = 2e-3
PIXELS = 0.99
MEAN_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------------
# BSDF sampling, surfaces, the emissive pdf
# ---------------------------------------------------------------------------


def _materials(rs, n):
    """Seeded material parameters: every fifth lane metallic, every fourth
    transmissive, some delta-smooth, some anisotropic. The medium stack is
    consistent: a ray that leaves a surface from behind is inside that
    material (the integrator's cur_ior), one that enters it is in air or
    water."""
    lane = np.arange(n)
    rough = rs.uniform(0.0, 1.0, n)
    rough[lane % 7 == 0] = 0.0
    ior = rs.uniform(1.2, 2.0, n)
    front = rs.uniform(size=n) < 0.7
    return dict(
        base_color=rs.uniform(0.05, 0.95, (n, 3)),
        metallic=np.where(lane % 5 == 0, rs.uniform(0.5, 1.0, n), 0.0),
        roughness=rough, ior=ior,
        transmission=np.where(lane % 4 == 1, rs.uniform(0.5, 1.0, n), 0.0),
        diffuse_transmission=np.where(lane % 6 == 2, 0.5, 0.0),
        specular_scale=rs.uniform(0.0, 1.0, n), front=front,
        cur_ior=np.where(front, np.where(lane % 3 == 0, 1.05, 1.0), ior),
        below_ior=np.ones(n),
        anisotropy=np.where(lane % 9 == 0, rs.uniform(0.0, 1.0, n), 0.0))


def _bsdf_pair(mat):
    f = {k: np.asarray(v, np.float32 if k != "front" else bool)
         for k, v in mat.items()}
    args = ("base_color", "metallic", "roughness", "ior", "transmission",
            "diffuse_transmission", "specular_scale", "front")
    kw = ("cur_ior", "below_ior", "anisotropy")
    jd = JB.make_bsdf_data(*(jnp.asarray(f[a]) for a in args),
                           **{k: jnp.asarray(f[k]) for k in kw})
    td = TB.make_bsdf_data(*(torch.from_numpy(f[a]) for a in args),
                           **{k: torch.from_numpy(f[k]) for k in kw})
    return jd, td


BSDF_FIELDS = ("diffuse", "specular_f0", "alpha", "transmission",
               "diffuse_transmission", "eta", "transmission_color",
               "alpha_x", "alpha_y")


def test_bsdf_sample_matches_jax():
    rs = np.random.default_rng(31)
    n = 4096
    jd, td = _bsdf_pair(_materials(rs, n))
    for name in BSDF_FIELDS:
        _close(getattr(td, name), getattr(jd, name), name)
    wo = rs.normal(size=(n, 3))
    wo[:, 2] = np.abs(wo[:, 2]) + 0.05
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    u = rs.uniform(size=(3, n)).astype(np.float32)
    js = jax.jit(JB.bsdf_sample)(jd, jnp.asarray(wo), *map(jnp.asarray, u))
    ts = TB.bsdf_sample(td, torch.from_numpy(wo), *map(torch.from_numpy, u))
    for key in ("lobe", "is_delta", "valid"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                      key)
    for key in ("wi", "weight"):
        _close(ts[key], js[key], key)
    # The pdf of a near-specular lobe (D at its peak) turns the last-bit
    # differences of the two packages' sin / cos in the half-vector sample
    # into up to ~5e-3 relative: the pdf is held at the port's own sampled
    # direction, where both packages evaluate the same function of the
    # same numbers, and within 1e-2 relative at each package's own sample.
    pdf_j = JB.bsdf_pdf(jd, jnp.asarray(wo), jnp.asarray(ts["wi"].numpy()))
    _close(ts["pdf"], np.where(ts["is_delta"].numpy(), 0.0, pdf_j), "pdf")
    np.testing.assert_allclose(ts["pdf"].numpy(), np.asarray(js["pdf"]),
                               rtol=1e-2, atol=TOL)


@pytest.fixture(scope="module")
def cornell_pair():
    jh, th = JP.cornell_box(), TP.cornell_box()
    return jh, j_prepare(jh), th, prepare(th, device="cpu")


def test_prepare_builds_the_general_tiers_tables(cornell_pair):
    """The port's BVH, brute tables and packs equal the JAX package's."""
    _, js, _, ts = cornell_pair
    np.testing.assert_array_equal(ts.bvh.nodes.numpy(),
                                  np.asarray(js.bvh.nodes))
    np.testing.assert_array_equal(ts.tri_pack.numpy(), np.asarray(js.tri_pack))
    np.testing.assert_array_equal(ts.mat_pack.numpy(), np.asarray(js.mat_pack))
    np.testing.assert_array_equal(ts.bvh.brute.table[:, tbrute.TB_V0N]
                                  .numpy(), np.asarray(js.bvh.brute.v0n))


def test_load_surface_matches_jax(cornell_pair):
    _, js, _, ts = cornell_pair
    rs = np.random.default_rng(37)
    n = 2048
    t_count = ts.tri_pack.shape[0]
    prim = rs.integers(-1, t_count, n).astype(np.int32)
    b = rs.uniform(size=(n, 2)).astype(np.float32)
    b = np.where(b.sum(1, keepdims=True) > 1.0, 1.0 - b, b)
    hit_t = rs.uniform(0.1, 5.0, n).astype(np.float32)
    front = rs.uniform(size=n) < 0.5
    o = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cur = np.where(np.arange(n) % 3 == 0, 1.5, 1.0).astype(np.float32)
    below = np.ones(n, np.float32)
    jhit = JHit(t=jnp.asarray(hit_t), prim=jnp.asarray(prim),
                bary=jnp.asarray(b), front=jnp.asarray(front))
    thit = Hit(t=_t(hit_t), prim=_t(prim, torch.int32), bary=_t(b),
               front=_t(front, torch.bool))
    jsurf = jsurface.load_surface(js, jhit, jnp.asarray(o), jnp.asarray(d),
                                  jnp.zeros((n,)), cur_ior=jnp.asarray(cur),
                                  below_ior=jnp.asarray(below))
    tsurf = tsurface.load_surface(ts, thit, _t(o), _t(d), cur_ior=_t(cur),
                                  below_ior=_t(below))
    np.testing.assert_array_equal(tsurf.front.numpy(), np.asarray(jsurf.front))
    np.testing.assert_array_equal(tsurf.mat_id.numpy(),
                                  np.asarray(jsurf.mat_id))
    for key in ("pos", "geo_n", "sh_n", "uv", "emissive"):
        _close(getattr(tsurf, key), getattr(jsurf, key), key)
    for name in BSDF_FIELDS:
        _close(getattr(tsurf.bsdf, name), getattr(jsurf.bsdf, name), name)


@pytest.mark.parametrize("uniform", [False, True])
def test_light_pdf_for_tri_hit_matches_jax(cornell_pair, uniform):
    _, js, _, ts = cornell_pair
    rs = np.random.default_rng(41)
    n = 1024
    prim = rs.integers(-1, ts.tri_pack.shape[0], n).astype(np.int32)
    dist = rs.uniform(0.1, 4.0, n).astype(np.float32)
    cos_l = rs.uniform(0.0, 1.0, n).astype(np.float32)
    want = jlb.light_pdf_for_tri_hit(js.lights, jnp.asarray(prim),
                                     jnp.asarray(dist), jnp.asarray(cos_l),
                                     uniform)
    got = tlb.light_pdf_for_tri_hit(ts.lights, _t(prim, torch.int32),
                                    _t(dist), _t(cos_l), uniform)
    _close(got, want, "pdf")
    assert int((got > 0).sum()) > 0
    # a light list without triangles: no light hit, no gather
    empty = tlb.LightList(**{
        **{k: getattr(ts.lights, k) for k in (
            "kind", "p0", "p1", "p2", "emission", "extra", "normal",
            "power", "cdf", "env_light", "num")},
        "tri_light": torch.zeros((0,), dtype=torch.int32)})
    none = tlb.light_pdf_for_tri_hit(empty, _t(prim, torch.int32), _t(dist),
                                     _t(cos_l), uniform)
    assert torch.equal(none, torch.zeros(n))


# ---------------------------------------------------------------------------
# Renders through the general tier
# ---------------------------------------------------------------------------


def _images_agree(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    close = np.isclose(got, want, rtol=IMG_TOL, atol=IMG_TOL).all(-1)
    assert close.mean() >= PIXELS, (what, close.mean())
    rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-30)
    assert rel <= MEAN_RTOL, (what, rel)


def _render_pair(jh, th, cfg_kw, w, h, spp, pin=True):
    """(JAX hdr, rays, occupancy of sample 0) and the port's, through
    render with kernel_tier="xla" (the port's "auto" without `pin`, which
    must resolve to it)."""
    js, ts = j_prepare(jh), prepare(th, device="cpu")
    jcfg = JConfig(kernel_tier="xla", **{
        k: (JNEE(v.value) if k == "nee" else v) for k, v in cfg_kw.items()})
    tcfg = TConfig(kernel_tier="xla" if pin else "auto", **cfg_kw)
    jcam, tcam = JP.default_camera(jh, w, h), TP.default_camera(th, w, h)
    jimg, _, jrays = jint.render(js, jcam, jcfg, w, h, spp=spp)
    jocc = jint.render_sample_jit(js, jcam, jcfg, w, h, jnp.uint32(0))
    timg, _, trays = tint.render(ts, tcam, tcfg, w, h, spp=spp)
    tocc = tint.render_sample(ts, tcam, tcfg, w, h, 0)
    assert tocc["kernel_tier"] == jocc["kernel_tier"] == "xla"
    return ((np.asarray(jimg), jrays, np.asarray(jocc["occupancy"])),
            (timg.numpy(), trays, tocc["occupancy"].numpy()), ts)


RENDERS = {
    "brute_fused_shadows": dict(max_bounces=2, nee=TNEE.POWER),
    "bvh_walk": dict(max_bounces=2, nee=TNEE.POWER),
    "anisotropic": dict(max_bounces=2, nee=TNEE.POWER),
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_render_matches_jax_xla_tier(case):
    """(anisotropic: material 0 at anisotropy 0.5 in both packages; the
    port's prepare builds no kernel tables for it, as the JAX one, and
    its unpinned render takes the general tier.)"""
    jh, th = JP.cornell_box(), TP.cornell_box()
    if case == "anisotropic":
        jm, tm = jh.materials, th.materials
        jh.materials = jm.replace(anisotropy=jm.anisotropy.at[0].set(0.5))
        th.materials = tm.replace(anisotropy=torch.where(
            torch.arange(len(tm.anisotropy)) == 0, 0.5, tm.anisotropy))
    with pytest.MonkeyPatch.context() as mp:
        if case == "bvh_walk":
            mp.setattr(jbrute, "BRUTE_MAX_TRIS", 16)
            mp.setattr(tbrute, "BRUTE_MAX_TRIS", 16)
        (jimg, jrays, jocc), (timg, trays, tocc), ts = _render_pair(
            jh, th, RENDERS[case], 16, 16, 2, pin=case != "anisotropic")
    assert (ts.bvh.brute is None) == (case == "bvh_walk")
    assert (ts.bounce_tables is None) == (case == "anisotropic")
    _images_agree(timg, jimg, case)
    assert trays == jrays
    np.testing.assert_array_equal(tocc, jocc)


def test_render_adaptive_wrs_matches_jax_xla_tier():
    """NEE-AT with WRS over two candidates, rooms_scene(4), through
    render_adaptive; the JAX side runs render_adaptive's own loop
    (rtxpt_tpu/pt/integrator.py:694-711) to keep each sample's occupancy,
    and the port's render_adaptive is held to its render_sample loop."""
    jh, th = JP.rooms_scene(4), TP.rooms_scene(4)
    js, ts = j_prepare(jh), prepare(th, device="cpu")
    w, h, spp = 24, 16, 2
    jcfg = JConfig(kernel_tier="xla", max_bounces=2, nee=JNEE.NEEAT,
                   nee_candidates=2)
    tcfg = TConfig(kernel_tier="xla", max_bounces=2, nee=TNEE.NEEAT,
                   nee_candidates=2)
    jcam, tcam = JP.default_camera(jh, w, h), TP.default_camera(th, w, h)
    jstate = jna.init_state(w, h, int(js.lights.count))
    tstate = tna.init_state(w, h, ts.lights.count, device="cpu")
    jacc = tacc = 0.0
    jrays = trays = 0
    for s in range(spp):
        jo = jint.render_sample_jit(js, jcam, jcfg, w, h, jnp.uint32(s),
                                    False, jstate)
        to = tint.render_sample(ts, tcam, tcfg, w, h, s, neeat_state=tstate)
        assert to["kernel_tier"] == "xla"
        np.testing.assert_array_equal(to["occupancy"].numpy(),
                                      np.asarray(jo["occupancy"]))
        jrays += int(jo["ray_count"])
        trays += int(to["ray_count"])
        jacc = jacc + np.asarray(jo["L"])
        tacc = tacc + to["L"]
        jstate = jna.update(jstate, jo["neeat_hist"])
        tstate = tna.update(tstate, to["neeat_hist"])
    _images_agree(tacc.numpy() / spp, jacc / spp, "neeat_wrs")
    assert trays == jrays
    _close(tstate.tile_pdf, jstate.tile_pdf, "tile_pdf", IMG_TOL)
    img, state, rays = tint.render_adaptive(ts, tcam, tcfg, w, h, spp)
    assert torch.equal(img, tacc / spp) and rays == trays
    assert torch.equal(state.tile_pdf, tstate.tile_pdf)


@pytest.mark.parametrize("kind,side,spp,expected", [
    ("point", 64, 4, np.asarray([0.8, 0.6, 0.4]) / np.pi * 10.0 / 4.0),
    ("directional", 32, 2, np.asarray([0.8, 0.6, 0.4]) / np.pi * 2.0)])
def test_analytic_light_through_the_general_tier(kind, side, spp, expected):
    """Diffuse plane and one light: the center pixel is albedo/pi * I
    cos/r^2 (point light I = 10 at distance 2; directional radiance 2)."""
    host = TP.single_triangle(kind)
    host.materials = host.materials.replace(
        specular_f0_scale=torch.zeros((1,)))
    scene = prepare(host, device="cpu")
    cfg = TConfig(max_bounces=1, nee=TNEE.POWER,
                  enable_russian_roulette=False, kernel_tier="xla")
    hdr, _, _ = tint.render(scene, TP.default_camera(host, side, side), cfg,
                            side, side, spp=spp)
    c = side // 2
    got = hdr.numpy()[c - 1:c + 1, c - 1:c + 1].mean((0, 1))
    np.testing.assert_allclose(got, expected, rtol=0.02)


def test_first_emissive_drops_only_the_camera_rays_emission(cornell_pair):
    """trace_paths(first_emissive=False) on the general tier differs from
    the default only on the lanes whose camera ray hits the light, by the
    light's emission."""
    th, ts = cornell_pair[2], cornell_pair[3]
    cfg = TConfig(max_bounces=2, nee=TNEE.POWER, kernel_tier="xla")
    side = 24
    cam = TP.default_camera(th, side, side)
    px, py = tint._pixel_grid(side, side)
    o, d, spread = tint.camera_rays(cam, cfg, px, py, 0)
    full = tint.trace_paths(ts, cfg, o, d, spread, px, py, 0)["L"]
    dark = tint.trace_paths(ts, cfg, o, d, spread, px, py, 0,
                            first_emissive=False)["L"]
    hit = tbrute.closest(ts.bvh.brute, o.contiguous(), d.contiguous(),
                         torch.zeros(side * side),
                         torch.full((side * side,), 1e27))
    surf = tsurface.load_surface(ts, Hit(t=hit["t"], prim=hit["prim"],
                                         bary=hit["uv"], front=hit["front"]),
                                 o, d)
    sees_light = (hit["prim"] >= 0) & (surf.emissive.sum(-1) > 0)
    assert 0 < int(sees_light.sum()) < side * side
    torch.testing.assert_close(full - dark,
                               torch.where(sees_light[:, None],
                                           surf.emissive, 0.0))

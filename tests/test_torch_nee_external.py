"""The external-NEE route of the fused tier against the JAX package, on the
CPU: the same numpy-seeded inputs through both packages, the JAX side as
its own tests run it (Pallas kernels in interpret mode).

  (a) K2's plain version against `shadow_occlusion_call` on 2,048 shadow
      rays of rooms_scene(4): occlusion equal on every lane.
  (b) K1's plain version in nee slots 3 (NEE-AT) and 5 (power, external)
      against `_bounce_call`, 1,024 Cornell camera rays, bounces 0 and 1,
      with tests/test_torch_bounce.py's criteria: integer rows and prim
      ids equal on >= 99.5% of lanes, every float row (fs, hit, the 24
      SF_* surface rows) within rtol = atol = 2e-3 on those lanes.
  (c) `external_nee` on the same SF_* rows, for NEE-AT with a warmed tile
      state carried across by `neeat.state_from_numpy` and for power with
      K = 4 WRS candidates: li, tile and do_nee equal; float outputs
      within rtol = atol = 2e-3. Beneath it, `bsdf.BSDFData`'s eval, pdf
      and split eval on seeded random lobes and directions, within
      rtol = 1e-5, atol = 1e-6 (tests/test_torch_wide.py's limits).
  (d) `neeat` in the dense and the top-K tier (forced by lowering
      MAX_DENSE_LIGHTS in both packages inside the test): feedback
      accumulation, `update` with and without motion, `select_pdf` and
      `sample_adaptive`. Integer outputs equal; floats within 1e-5 (one
      operation order apart), samples within 2e-3.
  (e) `render_adaptive` end to end: Cornell 16x16, 2 spp, 2 bounces, the
      port on the CPU against the JAX fused tier in interpret mode: image
      and final tile_pdf within rtol = atol = 2e-3 (the fused-tier parity
      limit of tests/test_torch_render.py), and the same ray count. The
      JAX side runs render_adaptive's loop (rtxpt_tpu/pt/integrator.py:
      694-711) over the un-jitted render_sample, as test_torch_render.py
      runs the fused tier, so that its bounce kernel is the one (b)
      compiled (the same static switches, 2 bounces, 1,024 lanes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.lighting import neeat as jna
from rtxpt_tpu.lighting.envmap import bake_envmap as j_bake_envmap
from rtxpt_tpu.lighting.lights_baker import LightList as JLightList
from rtxpt_tpu.pt import bsdf as JB
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import dispatch as j_dispatch
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.pt.integrator import EFFECT_LENS, _lds, _pixel_grid
from rtxpt_tpu.pt.nee_external import external_nee as j_external_nee
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.scene.camera import camera_ray
from rtxpt_tpu.utils import rng as jrng
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import NEEMode as TNEE
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.lighting import neeat as tna
from rtxpt_tpu_torch.lighting.lights_baker import lights_from_numpy
from rtxpt_tpu_torch.prepare import prepare, scene_from_numpy
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import bsdf as TB
from rtxpt_tpu_torch.pt.integrator import render_adaptive
from rtxpt_tpu_torch.pt.nee_external import external_nee
from rtxpt_tpu_torch.scene import procedural as TP

SIDE = 32                      # 1,024 camera rays
LANES = SIDE * SIDE            # every wavefront here: one shape, so
#                                the JAX side compiles each op once
SAMPLE = 3
BOUNCES = 2                    # (b)'s kernel switches are (e)'s
INT_LANES = 0.995
TOL = 2e-3
STATE_TOL = 1e-5
LIGHT_FIELDS = ("kind", "p0", "p1", "p2", "emission", "extra", "normal",
                "power", "cdf", "tri_light", "env_light", "num")
STATE_FIELDS = ("tile_pdf", "tile_cdf", "ema", "idx_k", "frame", "conf",
                "trust", "power", "n_tiles_x", "n_tiles_y", "n_lights")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return None if x is None else np.asarray(x)


def _fields(obj, names):
    return {k: _np(getattr(obj, k)) for k in names}


def _port_state(jstate):
    fields = _fields(jstate, STATE_FIELDS)
    fields["frame"] = int(fields["frame"])
    return tna.state_from_numpy(fields, device="cpu")


def _tables(jt):
    return dict(tri_rows=np.asarray(jt.tri_rows),
                attr_rows=np.asarray(jt.attr_rows),
                mat_rows=np.asarray(jt.mat_rows),
                light_rows=np.asarray(jt.light_rows), tc=jt.tc,
                n_chunks=jt.n_chunks, n_lights=jt.n_lights, n_tris=jt.n_tris)


def _carried(jscene):
    """The JAX scene's bounce tables and lights as a port scene (CPU)."""
    return scene_from_numpy(_tables(jscene.bounce_tables),
                            lights=lights_from_numpy(
                                _fields(jscene.lights, LIGHT_FIELDS),
                                device="cpu"),
                            device="cpu")


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# (a) K2: shadow any-hit
# ---------------------------------------------------------------------------


def test_k2_plain_matches_pallas_kernel():
    jh, th = JP.rooms_scene(4), TP.rooms_scene(4)
    jt = j_prepare(jh).bounce_tables
    tables = prepare(th, device="cpu").bounce_tables
    # the port bakes the rooms into the JAX package's tables
    np.testing.assert_array_equal(tables.tri_rows.numpy(),
                                  np.asarray(jt.tri_rows))
    assert tables.n_tris == jt.n_tris == 144 and tables.n_lights == 8
    # 2,048 shadow rays from points inside the rooms toward random points
    # of random panels; one lane in ten carries no request
    rs = np.random.default_rng(11)
    n = 2048
    o = rs.uniform([0.05, 0.05, 0.05], [7.95, 2.35, 2.95], (n, 3))
    lights = prepare(th, device="cpu").lights
    li = rs.integers(0, lights.count, n)
    b = np.sort(rs.uniform(size=(n, 2)), axis=1)
    target = (lights.p0.numpy()[li] + b[:, :1] * lights.p1.numpy()[li]
              + (b[:, 1:] - b[:, :1]) * lights.p2.numpy()[li])
    dist = np.linalg.norm(target - o, axis=1)
    d = (target - o) / dist[:, None]
    req = rs.uniform(size=n) < 0.9
    sdist = np.where(req, dist * (1.0 - 1e-4), 0.0)
    f32 = np.float32
    jsh = np.zeros((11, n), f32)
    jsh[0:3], jsh[3:6], jsh[6], jsh[10] = o.T, d.T, sdist, req
    want = np.asarray(bp.shadow_occlusion_call(
        jnp.asarray(jsh.reshape(11, -1, 128)), jt.tri_rows, jt.tc,
        jt.n_chunks, interpret=True)).reshape(-1)
    sh = bf.shadow_requests(torch.tensor(o, dtype=torch.float32),
                            torch.tensor(d, dtype=torch.float32),
                            torch.tensor(sdist, dtype=torch.float32),
                            torch.tensor(req))
    before = kernels.launches["shadow_occlusion"]
    occ, tests = bf.occlusion(tables, sh, stats=True)
    assert kernels.launches["shadow_occlusion"] == before
    np.testing.assert_array_equal(occ.numpy(), want)
    # both outcomes occur, and the counts stop at the first occluder
    visible = req & (want < 0.5)
    assert 0.1 < visible.mean() < 0.8
    tests = tests.numpy()
    assert (tests[~req] == 0).all()
    assert (tests[visible] == tables.n_tris).all()
    hidden = req & (want > 0.5)
    assert (tests[hidden] >= 1).all() and (tests[hidden] <= 144).all()
    assert tests[hidden].mean() < tables.n_tris


# ---------------------------------------------------------------------------
# (b) K1's external modes
# ---------------------------------------------------------------------------


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


MODES = {
    "neeat": dict(nee="NEEAT"),                             # slot 3
    "power_ext": dict(nee="POWER", nee_external=True),      # slot 5
}


def _configs(nee, **kw):
    """The same PathTracerConfig in the JAX package and in the port."""
    return (JConfig(nee=JNEE[nee], **kw), TConfig(nee=TNEE[nee], **kw))


@pytest.fixture(scope="module", params=list(MODES))
def jax_ext_bounces(request, cornell_scene):
    """Inputs and outputs of the JAX kernel in an external slot at bounces
    0 and 1 (state carried by the JAX kernel)."""
    jhost, jscene = cornell_scene
    jt = jscene.bounce_tables
    cfg, tcfg = _configs(max_bounces=BOUNCES, **MODES[request.param])
    key = bp._cfg_key(cfg)
    assert key[0] == (3 if request.param == "neeat" else 5)
    fs, is_ = _initial_state(jhost, cfg)
    steps = []
    for b in range(2):
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        # the call of trace_paths_pallas (bounce_pallas.py:1858), keyword
        # for keyword, so that (e) finds this compile in jit's cache
        out = bp._bounce_call(
            scal, jnp.asarray(fs.reshape(bp.NF, -1, 128)),
            jnp.asarray(is_.reshape(bp.NI, -1, 128)), jt.tri_rows,
            jt.attr_rows, jt.mat_rows, jt.light_rows, jt.env_rows, None,
            None, key, jt.tc, jt.n_chunks, jt.n_lights, jt.tr, True,
            tex_maps=(1, 0, 0, 0), interpret=True, inj=None, fs2=None,
            omm=jt.omm, prio=jt.prio, maxb=cfg.max_bounces,
            first_direct=True)
        outs = tuple(np.asarray(x).reshape(x.shape[0], -1) for x in out[:4])
        steps.append(((fs, is_), outs))
        fs, is_ = outs[0], outs[1]
    return request.param, (cfg, tcfg), jscene, steps


@pytest.mark.parametrize("bounce", [0, 1])
def test_k1_external_modes_match_pallas_kernel(jax_ext_bounces, bounce):
    mode, (_, cfg), jscene, steps = jax_ext_bounces
    (fs, is_), (jf, ji, jh, js) = steps[bounce]
    scene = _carried(jscene)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.external and kcfg.nee_mode == (3 if mode == "neeat" else 5)
    before = kernels.launches["bounce_fused"]
    tf, ti, th, ts = (x.numpy() for x in bf.bounce(
        torch.tensor(fs), torch.tensor(is_), scene.bounce_tables, kcfg,
        SAMPLE))
    assert kernels.launches["bounce_fused"] == before
    same = (ji == ti).all(0) & (jh[1] == th[1])
    assert same.mean() >= INT_LANES, same.mean()
    for name, t_rows, j_rows in (("fs", tf, jf), ("hit", th, jh),
                                 ("surf", ts, js)):
        for r in range(t_rows.shape[0]):
            if name == "hit" and r == 1:
                continue                    # prim ids: compared above
            _close(t_rows[r][same], j_rows[r][same], TOL, f"{name} row {r}")
    # hit row 5 is the shading flag: 1 at the first surface, 2 after
    assert set(np.unique(th[5])) <= {0.0, 1.0 + bounce}
    if mode == "neeat" and bounce == 0:
        # the emission goes out unweighted and the light is visible
        assert (ts[bf.SF_EMIT] > 0).any() and (ts[bf.SF_LID] >= 0).any()
    if mode == "power_ext":
        assert (ts[bf.SF_EMIT:bf.SF_EMIT + 3] == 0).all()


# ---------------------------------------------------------------------------
# (c) external_nee
# ---------------------------------------------------------------------------


def _warm_state(jscene, rs):
    """A JAX NEE-AT state after two updates with seeded feedback, some
    tiles without any."""
    n_lights = int(jscene.lights.count)
    state = jna.init_state(SIDE, SIDE, n_lights,
                           lights_power=np.asarray(jscene.lights.power))
    for _ in range(2):
        t = state.tile_pdf.shape[0]
        hist = rs.exponential(1.0, (t, n_lights)).astype(np.float32)
        hist[rs.uniform(size=t) < 0.3] = 0.0
        state = jna.update(state, jnp.asarray(hist))
    return state


@pytest.mark.parametrize("bounce", [0, 1])
def test_external_nee_matches_jax(jax_ext_bounces, bounce):
    mode, (cfg, tcfg), jscene, steps = jax_ext_bounces
    (fs, is_), (_, ji, jh, js) = steps[bounce]
    if mode == "neeat":
        jstate = _warm_state(jscene, np.random.default_rng(5))
        state = _port_state(jstate)
    else:
        cfg, tcfg = _configs(max_bounces=BOUNCES, nee="POWER",
                             nee_candidates=4, nee_external=True)
        jstate = state = None
    args = dict(surf=js, d_in=fs[bf.FS_D:bf.FS_D + 3], hit_mask=jh[5] > 0.5,
                prev_pdf_in=fs[bf.FS_PREVPDF],
                prev_delta_in=is_[bf.IS_PREVDELTA] > 0, px=ji[bf.IS_PX],
                py=ji[bf.IS_PY])
    want = j_external_nee(jscene, cfg, jstate,
                          **{k: jnp.asarray(v) for k, v in args.items()},
                          sample_idx=jnp.uint32(SAMPLE), bounce=bounce)
    got = external_nee(_carried(jscene), tcfg, state,
                       **{k: torch.tensor(v) for k, v in args.items()},
                       sample_idx=SAMPLE, bounce=bounce)
    for key in ("li", "tile", "do_nee"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    do = got["do_nee"].numpy()
    assert do.mean() > 0.3
    for key in ("em_add", "contrib"):
        _close(got[key].numpy(), want[key], TOL, key)
    for key in ("shadow_o", "shadow_d", "sdist"):
        _close(got[key].numpy()[do], np.asarray(want[key])[do], TOL, key)
    if mode == "neeat":
        assert len(np.unique(got["tile"].numpy())) > 1
        if bounce == 1:
            assert np.abs(got["em_add"].numpy()).max() > 0


def test_bsdf_data_matches_jax():
    rs = np.random.default_rng(17)
    n = LANES

    def unit(z_lo):
        v = rs.normal(size=(n, 3))
        v[:, 2] = np.abs(v[:, 2]) * np.sign(rs.uniform(z_lo, 1.0, n))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    f32 = np.float32
    alpha = rs.uniform(0.0, 1.0, n) ** 2
    alpha[rs.uniform(size=n) < 0.1] = 0.0              # delta lobes
    fields = dict(
        diffuse=rs.uniform(0, 1, (n, 3)).astype(f32),
        specular_f0=rs.uniform(0, 1, (n, 3)).astype(f32),
        alpha=alpha.astype(f32),
        transmission=(rs.uniform(size=n) * (rs.uniform(size=n) < 0.3)
                      ).astype(f32),
        diffuse_transmission=(rs.uniform(size=n) * 0.5).astype(f32),
        eta=rs.uniform(0.6, 1.6, n).astype(f32),
        transmission_color=np.ones((n, 3), f32))
    wo, wi = unit(-0.1), unit(-0.5)
    jd = JB.BSDFData(**{k: jnp.asarray(v) for k, v in fields.items()})
    td = TB.BSDFData(**{k: torch.tensor(v) for k, v in fields.items()})
    jwo, jwi, two, twi = (jnp.asarray(wo), jnp.asarray(wi),
                          torch.tensor(wo), torch.tensor(wi))
    for name, got, want in (
            ("eval", TB.bsdf_eval(td, two, twi), JB.bsdf_eval(jd, jwo, jwi)),
            ("pdf", TB.bsdf_pdf(td, two, twi), JB.bsdf_pdf(jd, jwo, jwi)),
            ("split_d", TB.bsdf_eval_split(td, two, twi)[0],
             JB.bsdf_eval_split(jd, jwo, jwi)[0]),
            ("split_s", TB.bsdf_eval_split(td, two, twi)[1],
             JB.bsdf_eval_split(jd, jwo, jwi)[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert (TB.bsdf_pdf(td, two, twi) > 0).float().mean() > 0.3


# ---------------------------------------------------------------------------
# (d) neeat
# ---------------------------------------------------------------------------


def _synthetic_lights(rs, n_tri=5):
    """n_tri triangle lights and a point, a spot and a directional light."""
    f32 = np.float32
    n = n_tri + 3
    kind = np.asarray([0] * n_tri + [1, 3, 2], np.int32)
    p0 = rs.uniform(-1, 1, (n, 3)).astype(f32)
    p0[:n_tri, 1] = 2.0
    p1 = rs.uniform(-0.5, 0.5, (n, 3)).astype(f32)
    p2 = rs.uniform(-0.5, 0.5, (n, 3)).astype(f32)
    p1[n_tri + 1:] = [[0.0, -1.0, 0.0], [0.3, -0.9, 0.1]]
    p1[n_tri + 1:] /= np.linalg.norm(p1[n_tri + 1:], axis=1, keepdims=True)
    cr = np.cross(p1[:n_tri], p2[:n_tri])
    area = 0.5 * np.linalg.norm(cr, axis=1)
    normal = np.zeros((n, 3), f32)
    normal[:n_tri] = -np.abs(cr / (2.0 * area[:, None]))
    extra = np.zeros((n, 4), f32)
    extra[:n_tri, 0] = area
    extra[n_tri + 1] = [0.9, 0.7, 0.0, 0.0]
    power = rs.uniform(0.5, 2.0, n)
    power = (power / power.sum()).astype(f32)
    cdf = np.cumsum(power.astype(np.float64))
    cdf[-1] = 1.0
    return dict(kind=kind, p0=p0, p1=p1, p2=p2,
                emission=rs.uniform(1, 5, (n, 3)).astype(f32), extra=extra,
                normal=normal, power=power, cdf=cdf.astype(f32),
                tri_light=np.zeros((1,), np.int32), env_light=-1, num=n)


@pytest.fixture(params=["dense", "topk"])
def neeat_pair(request, monkeypatch):
    """(JAX lights, port lights, JAX state, port state, seeded generator)
    after one feedback accumulation and update; the top-K tier is forced
    by lowering MAX_DENSE_LIGHTS in both packages."""
    if request.param == "topk":
        monkeypatch.setattr(jna, "MAX_DENSE_LIGHTS", 4)
        monkeypatch.setattr(tna, "MAX_DENSE_LIGHTS", 4)
    rs = np.random.default_rng(23)
    fields = _synthetic_lights(rs)
    jl = JLightList(**{k: (jnp.asarray(v) if k not in ("env_light", "num")
                           else jnp.int32(v)) for k, v in fields.items()})
    tl = lights_from_numpy(fields, device="cpu")
    w, h = 40, 24                                   # 5 x 3 tiles
    jstate = jna.init_state(w, h, 8, lights_power=fields["power"])
    state = tna.init_state(w, h, 8, lights_power=fields["power"],
                           device="cpu")
    assert jstate.topk == state.topk == (request.param == "topk")
    return jl, tl, jstate, state, rs, (w, h)


def _feedback(rs, n_lanes, n_tiles, n_lights):
    return dict(tile=rs.integers(0, n_tiles, n_lanes).astype(np.int32),
                li=rs.integers(0, n_lights, n_lanes).astype(np.int32),
                weight=rs.exponential(1.0, n_lanes).astype(np.float32),
                valid=rs.uniform(size=n_lanes) < 0.8)


def _assert_states_match(jstate, state):
    for key in ("tile_pdf", "tile_cdf", "ema", "conf", "trust"):
        _close(getattr(state, key).numpy(), getattr(jstate, key),
               STATE_TOL, key)
    assert state.frame == int(jstate.frame)
    if jstate.topk:
        np.testing.assert_array_equal(state.idx_k.numpy(),
                                      np.asarray(jstate.idx_k))


def test_neeat_feedback_and_update_match_jax(neeat_pair):
    jl, tl, jstate, state, rs, (w, h) = neeat_pair
    t = state.tile_pdf.shape[0]
    jhist, hist = jna.zero_hist(jstate), tna.zero_hist(state)
    for step in range(3):
        # three frames: two bounces of feedback each, the last one
        # reprojected by per-pixel motion
        for _ in range(2):
            fb = _feedback(rs, LANES, t, 8)
            jhist = jna.accumulate_feedback(
                jstate, jhist, *(jnp.asarray(fb[k]) for k in
                                 ("tile", "li", "weight", "valid")))
            hist = tna.accumulate_feedback(
                state, hist, *(torch.tensor(fb[k]) for k in
                               ("tile", "li", "weight", "valid")))
        if state.topk:
            np.testing.assert_array_equal(hist[1].numpy(),
                                          np.asarray(jhist[1]))
            _close(hist[0].numpy(), jhist[0], STATE_TOL, "hist")
        else:
            _close(hist.numpy(), jhist, STATE_TOL, "hist")
        motion = None
        if step == 2:
            motion = rs.uniform(-12, 12, (h, w, 2)).astype(np.float32)
        jstate = jna.update(jstate, jhist, None if motion is None
                            else jnp.asarray(motion))
        state = tna.update(state, hist, None if motion is None
                           else torch.tensor(motion))
        _assert_states_match(jstate, state)
        jhist, hist = jna.zero_hist(jstate), tna.zero_hist(state)
    # the merge of per-chunk accumulators
    fb = [_feedback(rs, LANES, t, 8) for _ in range(3)]
    jparts = [jna.accumulate_feedback(jstate, jna.zero_hist(jstate), *(
        jnp.asarray(f[k]) for k in ("tile", "li", "weight", "valid")))
        for f in fb]
    parts = [tna.accumulate_feedback(state, tna.zero_hist(state), *(
        torch.tensor(f[k]) for k in ("tile", "li", "weight", "valid")))
        for f in fb]
    if state.topk:
        jm = jna.merge_hists(jstate, (jnp.stack([p[0] for p in jparts]),
                                      jnp.stack([p[1] for p in jparts])))
        tm = tna.merge_hists(state, parts)
        np.testing.assert_array_equal(tm[1].numpy(), np.asarray(jm[1]))
        _close(tm[0].numpy(), jm[0], STATE_TOL, "merged")
    else:
        jm = jna.merge_hists(jstate, jnp.stack(jparts))
        _close(tna.merge_hists(state, parts).numpy(), jm, STATE_TOL,
               "merged")


def test_neeat_select_and_sample_match_jax(neeat_pair):
    jl, tl, jstate, state, rs, (w, h) = neeat_pair
    t = state.tile_pdf.shape[0]
    for _ in range(2):
        fb = _feedback(rs, LANES, t, 8)
        jstate = jna.update(jstate, jna.accumulate_feedback(
            jstate, jna.zero_hist(jstate),
            *(jnp.asarray(fb[k]) for k in ("tile", "li", "weight", "valid"))))
        state = tna.update(state, tna.accumulate_feedback(
            state, tna.zero_hist(state),
            *(torch.tensor(fb[k]) for k in ("tile", "li", "weight", "valid"))))
    _assert_states_match(jstate, state)
    n = LANES
    tile = rs.integers(0, t, n).astype(np.int32)
    li = rs.integers(0, 8, n).astype(np.int32)
    _close(tna.select_pdf(state, tl, torch.tensor(tile),
                          torch.tensor(li)).numpy(),
           jna.select_pdf(jstate, jl, jnp.asarray(tile), jnp.asarray(li)),
           STATE_TOL, "select_pdf")
    pos = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    pix = dict(px=rs.integers(0, w, n).astype(np.int32),
               py=rs.integers(0, h, n).astype(np.int32))
    us = {k: rs.uniform(size=n).astype(np.float32)
          for k in ("u_mix", "u_sel", "u1", "u2")}
    want = jna.sample_adaptive(
        jstate, jl, j_bake_envmap(None), jnp.asarray(pos),
        *(jnp.asarray(v) for v in pix.values()),
        *(jnp.asarray(v) for v in us.values()))
    got = tna.sample_adaptive(state, tl, None, torch.tensor(pos),
                              *(torch.tensor(v) for v in pix.values()),
                              *(torch.tensor(v) for v in us.values()))
    for key in ("light_index", "tile", "is_delta", "valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert len(np.unique(got["light_index"].numpy())) == 8
    for key in ("wi", "dist", "Li", "pdf"):
        _close(got[key].numpy(), want[key], TOL, key)


# ---------------------------------------------------------------------------
# (e) the slice end to end
# ---------------------------------------------------------------------------


def _j_render_adaptive(jscene, cam, cfg, w, h, spp):
    """rtxpt_tpu's render_adaptive with the un-jitted render_sample."""
    state = jna.init_state(w, h, int(jscene.lights.count))
    cfg = j_dispatch.resolve(jscene, cfg, state)
    assert cfg.kernel_tier == "fused" and cfg.nee_external
    acc, rays = None, 0
    for s in range(spp):
        out = jint.render_sample(jscene, cam, cfg, w, h, jnp.uint32(s),
                                 neeat_state=state)
        rays += int(out["ray_count"])
        acc = out["L"] if acc is None else acc + out["L"]
        state = jna.update(state, out["neeat_hist"])
    return np.asarray(acc / spp), state, rays


def test_render_adaptive_matches_jax_fused_tier(cornell_scene):
    jhost, jscene = cornell_scene
    w = h = 16
    jcfg = JConfig(max_bounces=BOUNCES, nee=JNEE.NEEAT, kernel_tier="fused",
                   pallas_interpret=True)
    want, jstate, jrays = _j_render_adaptive(
        jscene, JP.default_camera(jhost, w, h), jcfg, w, h, 2)
    host = TP.cornell_box()
    scene = prepare(host, device="cpu")
    before = dict(kernels.launches)
    got, state, rays = render_adaptive(
        scene, TP.default_camera(host, w, h),
        TConfig(max_bounces=BOUNCES, nee=TNEE.NEEAT), w, h, spp=2)
    assert dict(kernels.launches) == before
    assert torch.isfinite(got).all()
    _close(got.numpy(), want, TOL, "image")
    _close(state.tile_pdf.numpy(), jstate.tile_pdf, TOL, "tile_pdf")
    assert rays == jrays
    # the sampler learned: lit tiles moved off the uniform pmf
    pdf = state.tile_pdf.numpy()
    assert np.abs(pdf - 0.5).max() > 0.05

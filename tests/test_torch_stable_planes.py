"""Stable planes and the stable-planes frame against the JAX package, on
the CPU.

The scene is the glass-over-mirror Cornell box of
tests/test_stable_planes.py:120-127 (planes 1 and 2 exist there), 32x32:

  * `decompose` (the BUILD pass) against the JAX decompose on the same
    camera rays, the first frame's jittered ones (as
    render_frame_stable_planes draws them): valid, branch_id, nverts and
    vb_prim equal on every lane, every float field within 1e-4. (Through
    pixel centres this symmetric box's rays land on quad diagonals, where
    the two packages' brute-force tests, summing in other orders, break
    the tie between the quad's triangles differently: 3 of 1,024 lanes;
    tests/test_torch_bvh.py allows 0.1% of such lanes.);
  * `render_frame_stable_planes` against the JAX package's over two frames
    with a moving camera, the first without denoiser, the second with
    RELAX and TAA on the state the first left (the JAX state carried into
    the port by `realtime.state_from_numpy` before the second frame, so
    its previous camera drives the reprojection): hdr and the image within
    rtol = atol = 2e-3, and the denoiser's new history. Both packages'
    fills run on the general tier (kernel_tier="xla"): the JAX fused tier
    runs only in interpret mode here, and tests/test_torch_vbuffer.py
    holds the fused restart;
  * the general tier's trace_paths with first_hit, bounce_budget and
    first_direct=False against the JAX general tier on plane 1's V-buffer
    (L and the aux buffers within 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.accel.traverse import Hit as JHit
from rtxpt_tpu.config import DenoiserMode as JDen
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.config import RenderConfig as JRC
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.pt import realtime as jrt
from rtxpt_tpu.pt.stable_planes import decompose as j_decompose
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.scene.camera import look_at as j_look_at
from rtxpt_tpu_torch.config import DenoiserMode, PathTracerConfig, RenderConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import realtime
from rtxpt_tpu_torch.pt.integrator import (
    _pixel_grid, camera_rays, trace_paths)
from rtxpt_tpu_torch.pt.stable_planes import decompose
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.scene.camera import look_at

SIDE = 32
BOUNCES = 3
TOL = 2e-3
FIELD_TOL = 1e-4
INT_FIELDS = ("valid", "branch_id", "nverts", "vb_prim")
AUX = ("albedo", "normal", "depth", "wpos", "emission")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_glass_mirror():
    host = JP.cornell_box()
    mats = host.materials
    host.materials = mats.replace(
        transmission=mats.transmission.at[4].set(1.0),
        roughness=mats.roughness.at[4].set(0.0).at[3].set(0.0),
        metallic=mats.metallic.at[3].set(1.0))
    return host


@pytest.fixture(scope="module")
def scenes():
    th = TP.glass_mirror_cornell()
    return th, prepare(th, device="cpu"), j_prepare(_jax_glass_mirror())


def _cams(host, frame):
    """Both packages' cameras of `frame`: the host's camera moved sideways
    by 0.01 a frame."""
    c = host.camera
    shift = np.array([0.01 * frame, 0.0, 0.0])
    pos = np.asarray(c["position"]) + shift
    tgt = np.asarray(c["target"]) + shift
    args = (pos, tgt, c["up"], c["fov_y_deg"], SIDE, SIDE)
    return look_at(*args), j_look_at(*args)


@pytest.fixture(scope="module")
def planes(scenes):
    th, ts, js = scenes
    cam, _ = _cams(th, 0)
    px, py = _pixel_grid(SIDE, SIDE)
    o, d, _ = camera_rays(cam, PathTracerConfig(), px, py, 0)
    o, d = o.contiguous(), d.contiguous()
    tp, tbg = decompose(ts, o, d)
    jp, jbg = j_decompose(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    return tp, tbg, jp, jbg


@pytest.mark.parametrize("index", [0, 1, 2])
def test_decompose_matches_jax(planes, index):
    tp, tbg, jp, jbg = planes
    np.testing.assert_array_equal(tbg.numpy(), np.asarray(jbg))
    t, j = tp[index], jp[index]
    for field in t._fields:
        a, b = getattr(t, field).numpy(), np.asarray(getattr(j, field))
        if field in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            np.testing.assert_allclose(a, b, rtol=FIELD_TOL, atol=FIELD_TOL,
                                       err_msg=field)
    assert t.valid.any(), "the glass-over-mirror box has every plane"
    if index:
        assert (t.branch_id[t.valid] > 4).all()   # a fork's 4-ary code


def _numpy_state(state):
    return jax.tree.map(lambda x: np.asarray(x) if isinstance(
        x, jax.Array) else x, state)


def test_stable_planes_frames_match_jax(scenes):
    th, ts, js = scenes
    kw = dict(max_bounces=BOUNCES, kernel_tier="xla")
    tcfg, jcfg = PathTracerConfig(**kw), JConfig(**kw)
    jstate = jrt.init_state(SIDE, SIDE)
    tstate = realtime.init_state(SIDE, SIDE, device="cpu")
    for frame, den in enumerate(("NONE", "RELAX")):
        rk = dict(width=SIDE, height=SIDE, tonemap="aces",
                  enable_taa=den == "RELAX")
        trc = RenderConfig(denoiser=DenoiserMode[den], **rk)
        jrc = JRC(denoiser=JDen[den], **rk)
        tcam, jcam = _cams(th, frame)
        if frame == 1:
            # the JAX history carried into the port
            tstate = realtime.state_from_numpy(_numpy_state(jstate), "cpu")
            assert tstate.prev_camera is not None
        jimg, jhdr, jstate = jrt.render_frame_stable_planes(
            js, jcam, jcfg, jrc, jstate)
        timg, thdr, tstate = realtime.render_frame_stable_planes(
            ts, tcam, tcfg, trc, tstate)
        np.testing.assert_allclose(thdr.numpy(), np.asarray(jhdr), rtol=TOL,
                                   atol=TOL, err_msg=f"frame {frame}")
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=TOL,
                                   atol=TOL, err_msg=f"frame {frame}")
    assert tstate.frame_index == 2 and float(thdr.mean()) > 0.0
    assert tstate.motion.abs().max() > 0.1         # the camera moved
    for tp, jp in ((tstate.denoiser, jstate.denoiser),
                   (tstate.denoiser_p1, jstate.denoiser_p1)):
        for name, a, b in zip(tp._fields, tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL, err_msg=name)


def test_general_tier_restart_matches_jax(scenes, planes):
    """trace_paths on the general tier from plane 1's V-buffer with its
    budget and first_direct=False, against the JAX general tier."""
    th, ts, js = scenes
    tp, _, _, _ = planes
    p = tp[1]
    n = SIDE * SIDE
    px, py = _pixel_grid(SIDE, SIDE)
    spread = torch.full((n,), 1e-3)
    budget = torch.where(p.valid, torch.clamp(BOUNCES - p.nverts, min=0), 0)
    fh = p.vbuffer(1e27)
    kw = dict(max_bounces=BOUNCES, kernel_tier="xla")
    out = trace_paths(ts, PathTracerConfig(**kw), p.o, p.d, spread, px, py,
                      7, want_aux=True, first_hit=fh, bounce_budget=budget,
                      first_direct=False)
    j = {k: jnp.asarray(v.numpy()) for k, v in dict(
        o=p.o, d=p.d, spread=spread, px=px, py=py).items()}
    ref = jint.trace_paths(
        js, JConfig(**kw), j["o"], j["d"], j["spread"], j["px"], j["py"],
        jnp.uint32(7), want_aux=True,
        first_hit=JHit(t=jnp.asarray(fh.t.numpy()),
                       prim=jnp.asarray(fh.prim.numpy()),
                       bary=jnp.asarray(fh.bary.numpy()),
                       front=jnp.asarray(fh.front.numpy())),
        bounce_budget=jnp.asarray(budget.numpy()), first_direct=False)
    for k in ("L",) + AUX:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert out["L"][p.valid].max() > 0.0

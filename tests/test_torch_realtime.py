"""Real-time mode's image passes and frames against the JAX package, on
the CPU.

  * `denoise` (ReLAX), `denoise_reblur`, `taa_resolve`, `bloom`,
    `motion_vectors`, `project`, `_upscale_bilinear` and `_halton` on the
    same seeded 32x48 inputs (numpy, the denoiser history and the camera
    carried into both): within atol 1e-5 (and rtol 1e-6: the demodulated history
    reaches hundreds where the albedo is small, and float32 keeps seven
    digits);
  * `render_frame` over three frames with a moving camera, RELAX, TAA,
    bloom, split_denoise and render_scale 0.5 (64x96 on the display, the
    denoisers at 32x48), the JAX state carried into the port by
    `realtime.state_from_numpy` before each frame: hdr and the image
    within rtol = atol = 2e-3. Both packages trace on the general tier
    (kernel_tier="xla"; the JAX fused tier runs only in interpret mode
    here);
  * the CLI's `--realtime 2 --stable-planes --taa` on the CPU;
  * ReSTIR, ReGIR and the pipelined driver refused by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import DenoiserMode as JDen
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.config import RenderConfig as JRC
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import realtime as jrt
from rtxpt_tpu.render import denoise as jdn
from rtxpt_tpu.render import taa as jtaa
from rtxpt_tpu.scene import camera as jcam
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.apps import cli
from rtxpt_tpu_torch.config import DenoiserMode, PathTracerConfig, RenderConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import realtime
from rtxpt_tpu_torch.render import denoise as dn
from rtxpt_tpu_torch.render import taa
from rtxpt_tpu_torch.scene import camera as tcam
from rtxpt_tpu_torch.scene import procedural as TP

H, W = 32, 48
ATOL = 1e-5
RTOL = 1e-6                  # float32 rounding of the demodulated history,
#                              whose values reach hundreds where the albedo
#                              is small
TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    """Seeded guide buffers and history of a 32x48 frame: a depth ramp with
    a step (a disocclusion edge), unit normals, motion of a few pixels
    (some leaving the frame)."""
    rng = np.random.default_rng(12)
    f32 = np.float32
    depth = (2.0 + np.linspace(0, 1, W)[None, :] + np.zeros((H, 1))
             ).astype(f32)
    depth[:, W // 2:] += 1.5
    depth[3:6, 5:9] = 0.0                        # misses
    n = rng.normal(size=(H, W, 3)).astype(f32) * 0.2 + [0, 0, 1]
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(f32)
    hist = jdn.DenoiserState(
        color=rng.random((H, W, 3), f32), moments=rng.random((H, W, 2), f32),
        depth=depth + rng.normal(0, 0.05, (H, W)).astype(f32),
        normal=normal, history_len=rng.integers(0, 8, (H, W)).astype(f32))
    return dict(radiance=(rng.random((H, W, 3), f32) * 2.0),
                albedo=rng.random((H, W, 3), f32), normal=normal,
                depth=depth, motion=rng.normal(0, 2.5, (H, W, 2)).astype(f32),
                hist=hist)


def _j(x):
    return jnp.asarray(x)


def _close(a, b, atol=ATOL, msg=""):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("which", ["relax", "reblur"])
def test_denoisers_match_jax(images, which):
    args = [images[k] for k in ("radiance", "albedo", "normal", "depth",
                                "motion")]
    jf, tf = dict(relax=(jdn.denoise, dn.denoise),
                  reblur=(jdn.denoise_reblur, dn.denoise_reblur))[which]
    for hist in (None, images["hist"]):
        jout, jst = jf(*map(_j, args), None if hist is None else
                       jdn.DenoiserState(*map(_j, hist)))
        tst = None if hist is None else dn.state_from_numpy(hist, "cpu")
        tout, tst = tf(*map(torch.from_numpy, args), tst)
        _close(tout, jout, msg=which)
        for name, a, b in zip(dn.DenoiserState._fields, tst, jst):
            _close(a, b, msg=f"{which} {name}")
    assert not torch.allclose(tout, torch.from_numpy(images["radiance"]))


def test_taa_and_bloom_match_jax(images):
    color = images["radiance"]
    hist = images["hist"].color
    jout, jh = jtaa.taa_resolve(_j(color), _j(images["motion"]), _j(hist))
    tout, th = taa.taa_resolve(torch.from_numpy(color),
                               torch.from_numpy(images["motion"]),
                               torch.from_numpy(hist))
    _close(tout, jout)
    _close(th, jh)
    first, _ = taa.taa_resolve(torch.from_numpy(color),
                               torch.from_numpy(images["motion"]), None)
    assert torch.equal(first, torch.from_numpy(color))
    hdr = color * 3.0
    _close(taa.bloom(torch.from_numpy(hdr)), jtaa.bloom(_j(hdr)))


def test_camera_passes_match_jax(images):
    """project, motion_vectors and _upscale_bilinear."""
    rng = np.random.default_rng(3)
    args = ([0.1, 1.0, 3.0], [0.0, 0.9, 0.0], [0, 1, 0], 45.0, W, H)
    tc, jc = tcam.look_at(*args), jcam.look_at(*args)
    wpos = (rng.random((H, W, 3)) * [2, 2, 1] - [1, 0, 0.5]).astype(
        np.float32)
    wpos[0, :4] = [0.1, 1.0, 4.0]                # behind the camera
    tp, jp = tcam.project(tc, torch.from_numpy(wpos)), jcam.project(
        jc, _j(wpos))
    for a, b in zip(tp[:2], jp[:2]):
        _close(a, b, atol=1e-4 * 100)            # pixels, |p| <= ~100
    np.testing.assert_array_equal(tp[2].numpy(), np.asarray(jp[2]))
    assert tp[2].any() and not tp[2].all()
    depth = images["depth"]
    tm = realtime.motion_vectors(tc, torch.from_numpy(wpos),
                                 torch.from_numpy(depth), W, H)
    jm = jrt.motion_vectors(jc, _j(wpos), _j(depth), W, H)
    _close(tm, jm, atol=1e-2)
    assert torch.equal(realtime.motion_vectors(
        None, torch.from_numpy(wpos), torch.from_numpy(depth), W, H),
        torch.zeros((H, W, 2)))
    for img in (images["radiance"][:16, :24], depth[:16, :24]):
        _close(realtime._upscale_bilinear(torch.from_numpy(img), H, W),
               jrt._upscale_bilinear(_j(img), H, W))
    # the TAA jitter's Halton sequence (ReSTIR's; kept with the module)
    for i in range(1, 65):
        assert realtime._halton(i, 2) == jrt._halton(i, 2)
        assert realtime._halton(i, 3) == jrt._halton(i, 3)


def _numpy_state(state):
    return jax.tree.map(lambda x: np.asarray(x) if isinstance(
        x, jax.Array) else x, state)


def _cams(host, frame, w, h):
    c = host.camera
    shift = np.array([0.01 * frame, 0.0, 0.0])
    args = (np.asarray(c["position"]) + shift,
            np.asarray(c["target"]) + shift, c["up"], c["fov_y_deg"], w, h)
    return tcam.look_at(*args), jcam.look_at(*args)


def test_render_frame_matches_jax():
    th, jh = TP.cornell_box(), JP.cornell_box()
    ts, js = prepare(th, device="cpu"), j_prepare(jh)
    kw = dict(max_bounces=1, kernel_tier="xla")
    rk = dict(width=2 * W, height=2 * H, tonemap="aces", enable_taa=True,
              enable_bloom=True, split_denoise=True, render_scale=0.5)
    trc = RenderConfig(denoiser=DenoiserMode.RELAX, **rk)
    jrc = JRC(denoiser=JDen.RELAX, **rk)
    jstate = jrt.init_state(2 * H, 2 * W)
    for frame in range(3):
        tstate = realtime.state_from_numpy(_numpy_state(jstate), "cpu")
        tc, jc = _cams(th, frame, 2 * W, 2 * H)
        jimg, jhdr, jstate = jrt.render_frame(js, jc, JConfig(**kw), jrc,
                                              jstate)
        timg, thdr, tstate = realtime.render_frame(ts, tc,
                                                   PathTracerConfig(**kw),
                                                   trc, tstate)
        assert thdr.shape == (2 * H, 2 * W, 3)
        np.testing.assert_allclose(thdr.numpy(), np.asarray(jhdr), rtol=TOL,
                                   atol=TOL, err_msg=f"frame {frame}")
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=TOL,
                                   atol=TOL, err_msg=f"frame {frame}")
        # the state keeps the render-size camera (realtime.py:250-253)
        assert float(tstate.prev_camera.width) == W
    assert tstate.motion.abs().max() > 0.5 and tstate.frame_index == 3
    np.testing.assert_allclose(tstate.taa_history.numpy(),
                               np.asarray(jstate.taa_history), rtol=TOL,
                               atol=TOL)


def test_cli_realtime_stable_planes(tmp_path):
    out = tmp_path / "rt.png"
    hdr = tmp_path / "rt.npy"
    assert cli.main(["--scene", "cornell", "--device", "cpu", "--width",
                     "16", "--height", "12", "--bounces", "2", "--realtime",
                     "2", "--stable-planes", "--taa", "--out", str(out),
                     "--hdr", str(hdr)]) == 0
    img = np.load(hdr)
    assert out.exists() and img.shape == (12, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0


@pytest.mark.parametrize("flags", [["--restir", "di"], ["--restir", "digi"],
                                   ["--regir"], ["--pipelined"]])
def test_cli_refuses_restir(flags, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--realtime", "1"] + flags)
    assert flags[0] in capsys.readouterr().err


@pytest.mark.parametrize("fn", ["render_frame", "render_frame_stable_planes"])
def test_frames_refuse_restir(fn):
    th = TP.cornell_box()
    ts = prepare(th, device="cpu")
    rc = RenderConfig(width=8, height=8, restir="di")
    with pytest.raises(NotImplementedError, match="ReSTIR"):
        getattr(realtime, fn)(ts, TP.default_camera(th, 8, 8),
                              PathTracerConfig(max_bounces=1), rc,
                              realtime.init_state(8, 8, device="cpu"))

"""End to end on the CPU: the port's render against the golden image and
against the JAX package's fused tier (Pallas kernel in interpret mode),
two analytic checks, and the CLI."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.render import postprocess as jpost
from rtxpt_tpu.scene.procedural import default_camera as j_default_camera
from rtxpt_tpu_torch.apps import cli
from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt.integrator import render, render_sample
from rtxpt_tpu_torch.render.postprocess import tonemap
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.utils.image import psnr, rmse

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cornell_32_8spp.npy")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores, and oversubscribed
    threads made the small ops of the CPU renders several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell():
    host = TP.cornell_box()
    return host, prepare(host, device="cpu")


def test_golden_cornell(cornell):
    """The golden's own limits (tests/test_harness.py:41-42)."""
    host, scene = cornell
    cam = TP.default_camera(host, 32, 32)
    hdr, aux, rays = render(scene, cam, PathTracerConfig(max_bounces=3),
                            32, 32, spp=8)
    img = hdr.numpy()
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert rmse(img, golden) < 5e-3
    assert psnr(img, golden) > 40
    assert aux == {} and rays > 32 * 32 * 8


def test_render_sample_matches_jax_fused_tier(cornell, cornell_scene):
    """One 16x16 sample against the JAX fused tier (Pallas interpret mode):
    the same radiance at rtol = atol = 2e-3 and the same ray count."""
    host, scene = cornell
    jhost, jscene = cornell_scene
    w = h = 16
    jcfg = JConfig(max_bounces=3, kernel_tier="fused", pallas_interpret=True)
    ref = jint.render_sample(jscene, j_default_camera(jhost, w, h), jcfg, w,
                             h, jnp.uint32(1))
    out = render_sample(scene, TP.default_camera(host, w, h),
                        PathTracerConfig(max_bounces=3), w, h, 1)
    assert out["kernel_tier"] == "torch"
    np.testing.assert_allclose(out["L"].numpy(), np.asarray(ref["L"]),
                               rtol=2e-3, atol=2e-3)
    assert int(out["ray_count"]) == int(ref["ray_count"])
    np.testing.assert_array_equal(out["occupancy"].numpy(),
                                  np.asarray(ref["occupancy"]))


def test_render_sample_chunking_matches_single_chunk(cornell):
    """Chunks of rays (last one padded) give the same image as one chunk;
    the padded lanes count in ray_count as in the JAX package."""
    host, scene = cornell
    cam = TP.default_camera(host, 12, 10)
    cfg = PathTracerConfig(max_bounces=2)
    one = render_sample(scene, cam, cfg, 12, 10, 4)
    chunked = render_sample(scene, cam, cfg, 12, 10, 4, chunk=32)
    torch.testing.assert_close(chunked["L"], one["L"], rtol=0, atol=0)
    assert int(chunked["ray_count"]) >= int(one["ray_count"])


def test_furnace_converges():
    """Closed box of albedo 0.8 and emission 0.5: L -> 0.5 / (1 - 0.8) as
    bounces grow; 16 bounces without RR reach 2.5 * (1 - 0.8^16) plus
    part of the next term."""
    host = TP.furnace_box(albedo=0.8, emission=0.5)
    scene = prepare(host, device="cpu")
    cam = TP.default_camera(host, 8, 8)
    cfg = PathTracerConfig(max_bounces=16, enable_russian_roulette=False)
    hdr, _, _ = render(scene, cam, cfg, 8, 8, spp=4)
    lo = 2.5 * (1 - 0.8 ** 16)
    hi = 2.5 * (1 - 0.8 ** 17)
    assert lo * 0.99 < float(hdr.mean()) < hi * 1.01


def test_point_light_analytic():
    """A Lambertian triangle under a point light: the centre pixel is
    albedo/pi * I/d^2 with I = 10 at d = 2."""
    host = TP.single_triangle("point")
    host.materials = host.materials.replace(
        specular_f0_scale=torch.zeros(1))
    scene = prepare(host, device="cpu")
    cam = TP.default_camera(host, 17, 17)
    hdr, _, _ = render(scene, cam, PathTracerConfig(max_bounces=1), 17, 17,
                       spp=4)
    want = np.asarray([0.8, 0.6, 0.4]) / np.pi * 10.0 / 4.0
    np.testing.assert_allclose(hdr[8, 8].numpy(), want, rtol=1e-2)


@pytest.mark.parametrize("curve", ["aces", "reinhard", "linear", "none"])
def test_tonemap_matches_jax(curve):
    hdr = np.random.default_rng(3).exponential(0.5, (16, 16, 3)).astype(
        np.float32)
    want = jpost.tonemap(jnp.asarray(hdr), 1.7, curve)
    got = tonemap(torch.from_numpy(hdr), 1.7, curve)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cli_writes_png(tmp_path):
    from PIL import Image

    out = tmp_path / "cornell.png"
    hdr = tmp_path / "cornell.npy"
    assert cli.main(["--scene", "cornell", "--device", "cpu", "--width", "16",
                     "--height", "16", "--spp", "1", "--out", str(out),
                     "--hdr", str(hdr)]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert np.load(hdr).shape == (16, 16, 3)


def test_cli_renders_rooms_through_external_nee(tmp_path):
    """The CLI's external-NEE route: NEE-AT with two WRS candidates."""
    from PIL import Image

    out = tmp_path / "rooms.png"
    assert cli.main(["--scene", "rooms", "--nee", "neeat", "--candidates",
                     "2", "--bounces", "2", "--device", "cpu", "--width",
                     "16", "--height", "16", "--spp", "1", "--out",
                     str(out)]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_render_refuses_sample_indices_past_index_space(cornell):
    host, scene = cornell
    cam = TP.default_camera(host, 4, 4)
    with pytest.raises(ValueError, match="index space"):
        render(scene, cam, PathTracerConfig(max_bounces=1), 4, 4, spp=2,
               first_sample=(1 << 16) - 1)

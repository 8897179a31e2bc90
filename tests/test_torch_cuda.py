"""The CUDA kernels on the card: each against its plain PyTorch version on
the same CUDA inputs, and the wrapper's launch count and checks. Needs an
NVIDIA GPU and nvcc; skips without them. This file imports no JAX, so it
runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays, render
from rtxpt_tpu_torch.scene import procedural as TP

pytestmark = pytest.mark.cuda

TOL = 2e-3


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def cornell(gpu):
    host = TP.cornell_box()
    return host, prepare(host, device=gpu)


def _state(host, cfg, side, device, sample):
    cam = TP.default_camera(host, side, side, device=device)
    px, py = _pixel_grid(side, side, device)
    o, d, spread = camera_rays(cam, cfg, px, py, sample)
    return bf.initial_state(o, d, spread, px, py)


CONFIGS = {
    "power": (TP.cornell_box, {}, {}),
    "uniform_nomis": (TP.cornell_box, {},
                      dict(nee=NEEMode.UNIFORM, enable_mis=False)),
    "off_hash": (TP.cornell_box, {},
                 dict(nee=NEEMode.OFF, low_discrepancy=False)),
    "specular_firefly_noec": (TP.cornell_box, dict(sphere_specular=True),
                              dict(firefly_clamp=2.0,
                                   kernel_energy_comp=False)),
    "furnace_norr": (TP.furnace_box, dict(albedo=0.8, emission=0.5),
                     dict(enable_russian_roulette=False)),
    "triangle_point": (TP.single_triangle, dict(light_kind="point"), {}),
    "triangle_directional": (TP.single_triangle,
                             dict(light_kind="directional"), {}),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_k1_matches_plain_version(gpu, name):
    make, host_kw, cfg_kw = CONFIGS[name]
    host = make(**host_kw)
    scene = prepare(host, device=gpu)
    cfg = PathTracerConfig(max_bounces=5, **cfg_kw)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    for b in range(4):
        plain = bf.bounce_reference(fs, is_, scene.bounce_tables, kcfg, 2)
        kern = bf.bounce(fs, is_, scene.bounce_tables, kcfg, 2)
        torch.cuda.synchronize()
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        assert same.float().mean() >= 0.999
        for k, p in ((kern[0], plain[0]), (kern[2], plain[2])):
            ok = torch.isclose(k, p, rtol=TOL, atol=TOL, equal_nan=True)
            assert ok.float().mean(1).min() >= 0.999, b
        fs, is_ = plain[0], plain[1]


def test_launch_counter_counts_each_launch(cornell):
    host, scene = cornell
    fs, is_ = _state(host, PathTracerConfig(), 16, scene.bounce_tables.device,
                     0)
    before = kernels.launches["bounce_fused"]
    bf.bounce(fs, is_, scene.bounce_tables, bf.KernelConfig(), 0)
    assert kernels.launches["bounce_fused"] == before + 1


def test_render_runs_every_bounce_through_k1(cornell):
    host, scene = cornell
    cam = TP.default_camera(host, 32, 32)
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, PathTracerConfig(max_bounces=3), 32,
                          32, spp=2)
    assert kernels.launches["bounce_fused"] == 3 * 2
    assert torch.isfinite(hdr).all() and rays > 0


def test_wrapper_refuses_tables_on_another_device(cornell):
    host, scene = cornell
    cpu_tables = prepare(host).bounce_tables
    fs, is_ = _state(host, PathTracerConfig(), 8, scene.bounce_tables.device,
                     0)
    with pytest.raises(ValueError, match="expected cuda"):
        bf.bounce(fs, is_, cpu_tables, bf.KernelConfig(), 0)

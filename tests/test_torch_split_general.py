"""The split channels and the aux guide buffers on the general tier
against the JAX package, and the clustered tier's other routes with the
split, on the CPU.

  * The JAX general tier ("xla") renders the Cornell box at 24x24, 3
    bounces, power NEE, `split_channels=True` and `want_aux=True`; the
    port's general tier against it: relative RMSE < 2e-3 for L, L_diff
    and L_spec, the partition |L - emission - L_diff - L_spec| < 2e-2
    (tests/test_split_hot_tiers.py:29-41), every aux key within
    rtol = atol = 1e-3 (tests/test_bounce_pallas.py:82-83), equal ray
    counts, and L the same with and without the split.
  * The clustered external route (K4's export, external_nee's cdiff, K5;
    WRS over 4 candidates) on the small city and the instanced tables
    (procedural.instanced_city(2, 6)) with the split: the partition
    holds, and L is the same with and without it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import render_sample
from rtxpt_tpu_torch.scene import procedural as TP

W = H = 24
SAMPLE = 1
BOUNCES = 3
RMSE = 2e-3
PARTITION = 2e-2
AUX_TOL = 1e-3
AUX = ("albedo", "albedo_diff", "albedo_spec", "normal", "depth", "wpos",
       "emission")
BASE = dict(max_bounces=BOUNCES, split_channels=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_partition(out):
    got = {k: v.numpy() for k, v in out.items()
           if isinstance(v, torch.Tensor)}
    for k in ("L", "L_diff", "L_spec"):
        assert np.isfinite(got[k]).all(), k
    resid = np.abs(got["L"] - got["emission"] - got["L_diff"]
                   - got["L_spec"])
    assert resid.max() < PARTITION, resid.max()
    assert got["L_diff"].mean() > 0 and got["L_spec"].mean() > 0
    return got


def _rel_rmse(a, b):
    return np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)),
                                                1e-9)


def test_general_render_matches_jax_general_tier():
    jh = JP.cornell_box()
    ref = jint.render_sample(
        j_prepare(jh), JP.default_camera(jh, W, H),
        JConfig(nee=JNEE.POWER, kernel_tier="xla", **BASE), W, H,
        jnp.uint32(SAMPLE), want_aux=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    th = TP.cornell_box()
    ts = prepare(th, device="cpu")
    cam = TP.default_camera(th, W, H)
    out = render_sample(ts, cam, PathTracerConfig(
        nee=NEEMode.POWER, kernel_tier="xla", **BASE), W, H, SAMPLE,
        want_aux=True)
    assert out["kernel_tier"] == "xla"
    got = _check_partition(out)
    for k in ("L", "L_diff", "L_spec"):
        assert _rel_rmse(got[k], ref[k]) < RMSE, k
    for k in AUX:
        np.testing.assert_allclose(got[k], ref[k], rtol=AUX_TOL,
                                   atol=AUX_TOL, err_msg=k)
    assert int(out["ray_count"]) == int(ref["ray_count"])
    plain = render_sample(ts, cam, PathTracerConfig(
        nee=NEEMode.POWER, kernel_tier="xla", max_bounces=BOUNCES), W, H,
        SAMPLE)
    assert torch.equal(plain["L"], out["L"])


@pytest.fixture(scope="module")
def city():
    th = TP.city_scene(tri_budget=4000, seed=1, blocks=2)
    th.camera = dict(position=[10.0, 16.0, 24.0], target=[10.0, 2.0, 10.0],
                     up=[0.0, 1.0, 0.0], fov_y_deg=30.0)
    return th, prepare(th, device="cpu")


@pytest.mark.parametrize("case", ["external", "instanced"])
def test_clustered_split_on_the_external_route_and_instanced(city, case):
    """The external route (K4's export, external_nee's cdiff, K5) and the
    instanced tables serve the split: the partition holds, and the split
    leaves L as it is."""
    if case == "external":
        th, ts = city
        kw = dict(nee_candidates=4)
    else:
        th = TP.instanced_city(grid=2, subdiv=6)
        ts = prepare(th, device="cpu")
        assert ts.cluster_tables.instanced
        kw = {}
    cam = TP.default_camera(th, 16, 16)
    cfg = dispatch.resolve(ts, PathTracerConfig(**BASE, **kw), "cpu")
    assert cfg.kernel_tier == "clustered"
    assert cfg.nee_external == (case == "external")
    out = render_sample(ts, cam, cfg, 16, 16, SAMPLE, want_aux=True)
    _check_partition(out)
    plain = render_sample(ts, cam, dataclasses.replace(
        cfg, split_channels=False), 16, 16, SAMPLE)
    assert torch.equal(plain["L"], out["L"])

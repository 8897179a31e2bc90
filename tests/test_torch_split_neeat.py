"""NEE-AT with the split channels on the fused tier against the JAX
package, on the CPU.

K1's slot 3 with the split rows, external_nee's `cdiff` and the deferred
emission that `bounce_fused.external_split` files in the first scatter's
channel: four rooms (rooms_scene(4): 144 triangles, eight emissive panel
triangles, each room lit by its own panel) at 32x32 (the JAX
external_nee takes whole 1,024-lane chunks), 3 bounces, `want_aux`, from
a uniform tile state, against the JAX fused tier with the same state (in
interpret mode, one 128-lane row per block): relative RMSE < 2e-3 for L,
L_diff and L_spec, the partition |L - emission - L_diff - L_spec| < 2e-2
(tests/test_split_hot_tiers.py:29-41), every aux key within
rtol = atol = 1e-3 (tests/test_bounce_pallas.py:82-83).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.lighting import neeat as jna
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.lighting import neeat as tna
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import render_sample
from rtxpt_tpu_torch.scene import procedural as TP

W = H = 32
SAMPLE = 1
RMSE = 2e-3
PARTITION = 2e-2
AUX_TOL = 1e-3
AUX = ("albedo", "albedo_diff", "albedo_spec", "normal", "depth", "wpos",
       "emission")


@pytest.fixture(autouse=True)
def _one_torch_thread_and_jax_row(monkeypatch):
    """One intra-op thread for the torch ops (the test run puts several
    test processes on the machine's cores), and one row per block of the
    JAX fused tier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(bp, "_R", 1)
    yield
    torch.set_num_threads(n)


def _rel_rmse(a, b):
    return np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)),
                                                1e-9)


def test_fused_neeat_split_matches_jax_fused_tier():
    jh, th = JP.rooms_scene(4), TP.rooms_scene(4)
    js, ts = j_prepare(jh), prepare(th, device="cpu")
    base = dict(max_bounces=3, split_channels=True)
    ref = jint.render_sample(
        js, JP.default_camera(jh, W, H),
        JConfig(nee=JNEE.NEEAT, kernel_tier="fused", pallas_interpret=True,
                **base), W, H, jnp.uint32(SAMPLE), want_aux=True,
        neeat_state=jna.init_state(W, H, js.lights.count))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    state = tna.init_state(W, H, ts.lights.count, device="cpu")
    cfg = PathTracerConfig(nee=NEEMode.NEEAT, **base)
    resolved = dispatch.resolve(ts, cfg, "cpu", state)
    assert resolved.kernel_tier == "torch" and resolved.nee_external
    out = render_sample(ts, TP.default_camera(th, W, H), cfg, W, H, SAMPLE,
                        want_aux=True, neeat_state=state)
    got = {k: v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    for k in ("L", "L_diff", "L_spec"):
        assert np.isfinite(got[k]).all(), k
        assert _rel_rmse(got[k], ref[k]) < RMSE, (k, _rel_rmse(got[k],
                                                               ref[k]))
    resid = np.abs(got["L"] - got["emission"] - got["L_diff"]
                   - got["L_spec"])
    assert resid.max() < PARTITION, resid.max()
    assert got["L_diff"].mean() > 0 and got["L_spec"].mean() > 0
    for k in AUX:
        np.testing.assert_allclose(got[k], ref[k], rtol=AUX_TOL,
                                   atol=AUX_TOL, err_msg=k)
    assert int(out["ray_count"]) == int(ref["ray_count"])

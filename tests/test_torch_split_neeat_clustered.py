"""NEE-AT with the split channels on the clustered tier against the JAX
package, on the CPU.

K4's slot 3 with the split rows, the SH_CDIFF rows filled from
external_nee's `cdiff`, and the deferred emission of the lanes past their
first vertex filed in the first scatter's channel by
`trace_paths_clustered`: four closed rooms (rooms_scene(4, subdiv=8):
2,184 triangles, so the clustered tier; each room lit by its own
emissive panel) at 24x16, 2 bounces, `want_aux`, from a uniform tile
state, against the JAX clustered tier with the same state (interpret
mode, the bounces unrolled). The JAX `_kernel_a2` computes the SF_*
export rows but never stores them (ROADMAP F8: every pixel of its NEE-AT
render is NaN), so its launches here are given the rows its own
`surface_and_shade` computes on the launch's inputs, as `_kernel_a2`
calls it. Bounds:
relative RMSE < 2e-3 for L, L_diff and L_spec, the partition
|L - emission - L_diff - L_spec| < 2e-2 (tests/test_split_hot_tiers.py
:29-41), every aux key within rtol = atol = 1e-3
(tests/test_bounce_pallas.py:82-83), equal ray counts.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.lighting import neeat as jna
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.lighting import neeat as tna
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import render_sample
from rtxpt_tpu_torch.scene import procedural as TP

W, H = 24, 16
SAMPLE = 1
KSLOTS = 64
RMSE = 2e-3
PARTITION = 2e-2
AUX_TOL = 1e-3
AUX = ("albedo", "albedo_diff", "albedo_spec", "normal", "depth", "wpos",
       "emission")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the torch ops: the test run puts several
    test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k4_with_surf_rows(jt):
    """`_kernel_a2_call` with the SF_* rows that `_kernel_a2` computes but
    never stores put in its output: `surface_and_shade` on the launch's
    own inputs, as `_kernel_a2` calls it (bounce_clustered.py:566-584)."""
    k4 = JBC._kernel_a2_call

    @partial(jax.jit, static_argnums=0)
    def surf_rows(key, scal, ha, fs, is_, fs2):
        def attr(i, k=1):
            return ha[JBC.HA_ATTR + i] if k == 1 else \
                ha[JBC.HA_ATTR + i:JBC.HA_ATTR + i + k]
        t = ha[JBC.HA_T]
        return bp.surface_and_shade(
            o=fs[0:3], d=fs[3:6], t=t, hit=t < bp._BIG,
            front=ha[JBC.HA_FRONT] > 0.0, bu=ha[JBC.HA_U], bv=ha[JBC.HA_V],
            attr=attr, thp=fs[6:9], L=fs[9:12], prev_pdf=fs[12],
            active=is_[0] > 0, prev_delta=is_[1] > 0, med0=is_[2],
            med1=is_[3], px=is_[4], py=is_[5], sample_idx=scal[0, 0],
            bounce=scal[0, 1].astype(jnp.int32), mat_ref=jt.mat_rows,
            light_ref=jt.light_rows, cfg_key=key, n_lights=jt.n_lights,
            first_emissive=True, cone=fs[13], spread=fs[14], budget=is_[6],
            ld=fs2[0:3], ls=fs2[3:6], fspec=fs2[6], lbounce=is_[7])["surf"]

    def call(*args, **kw):
        out = k4(*args, **kw)
        if kw.get("final_env") or len(out) < 6:
            return out
        surf = surf_rows(args[9], *args[:4], kw["fs2"])
        return tuple(out[:4]) + (surf.reshape(out[4].shape),) \
            + tuple(out[5:])
    return call


def _rel_rmse(a, b):
    return np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)),
                                                1e-9)


def test_clustered_neeat_split_matches_jax_clustered_tier(monkeypatch):
    jh, th = JP.rooms_scene(4, subdiv=8), TP.rooms_scene(4, subdiv=8)
    js, ts = j_prepare(jh), prepare(th, device="cpu")
    base = dict(max_bounces=2, split_channels=True)
    monkeypatch.setattr(JBC, "_SCAN", False)
    monkeypatch.setattr(JBC, "_kernel_a2_call",
                        _k4_with_surf_rows(js.cluster_tables))
    ref = jint.render_sample(
        js, JP.default_camera(jh, W, H),
        JConfig(nee=JNEE.NEEAT, kernel_tier="clustered",
                pallas_interpret=True, cluster_kslots=KSLOTS, **base), W, H,
        jnp.uint32(SAMPLE), want_aux=True,
        neeat_state=jna.init_state(W, H, js.lights.count))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    state = tna.init_state(W, H, ts.lights.count, device="cpu")
    cfg = PathTracerConfig(nee=NEEMode.NEEAT, **base)
    resolved = dispatch.resolve(ts, cfg, "cpu", state)
    assert resolved.kernel_tier == "clustered" and resolved.nee_external
    out = render_sample(ts, TP.default_camera(th, W, H), cfg, W, H, SAMPLE,
                        want_aux=True, neeat_state=state)
    assert out["kernel_tier"] == "clustered"
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

"""The split channels and the aux guide buffers on the clustered tier
against the JAX package, on the CPU.

The JAX clustered tier (the flat route, `_SCAN` off so that the bounces
run unrolled) renders the small city of tests/test_torch_cluster.py
(city_scene(4000, seed=1, blocks=2): 3,512 triangles, 46 clusters) from
a camera looking down on the blocks at 24x24, 3 bounces, power NEE,
`split_channels=True` and `want_aux=True` in interpret mode. A recorder
keeps its `_kernel_a2_call` launches on the way through:

  * K4's split variant in plain PyTorch (`shade_reference` with the fs2
    rows) on the inputs of the JAX render's launches at bounces 0 and 2:
    integer rows, prim ids, request flags and the first-scatter flag
    equal on every active lane, the float rows (fs2 0:6 and the SH_CDIFF
    rows included) within rtol = atol = 2e-3;
  * the port's clustered tier against that render: relative RMSE < 2e-3
    for L, L_diff and L_spec, the partition |L - emission - L_diff -
    L_spec| < 2e-2 (tests/test_split_hot_tiers.py:29-41), every aux key
    within rtol = atol = 1e-3 (tests/test_bounce_pallas.py:82-83), equal
    counts;
  * the per-row route's refusal of the split, by name.
The clustered external route and the instanced tables with the split are
in tests/test_torch_split_general.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import render_sample
from rtxpt_tpu_torch.scene import procedural as TP

W = H = 24
SAMPLE = 1
BOUNCES = 3
TOL = 2e-3
RMSE = 2e-3
PARTITION = 2e-2
AUX_TOL = 1e-3
AUX = ("albedo", "albedo_diff", "albedo_spec", "normal", "depth", "wpos",
       "emission")
BASE = dict(max_bounces=BOUNCES, split_channels=True)
# looking down on the blocks, so that most rays hit geometry
AIMED = dict(position=[10.0, 16.0, 24.0], target=[10.0, 2.0, 10.0],
             up=[0.0, 1.0, 0.0], fov_y_deg=30.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _city(mod):
    host = mod.city_scene(tri_budget=4000, seed=1, blocks=2)
    host.camera = dict(AIMED)
    return host


def _rows(x):
    return None if x is None else np.asarray(x).reshape(x.shape[0], -1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def city():
    th = _city(TP)
    return th, prepare(th, device="cpu")


@pytest.fixture(scope="module")
def jax_clustered():
    """The JAX clustered render (split, aux) and its K4 launches in order,
    inputs and outputs as numpy [rows, N] arrays."""
    jh = _city(JP)
    js = j_prepare(jh)
    calls = []
    k4 = JBC._kernel_a2_call

    def record(*args, **kw):
        out = k4(*args, **kw)
        calls.append(dict(bounce=int(np.asarray(args[0])[0, 1]),
                          ha=_rows(args[1]), fs=_rows(args[2]),
                          is_=_rows(args[3]), fs2=_rows(kw["fs2"]),
                          out=[_rows(x) for x in out]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBC, "_SCAN", False)
        mp.setattr(JBC, "_kernel_a2_call", record)
        ref = jint.render_sample(
            js, JP.default_camera(jh, W, H),
            JConfig(nee=JNEE.POWER, kernel_tier="clustered",
                    pallas_interpret=True, cluster_kslots=64, **BASE),
            W, H, jnp.uint32(SAMPLE), want_aux=True)
    assert [c["bounce"] for c in calls] == list(range(BOUNCES))
    return {k: np.asarray(v) for k, v in ref.items()}, calls


@pytest.mark.parametrize("bounce", [0, 2])
def test_k4_split_plain_matches_pallas_kernel(city, jax_clustered, bounce):
    c = jax_clustered[1][bounce]
    kcfg = bf.KernelConfig.from_cfg(PathTracerConfig(nee=NEEMode.POWER,
                                                     **BASE))
    tfs, tis, tsh, thit, tf2 = (x.numpy() for x in BC.shade(
        _t(c["ha"]), _t(c["fs"]), _t(c["is_"]), city[1].cluster_tables,
        kcfg, SAMPLE, fs2=_t(c["fs2"])))
    jfs, jis, jsh, jhit, jsurf, jf2 = c["out"]
    assert jsurf is None and jf2 is not None
    active = c["is_"][bf.IS_ACTIVE] > 0
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) \
        & (tsh[BC.SH_DO] == jsh[BC.SH_DO]) \
        & (tf2[bf.F2_FSPEC] == jf2[bf.F2_FSPEC])
    assert same[active].all(), (~same[active]).sum()
    for name, a, b in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit), ("fs2", tf2, jf2)):
        np.testing.assert_allclose(a[:, active], b[:, active], rtol=TOL,
                                   atol=TOL, err_msg=name)
    # NEE requests with a diffuse part, both lobes at the first scatter
    do = jsh[BC.SH_DO] > 0.5
    assert do.sum() >= 20
    assert np.abs(jsh[BC.SH_CDIFF:BC.SH_CDIFF + 3][:, do]).max() > 0
    assert 0.0 < jf2[bf.F2_FSPEC][active].mean() < 1.0


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


def test_clustered_render_matches_jax_clustered_tier(city, jax_clustered):
    th, ts = city
    ref = jax_clustered[0]
    cam = TP.default_camera(th, W, H)
    cfg = PathTracerConfig(nee=NEEMode.POWER, **BASE)
    out = render_sample(ts, cam, cfg, W, H, SAMPLE, want_aux=True)
    assert out["kernel_tier"] == "clustered"
    got = _check_partition(out)
    for k in ("L", "L_diff", "L_spec"):
        assert _rel_rmse(got[k], ref[k]) < RMSE, k
    for k in AUX:
        np.testing.assert_allclose(got[k], ref[k], rtol=AUX_TOL,
                                   atol=AUX_TOL, err_msg=k)
    assert int(out["ray_count"]) == int(ref["ray_count"])
    assert int(out["cull_overflow"]) == int(ref["cull_overflow"])


def test_per_row_route_refuses_the_split(city, monkeypatch):
    """The per-row route (bounce_clustered.FLAT False) refuses the split
    channels by name, as the JAX package's asserts it
    (bounce_clustered.py:1560-1561); the aux buffers it serves."""
    th, ts = city
    monkeypatch.setattr(BC, "FLAT", False)
    cam = TP.default_camera(th, 8, 8)
    with pytest.raises(NotImplementedError,
                       match="split diffuse/specular channels on the "
                             "per-row route"):
        render_sample(ts, cam, PathTracerConfig(**BASE), 8, 8, SAMPLE)
    cfg = dispatch.resolve(ts, PathTracerConfig(max_bounces=BOUNCES), "cpu")
    with pytest.raises(NotImplementedError,
                       match="split diffuse/specular channels"):
        BC.trace_paths_clustered(
            ts, dataclasses.replace(cfg, split_channels=True),
            torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4),
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), SAMPLE)
    out = render_sample(ts, cam, PathTracerConfig(max_bounces=BOUNCES), 8, 8,
                        SAMPLE, want_aux=True)
    assert set(("albedo", "normal", "depth", "wpos", "emission")) <= set(out)

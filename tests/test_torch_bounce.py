"""One fused bounce: the JAX package's Pallas kernel (`_bounce_call` in
interpret mode, as its own tests run it on the CPU) against the port's
`bounce_reference` (the CUDA kernel's plain version) on the same state of
1,024 Cornell camera rays, at bounce 0 and at bounce 2 (Russian roulette
on), for each NEE mode.

Integer rows and prim ids must agree on >= 99.5% of lanes (a one-ulp
difference may flip a branch); float rows must then agree at
rtol = atol = 2e-3, the kernel-vs-wavefront limit of
tests/test_bounce_pallas.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import NEEMode, PathTracerConfig
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt.integrator import EFFECT_LENS, _lds, _pixel_grid
from rtxpt_tpu.scene.camera import camera_ray
from rtxpt_tpu.scene.procedural import default_camera
from rtxpt_tpu.utils import rng
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.prepare import scene_from_numpy
from rtxpt_tpu_torch.pt import bounce_fused as bf

SIDE = 32                      # 1,024 rays
SAMPLE = 3
INT_LANES = 0.995
TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores, and oversubscribed
    threads made the small ops of the CPU renders several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _initial_state(jhost, cfg):
    cam = default_camera(jhost, SIDE, SIDE)
    px, py = _pixel_grid(SIDE, SIDE)
    u1, u2 = _lds(cfg, jnp.uint32(SAMPLE),
                  rng.pixel_seed(px, py, 0, EFFECT_LENS), (0, 1))
    o, d, spread = camera_ray(cam, px, py, u1, u2)
    o, d = np.asarray(o), np.asarray(d)
    n = SIDE * SIDE
    fs = np.concatenate([o.T, d.T, np.ones((3, n)), np.zeros((3, n)),
                         np.zeros((2, n)), np.asarray(spread)[None]])
    is_ = np.concatenate([np.ones((2, n)), np.full((2, n), -1),
                          np.asarray(px)[None], np.asarray(py)[None],
                          np.full((1, n), bf._NO_BUDGET), np.zeros((1, n))])
    return fs.astype(np.float32), is_.astype(np.int32)


@pytest.fixture(scope="module", params=["POWER", "UNIFORM", "OFF"])
def jax_bounces(request, cornell_scene):
    """Inputs and outputs of the JAX kernel at bounces 0, 1 and 2."""
    jhost, jscene = cornell_scene
    jt = jscene.bounce_tables
    cfg = PathTracerConfig(max_bounces=4, nee=NEEMode[request.param])
    fs, is_ = _initial_state(jhost, cfg)
    steps = []
    for b in range(3):
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        out = bp._bounce_call(
            scal, jnp.asarray(fs.reshape(bp.NF, -1, 128)),
            jnp.asarray(is_.reshape(bp.NI, -1, 128)), jt.tri_rows,
            jt.attr_rows, jt.mat_rows, jt.light_rows, None, None, None,
            bp._cfg_key(cfg), jt.tc, jt.n_chunks, jt.n_lights, jt.tr, True,
            interpret=True, maxb=cfg.max_bounces)
        outs = tuple(np.asarray(x).reshape(x.shape[0], -1)
                     for x in out[:3])
        steps.append(((fs, is_), outs))
        fs, is_ = outs[0], outs[1]
    tables = dict(tri_rows=np.asarray(jt.tri_rows),
                  attr_rows=np.asarray(jt.attr_rows),
                  mat_rows=np.asarray(jt.mat_rows),
                  light_rows=np.asarray(jt.light_rows), tc=jt.tc,
                  n_chunks=jt.n_chunks, n_lights=jt.n_lights,
                  n_tris=jt.n_tris)
    return cfg, scene_from_numpy(tables, device="cpu"), steps


@pytest.mark.parametrize("bounce", [0, 2])
def test_bounce_matches_pallas_kernel(jax_bounces, bounce):
    cfg, scene, steps = jax_bounces
    (fs, is_), (jf, ji, jh) = steps[bounce]
    kcfg = bf.KernelConfig.from_cfg(cfg)
    before = kernels.launches["bounce_fused"]
    tf, ti, th = (x.numpy() for x in bf.bounce(
        torch.tensor(fs), torch.tensor(is_), scene.bounce_tables,
        kcfg, SAMPLE))
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.launches["bounce_fused"] == before
    same = (ji == ti).all(0) & (jh[1] == th[1])
    assert same.mean() >= INT_LANES, same.mean()
    for r in range(bf.NF):
        np.testing.assert_allclose(tf[r][same], jf[r][same], rtol=TOL,
                                   atol=TOL, err_msg=f"fs row {r}")
    for r in (0, 2, 3, 4, 5):
        np.testing.assert_allclose(th[r][same], jh[r][same], rtol=TOL,
                                   atol=TOL, err_msg=f"hit row {r}")
    if bounce == 2:
        # Russian roulette is live from logical bounce 2 on
        assert (is_[bf.IS_LBOUNCE] >= cfg.min_bounces_before_rr).any()

"""The V-buffer restart and first_direct=False (real-time mode's fill)
against the JAX package, on the CPU.

The scene is the glass-over-mirror Cornell box of
tests/test_stable_planes.py:120-127, 24x24 camera rays, 3 bounces, power
NEE. The restart's hits are the camera rays' closest hits, every fifth
lane an invalid plane's miss (prim -1, t = max_ray_travel), with a
budget of one bounce on every third lane and of all three on the others
(tests/test_bounce_pallas.py:102-131 is the template). The JAX fused tier runs them once through
`trace_paths_pallas` in interpret mode, with one 128-lane row per block
(`bounce_pallas._R`, for this module only) and first_direct=False, and a
recorder keeps its `_bounce_call` launches, so the kernel checks need no
compile of their own:

  * K1's plain version with the injected rows, the budgets and
    first_direct=False on the inputs of the JAX render's launches at
    bounces 0 (injected) and 2: integer rows and prim ids equal on every
    lane, float rows within rtol = atol = 2e-3 on the active lanes;
  * the port's trace_paths_fused on the same restart against that render
    (L and the aux buffers within 2e-3), and the budgets bite;
  * external_nee with first_direct=False against the JAX external_nee on
    the same SF_* rows (K1's plain export in slot 5, 32x32 rays), at
    bounces 0 and 1, keyed on the bounce or on each lane's logical
    bounce: no NEE at the first vertex, the usual NEE after it (do_nee
    equal, contrib, em_add and sdist within 2e-3);
  * on cluster tables a restart, and a budget alone (F14), go to the
    general tier, which renders them as it renders the same call pinned
    there.

The general tier's restart with all three arguments is held against the
JAX general tier in tests/test_torch_stable_planes.py, where the JAX
wavefront's compiles are shared with the stable-planes frames.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.accel.traverse import Hit as JHit
from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt.nee_external import external_nee as j_external_nee
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel.traverse import Hit, scene_closest
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.bounce_fused import trace_paths_fused
from rtxpt_tpu_torch.pt.integrator import (
    _pixel_grid, camera_rays, trace_paths)
from rtxpt_tpu_torch.pt.nee_external import external_nee
from rtxpt_tpu_torch.scene import procedural as TP

SIDE = 24
SAMPLE = 5
BOUNCES = 3
TOL = 2e-3
AUX = ("albedo", "normal", "depth", "wpos", "emission")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_jax_row():
    """One intra-op thread for this module's torch ops, and one row per
    block of the JAX fused tier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(bp, "_R", 1)
    yield
    mp.undo()
    torch.set_num_threads(n)


def _jax_glass_mirror():
    host = JP.cornell_box()
    mats = host.materials
    host.materials = mats.replace(
        transmission=mats.transmission.at[4].set(1.0),
        roughness=mats.roughness.at[4].set(0.0).at[3].set(0.0),
        metallic=mats.metallic.at[3].set(1.0))
    return host


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(x):
    return None if x is None else np.asarray(x).reshape(x.shape[0], -1)


@pytest.fixture(scope="module")
def glass():
    th = TP.glass_mirror_cornell()
    return th, prepare(th, device="cpu")


@pytest.fixture(scope="module")
def restart(glass):
    """The camera rays, the restart hits (numpy) and the budgets, the same
    for both packages (from the port's camera rays and closest hit)."""
    th, ts = glass
    cfg = PathTracerConfig(max_bounces=BOUNCES)
    cam = TP.default_camera(th, SIDE, SIDE)
    px, py = _pixel_grid(SIDE, SIDE)
    o, d, spread = camera_rays(cam, cfg, px, py, SAMPLE)
    js = j_prepare(_jax_glass_mirror())
    n = o.shape[0]
    fh = scene_closest(ts, o.contiguous(), d, torch.zeros(n),
                       torch.full((n,), cfg.max_ray_travel))
    lane = np.arange(n)
    invalid = lane % 5 == 0
    hit = dict(t=np.where(invalid, cfg.max_ray_travel, fh.t.numpy()),
               prim=np.where(invalid, -1, fh.prim.numpy()),
               bary=fh.bary.numpy(), front=fh.front.numpy())
    budget = np.where(lane % 3 == 0, 1, BOUNCES).astype(np.int32)
    return dict(js=js, o=o, d=d, spread=spread, px=px, py=py, hit=hit,
                budget=budget)


def _port_hit(h):
    return Hit(t=_t(h["t"]).float(), prim=_t(h["prim"]).int(),
               bary=_t(h["bary"]).float(), front=_t(h["front"]))


def _jax_hit(h):
    return JHit(t=jnp.asarray(h["t"], jnp.float32),
                prim=jnp.asarray(h["prim"], jnp.int32),
                bary=jnp.asarray(h["bary"]), front=jnp.asarray(h["front"]))


def _jax_args(r):
    return [jnp.asarray(r[k].numpy()) for k in ("o", "d", "spread", "px",
                                                "py")]


@pytest.fixture(scope="module")
def jax_fused(restart):
    """The JAX fused tier's restart (first_direct=False, want_aux) and its
    K1 launches in order, inputs and outputs as numpy [rows, N] arrays."""
    calls = []
    k1 = bp._bounce_call

    def record(*args, **kw):
        out = k1(*args, **kw)
        calls.append(dict(bounce=int(np.asarray(args[0])[0, 1]),
                          fs=_rows(args[1]), is_=_rows(args[2]),
                          inj=_rows(kw.get("inj")),
                          out=[_rows(x) for x in out]))
        return out

    cfg = JConfig(max_bounces=BOUNCES, nee=JNEE.POWER, kernel_tier="fused",
                  pallas_interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bp, "_bounce_call", record)
        ref = bp.trace_paths_pallas(
            restart["js"], cfg, *_jax_args(restart), jnp.uint32(SAMPLE),
            want_aux=True, first_hit=_jax_hit(restart["hit"]),
            bounce_budget=jnp.asarray(restart["budget"]),
            first_direct=False)
    assert [c["bounce"] for c in calls] == list(range(BOUNCES))
    assert calls[0]["inj"] is not None and calls[1]["inj"] is None
    return {k: np.asarray(v) for k, v in ref.items()}, calls


@pytest.mark.parametrize("bounce", [0, 2])
def test_k1_inject_plain_matches_pallas_kernel(glass, jax_fused, bounce):
    c = jax_fused[1][bounce]
    kcfg = bf.KernelConfig.from_cfg(PathTracerConfig(max_bounces=BOUNCES))
    before = sum(kernels.launches.values())
    inj = None if c["inj"] is None else _t(c["inj"])
    tfs, tis, thit = (x.numpy() for x in bf.bounce(
        _t(c["fs"]), _t(c["is_"]), glass[1].bounce_tables, kcfg, SAMPLE,
        inj=inj, first_direct=False))
    assert sum(kernels.launches.values()) == before   # CPU: the plain one
    jfs, jis, jhit = c["out"][:3]
    np.testing.assert_array_equal(tis, jis)
    np.testing.assert_array_equal(thit[1], jhit[1])
    active = c["is_"][bf.IS_ACTIVE] > 0
    for name, a, b in (("fs", tfs, jfs), ("hit", thit, jhit)):
        np.testing.assert_allclose(a[:, active], b[:, active], rtol=TOL,
                                   atol=TOL, err_msg=name)
    if bounce == 0:
        # the injected rows are the hits: an invalid lane misses, and the
        # first vertex's NEE is left out everywhere
        lanes = c["inj"].shape[1]
        np.testing.assert_array_equal(thit[1], np.where(
            c["inj"][bf.INJ_PRIM] < 0, -1, c["inj"][bf.INJ_PRIM]))
        assert (thit[1][np.arange(lanes) % 5 == 0] == -1).all()
        assert thit[5].max() == 0.0
    else:
        assert thit[5].sum() > 10                 # NEE past the first vertex


def test_trace_paths_fused_restart_matches_pallas(glass, restart,
                                                  jax_fused):
    ref = jax_fused[0]
    args = [restart[k] for k in ("o", "d", "spread", "px", "py")]
    cfg = PathTracerConfig(max_bounces=BOUNCES)
    out = trace_paths_fused(glass[1], cfg, *args, SAMPLE, want_aux=True,
                            first_hit=_port_hit(restart["hit"]),
                            bounce_budget=_t(restart["budget"]),
                            first_direct=False)
    assert np.isfinite(out["L"].numpy()).all()
    for k in ("L",) + AUX:
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    # the budget bites: without it some lane gathers more
    full = trace_paths_fused(glass[1], cfg, *args, SAMPLE,
                             first_hit=_port_hit(restart["hit"]),
                             first_direct=False)
    assert np.abs(full["L"].numpy() - out["L"].numpy()).max() > 1e-4
    # and the invalid lanes gather nothing
    assert out["L"].numpy()[::5].max() == 0.0


def _slot5_bounces(glass, cfg):
    """K1's plain version in slot 5 (external power NEE) along bounces 0
    and 1 of 32x32 camera rays (the JAX external_nee takes whole 1,024-lane
    chunks): per bounce, the inputs and the outputs."""
    th, ts = glass
    cam = TP.default_camera(th, 32, 32)
    px, py = _pixel_grid(32, 32)
    o, d, spread = camera_rays(cam, cfg, px, py, SAMPLE)
    fs, is_ = bf.initial_state(o, d, spread, px, py)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == 5
    steps = []
    for _ in range(2):
        out = bf.bounce(fs, is_, ts.bounce_tables, kcfg, SAMPLE)
        steps.append(((fs, is_), out))
        fs, is_ = out[0], out[1]
    return steps


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("bounce", [0, 1])
def test_external_nee_first_direct_matches_jax(glass, restart, bounce,
                                               per_lane):
    """external_nee(first_direct=False) on the same SF_* rows: no NEE at
    the first vertex, the same NEE as with it after, keyed on the bounce
    or on each lane's logical bounce (`lb`)."""
    kw = dict(max_bounces=BOUNCES, nee_external=True)
    tcfg = PathTracerConfig(nee=NEEMode.POWER, **kw)
    jcfg = JConfig(nee=JNEE.POWER, **kw)
    (fs, is_), (_, ti, th, ts) = _slot5_bounces(glass, tcfg)[bounce]
    args = dict(surf=ts, d_in=fs[bf.FS_D:bf.FS_D + 3], hit_mask=th[5] > 0.5,
                prev_pdf_in=fs[bf.FS_PREVPDF],
                prev_delta_in=is_[bf.IS_PREVDELTA] > 0, px=ti[bf.IS_PX],
                py=ti[bf.IS_PY])
    if per_lane:
        args["lb"] = is_[bf.IS_LBOUNCE]
    got = external_nee(glass[1], tcfg, None, **args, sample_idx=SAMPLE,
                       bounce=bounce, first_direct=False)
    want = j_external_nee(restart["js"], jcfg, None,
                          **{k: jnp.asarray(v.numpy())
                             for k, v in args.items()},
                          sample_idx=jnp.uint32(SAMPLE), bounce=bounce,
                          first_direct=False)
    do = got["do_nee"].numpy()
    np.testing.assert_array_equal(do, np.asarray(want["do_nee"]))
    for key in ("contrib", "em_add", "sdist"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    with_direct = external_nee(glass[1], tcfg, None, **args,
                               sample_idx=SAMPLE, bounce=bounce)["do_nee"]
    if bounce == 0:
        assert not do.any() and with_direct.numpy().mean() > 0.3
    else:
        np.testing.assert_array_equal(do, with_direct.numpy())
        assert do.mean() > 0.1


def test_clustered_restart_goes_to_the_general_tier():
    """On cluster tables the real-time arguments resolve to "xla" (the JAX
    package's handoff for first_hit and first_direct=False; a budget alone
    too, F14), pinned "clustered" as well; the trace renders them as the
    same call pinned to the general tier does."""
    th = TP.city_scene(tri_budget=4000, seed=1, blocks=2)
    ts = prepare(th, device="cpu")
    assert ts.cluster_tables is not None
    side = 8
    cfg = PathTracerConfig(max_bounces=2)
    assert dispatch.resolve(ts, cfg, "cpu").kernel_tier == "clustered"
    n = side * side
    for call in (dict(first_hit=object()), dict(first_direct=False),
                 dict(bounce_budget=torch.ones((n,), dtype=torch.int32))):
        for tier in ("auto", "clustered"):
            got = dispatch.resolve(ts, PathTracerConfig(kernel_tier=tier),
                                   "cpu", **call)
            assert got.kernel_tier == "xla", (call, tier)
        assert not dispatch.unsupported_features(ts, cfg)
    cam = TP.default_camera(th, side, side)
    px, py = _pixel_grid(side, side)
    o, d, spread = camera_rays(cam, cfg, px, py, SAMPLE)
    fh = scene_closest(ts, o, d, torch.zeros(n),
                       torch.full((n,), cfg.max_ray_travel))
    budget = torch.where(torch.arange(n) % 2 == 0, 1, 2).to(torch.int32)
    kw = dict(want_aux=True, first_hit=fh, bounce_budget=budget)
    before = dict(kernels.launches)
    out = trace_paths(ts, cfg, o, d, spread, px, py, SAMPLE, **kw)
    ref = trace_paths(ts, PathTracerConfig(max_bounces=2, kernel_tier="xla"),
                      o, d, spread, px, py, SAMPLE, **kw)
    assert dict(kernels.launches) == before
    for k in ("L",) + AUX:
        assert torch.equal(out[k], ref[k]), k
    assert out["depth"].max() > 0

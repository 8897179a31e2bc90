"""The split channels and the aux guide buffers on the fused tier against
the JAX package, on the CPU.

The JAX fused tier renders the Cornell box at 24x24, 3 bounces, power NEE,
`split_channels=True` and `want_aux=True` in interpret mode, with one
128-lane row per block (`bounce_pallas._R`, set for this module only: the
per-lane results do not depend on the tiling, and the interpret-mode
compile is shorter). A recorder keeps its `_bounce_call` launches on the
way through, so the kernel checks need no compile of their own:

  * K1's split variant in plain PyTorch (`bounce_reference` with the fs2
    rows) on the inputs of the JAX render's launches at bounces 0 and 2:
    integer rows, prim ids and the first-scatter flag (fs2 row 6) equal
    on every active lane, the float rows (fs2 0:6 included) within
    rtol = atol = 2e-3;
  * the port's fused tier (its plain versions on the CPU) against that
    render: relative RMSE < 2e-3 for L, L_diff and L_spec, the partition
    |L - emission - L_diff - L_spec| < 2e-2 (tests/test_split_hot_tiers.py
    :29-41), every aux key within rtol = atol = 1e-3
    (tests/test_bounce_pallas.py:82-83), and L the same with and without
    the split;
  * external_nee's cdiff with `first_spec` against the JAX external_nee
    on the same SF_* rows (K1's export in slot 5) at bounces 0 and 1;
  * the split keyed on the config alone on the fused tier (L_diff without
    want_aux) and on want_aux too on the general tier, as in the JAX
    package (integrator.py:148, bounce_pallas.py:1747);
  * the CLI's --aux files.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.pt.nee_external import external_nee as j_external_nee
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.apps import cli
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt.integrator import (
    _pixel_grid, camera_rays, render_sample)
from rtxpt_tpu_torch.pt.nee_external import external_nee
from rtxpt_tpu_torch.scene import procedural as TP

W = H = 24
EXT_SIDE = 32
SAMPLE = 1
BOUNCES = 3
TOL = 2e-3
RMSE = 2e-3
PARTITION = 2e-2
AUX_TOL = 1e-3
AUX = ("albedo", "albedo_diff", "albedo_spec", "normal", "depth", "wpos",
       "emission")
BASE = dict(max_bounces=BOUNCES, split_channels=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_jax_row():
    """One intra-op thread for this module's torch ops (the test run puts
    several test processes on the machine's cores), and one row per block
    of the JAX fused tier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(bp, "_R", 1)
    yield
    mp.undo()
    torch.set_num_threads(n)


def _rows(x):
    return None if x is None else np.asarray(x).reshape(x.shape[0], -1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cornell():
    th = TP.cornell_box()
    return th, prepare(th, device="cpu")


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX fused render (split, aux) and its K1 launches in order,
    inputs and outputs as numpy [rows, N] arrays."""
    jh = JP.cornell_box()
    js = j_prepare(jh)
    calls = []
    k1 = bp._bounce_call

    def record(*args, **kw):
        out = k1(*args, **kw)
        calls.append(dict(bounce=int(np.asarray(args[0])[0, 1]),
                          fs=_rows(args[1]), is_=_rows(args[2]),
                          fs2=_rows(kw["fs2"]), out=[_rows(x) for x in out]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bp, "_bounce_call", record)
        ref = jint.render_sample(
            js, JP.default_camera(jh, W, H),
            JConfig(nee=JNEE.POWER, kernel_tier="fused",
                    pallas_interpret=True, **BASE),
            W, H, jnp.uint32(SAMPLE), want_aux=True)
    assert [c["bounce"] for c in calls] == list(range(BOUNCES))
    return {k: np.asarray(v) for k, v in ref.items()}, calls


@pytest.mark.parametrize("bounce", [0, 2])
def test_k1_split_plain_matches_pallas_kernel(cornell, jax_fused, bounce):
    c = jax_fused[1][bounce]
    kcfg = bf.KernelConfig.from_cfg(PathTracerConfig(nee=NEEMode.POWER,
                                                     **BASE))
    before = sum(kernels.launches.values())
    tfs, tis, thit, tf2 = (x.numpy() for x in bf.bounce(
        _t(c["fs"]), _t(c["is_"]), cornell[1].bounce_tables, kcfg, SAMPLE,
        fs2=_t(c["fs2"])))
    assert sum(kernels.launches.values()) == before   # CPU: the plain one
    jfs, jis, jhit, jsurf, jf2 = c["out"]
    assert jsurf is None and jf2 is not None
    active = c["is_"][bf.IS_ACTIVE] > 0
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) \
        & (tf2[bf.F2_FSPEC] == jf2[bf.F2_FSPEC])
    assert same[active].all(), (~same[active]).sum()
    for name, a, b in (("fs", tfs, jfs), ("hit", thit, jhit),
                       ("fs2", tf2, jf2)):
        np.testing.assert_allclose(a[:, active], b[:, active], rtol=TOL,
                                   atol=TOL, err_msg=name)
    # both lobes occur, and by bounce 2 both channels have radiance
    fspec = jf2[bf.F2_FSPEC][active]
    assert 0.0 < fspec.mean() < 1.0
    if bounce == 2:
        assert jf2[bf.F2_LD:bf.F2_LD + 3].max() > 0
        assert jf2[bf.F2_LS:bf.F2_LS + 3].max() > 0


def _rel_rmse(a, b):
    return np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)),
                                                1e-9)


def _check_render(out, ref):
    """The reference's bounds (tests/test_split_hot_tiers.py:29-41,
    tests/test_bounce_pallas.py:82-83) between a port render and a JAX
    render of the same tier."""
    got = {k: v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    for k in ("L", "L_diff", "L_spec"):
        assert np.isfinite(got[k]).all(), k
        assert _rel_rmse(got[k], ref[k]) < RMSE, k
    resid = np.abs(got["L"] - got["emission"] - got["L_diff"]
                   - got["L_spec"])
    assert resid.max() < PARTITION, resid.max()
    for k in AUX:
        np.testing.assert_allclose(got[k], ref[k], rtol=AUX_TOL,
                                   atol=AUX_TOL, err_msg=k)
    assert got["L_diff"].mean() > 0 and got["L_spec"].mean() > 0


def test_fused_render_matches_jax_fused_tier(cornell, jax_fused):
    th, ts = cornell
    cam = TP.default_camera(th, W, H)
    cfg = PathTracerConfig(nee=NEEMode.POWER, **BASE)
    out = render_sample(ts, cam, cfg, W, H, SAMPLE, want_aux=True)
    assert out["kernel_tier"] == "torch"
    _check_render(out, jax_fused[0])
    plain = render_sample(ts, cam, PathTracerConfig(
        nee=NEEMode.POWER, max_bounces=BOUNCES), W, H, SAMPLE)
    assert torch.equal(plain["L"], out["L"])


def _slot5_bounces(cornell, cfg):
    """K1's plain version in slot 5 with the split rows along bounces 0
    and 1 of 32x32 camera rays (the JAX external_nee takes whole
    1,024-lane chunks): per bounce, the inputs and the outputs (fs, is_,
    hit, surf, fs2), the split rows carried."""
    th, ts = cornell
    cam = TP.default_camera(th, EXT_SIDE, EXT_SIDE)
    px, py = _pixel_grid(EXT_SIDE, EXT_SIDE)
    o, d, spread = camera_rays(cam, cfg, px, py, SAMPLE)
    fs, is_ = bf.initial_state(o, d, spread, px, py)
    fs2 = torch.zeros((bf.NF2, fs.shape[1]))
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == 5
    steps = []
    for _ in range(2):
        out = bf.bounce(fs, is_, ts.bounce_tables, kcfg, SAMPLE, fs2=fs2)
        steps.append(((fs, is_), out))
        fs, is_, fs2 = out[0], out[1], out[-1]
    return steps


@pytest.mark.parametrize("bounce", [0, 1])
def test_external_nee_cdiff_matches_jax(cornell, bounce):
    """external_nee with `first_spec`: the diffuse part of each lane's NEE
    contribution against the JAX external_nee on the same SF_* rows."""
    kw = dict(max_bounces=BOUNCES, nee_external=True, split_channels=True)
    tcfg = PathTracerConfig(nee=NEEMode.POWER, **kw)
    jcfg = JConfig(nee=JNEE.POWER, **kw)
    (fs, is_), (_, ti, th, ts, tf2) = _slot5_bounces(cornell, tcfg)[bounce]
    args = dict(surf=ts, d_in=fs[bf.FS_D:bf.FS_D + 3], hit_mask=th[5] > 0.5,
                prev_pdf_in=fs[bf.FS_PREVPDF],
                prev_delta_in=is_[bf.IS_PREVDELTA] > 0, px=ti[bf.IS_PX],
                py=ti[bf.IS_PY], first_spec=tf2[bf.F2_FSPEC] > 0.5)
    got = external_nee(cornell[1], tcfg, None, **args, sample_idx=SAMPLE,
                       bounce=bounce)
    want = j_external_nee(j_prepare(JP.cornell_box()), jcfg, None,
                          **{k: jnp.asarray(v.numpy())
                             for k, v in args.items()},
                          sample_idx=jnp.uint32(SAMPLE), bounce=bounce)
    do = got["do_nee"].numpy()
    np.testing.assert_array_equal(do, np.asarray(want["do_nee"]))
    assert do.mean() > 0.3
    for key in ("contrib", "cdiff"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    c, cd = got["contrib"].numpy()[do], got["cdiff"].numpy()[do]
    if bounce == 0:
        # the exact lobe share: part of the contribution, not all of it
        assert (np.abs(cd - c) > 1e-6).any() and (cd <= c + 1e-6).all()
    else:
        # the first scatter's channel: all of it or none
        spec = args["first_spec"].numpy()[do]
        np.testing.assert_array_equal(cd[spec], 0.0)
        np.testing.assert_array_equal(cd[~spec], c[~spec])
        assert spec.any() and (~spec).any()


def test_split_is_keyed_on_the_config_on_the_fused_tier(cornell):
    """Without want_aux the fused tier still returns L_diff and L_spec
    (its split variant is keyed on cfg.split_channels alone), the general
    tier does not (its split needs want_aux too)."""
    th, ts = cornell
    cam = TP.default_camera(th, 8, 8)
    fused = render_sample(ts, cam, PathTracerConfig(**BASE), 8, 8, SAMPLE)
    assert fused["kernel_tier"] == "torch"
    assert {"L_diff", "L_spec"} <= set(fused)
    assert not set(AUX) & set(fused)
    general = render_sample(ts, cam, PathTracerConfig(kernel_tier="xla",
                                                      **BASE), 8, 8, SAMPLE)
    assert not {"L_diff", "L_spec"} & set(general)
    both = render_sample(ts, cam, PathTracerConfig(kernel_tier="xla",
                                                   **BASE), 8, 8, SAMPLE,
                         want_aux=True)
    assert {"L_diff", "L_spec"} | set(AUX) <= set(both)


def test_cli_writes_aux_buffers(tmp_path):
    """--aux writes the averaged guide buffers as <out>.<key>.npy."""
    out = tmp_path / "cornell.png"
    assert cli.main(["--scene", "cornell", "--device", "cpu", "--width", "8",
                     "--height", "6", "--spp", "2", "--bounces", "2",
                     "--aux", "--out", str(out)]) == 0
    for key, shape in (("albedo", (6, 8, 3)), ("normal", (6, 8, 3)),
                       ("depth", (6, 8)), ("wpos", (6, 8, 3)),
                       ("emission", (6, 8, 3))):
        arr = np.load(tmp_path / f"cornell.{key}.npy")
        assert arr.shape == shape and np.isfinite(arr).all(), key
    assert sorted(p.name for p in tmp_path.glob("*.npy")) == sorted(
        f"cornell.{k}.npy" for k in ("albedo", "normal", "depth", "wpos",
                                     "emission"))
    assert np.load(tmp_path / "cornell.depth.npy").max() > 0

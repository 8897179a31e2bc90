"""The split channels on the external-NEE routes against the JAX package,
and the instanced clustered tier's aux buffers against the TLAS route, on
the CPU. NEE-AT renders with the split are in
tests/test_torch_split_neeat.py (fused tier) and
tests/test_torch_split_neeat_clustered.py (clustered tier).

  * K4's split variant in the export slots (3: NEE-AT, 5: power NEE on
    the external route) in plain PyTorch (`shade_reference` with the fs2
    rows) along bounces 0 and 1 of 1,024 camera rays of four closed
    rooms (rooms_scene(4, subdiv=8): 2,184 triangles, eight emissive
    panel triangles, so that second vertices meet emitters), on the HA
    rows of the port's K3, against the JAX package's own
    `surface_and_shade` with the same split rows (`ld`, `ls`, `fspec`) on
    the same rows, assembled into the state, SH, hit-flag, SF_* and fs2
    rows as `_kernel_a2` assembles them (bounce_clustered.py:586-620; the
    JAX kernel never stores its SF_* rows, ROADMAP F8): integer rows, the
    hit flag and the first-scatter flag equal on >= 99.5% of the lanes,
    the float rows within rtol = atol = 2e-3 on those lanes; no NEE term
    in the kernel, the primary emission and (slot 3) NEE-AT's deferred
    emission out of fs2, and (slot 5) each second vertex's emission whole
    in its first scatter's channel.
  * The instanced clustered tier's aux buffers against the TLAS route's
    on procedural.instanced_city(2, 6): equal within 1e-3 on every pixel
    (ROADMAP F13: the JAX clustered tier leaves them in object space).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt.integrator import (
    _pixel_grid, camera_rays, render_sample)
from rtxpt_tpu_torch.scene import procedural as TP

SAMPLE = 1
SIDE = 32                 # 1,024 lanes: one group of the clustered tier
KSLOTS = 64
TOL = 2e-3
INT_LANES = 0.995
AUX_TOL = 1e-3
AUX = ("albedo", "albedo_diff", "albedo_spec", "normal", "depth", "wpos",
       "emission")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rooms(mod):
    return mod.rooms_scene(4, subdiv=8)


@pytest.fixture(scope="module")
def rooms():
    jh, th = _rooms(JP), _rooms(TP)
    ts = prepare(th, device="cpu")
    assert ts.cluster_tables is not None and ts.bounce_tables is None
    return jh, j_prepare(jh), th, ts


def _tiles(x):
    return jnp.asarray(x.reshape(x.shape[0], -1, 128))


def _rows(x):
    return np.asarray(x).reshape(x.shape[0], -1)


def _camera_state(host):
    """The scene camera's rays on a SIDE x SIDE frame."""
    cam = TP.default_camera(host, SIDE, SIDE)
    px, py = _pixel_grid(SIDE, SIDE)
    o, d, spread = camera_rays(cam, PathTracerConfig(), px, py, SAMPLE)
    return bf.initial_state(o, d, spread, px, py)


def _jax_shade(jt, key, ha, fs, is_, fs2, sample, bounce):
    """The JAX package's K4 body with the split rows: `surface_and_shade`
    on K4's inputs ([rows, R, 128] tiles), as `_kernel_a2` calls it
    (bounce_clustered.py:566-584)."""
    def attr(i, k=1):
        return ha[JBC.HA_ATTR + i] if k == 1 else \
            ha[JBC.HA_ATTR + i:JBC.HA_ATTR + i + k]
    t = ha[JBC.HA_T]
    return bp.surface_and_shade(
        o=fs[0:3], d=fs[3:6], t=t, hit=t < bp._BIG,
        front=ha[JBC.HA_FRONT] > 0.0, bu=ha[JBC.HA_U], bv=ha[JBC.HA_V],
        attr=attr, thp=fs[6:9], L=fs[9:12], prev_pdf=fs[12],
        active=is_[0] > 0, prev_delta=is_[1] > 0, med0=is_[2], med1=is_[3],
        px=is_[4], py=is_[5], sample_idx=sample, bounce=bounce,
        mat_ref=jt.mat_rows, light_ref=jt.light_rows, cfg_key=key,
        n_lights=jt.n_lights, first_emissive=True, cone=fs[13],
        spread=fs[14], budget=is_[6], ld=fs2[0:3], ls=fs2[3:6],
        fspec=fs2[6], lbounce=is_[7])


def _jax_k4(jt, key):
    """`_jax_shade`'s results in `_kernel_a2`'s output rows (fs, is, sh,
    hit, surf, fs2; bounce_clustered.py:586-620), jitted once per key."""
    def body(ha, fs, is_, fs2, bounce):
        s = _jax_shade(jt, key, ha, fs, is_, fs2, jnp.uint32(SAMPLE), bounce)
        t = ha[JBC.HA_T]
        fs_o = jnp.concatenate(
            [s["o_new"], s["wi_world"], s["thp"], s["L"],
             s["prev_pdf"][None], s["cone"][None], s["spread"][None]])
        is_o = jnp.stack(
            [s["active"].astype(jnp.int32),
             s["prev_delta"].astype(jnp.int32), s["med0"], s["med1"],
             is_[4], is_[5], is_[6], s["lbounce"]])
        sh = jnp.concatenate(
            [s["shadow_o"], s["shadow_d"], s["sdist"][None], s["contrib"],
             s["do_nee"].astype(jnp.float32)[None], s["cdiff"],
             jnp.zeros_like(t)[None]])
        flag = s["shaded"].astype(jnp.float32) \
            * (1.0 + (is_[7] > 0).astype(jnp.float32))
        hit = jnp.stack([jnp.where(t < bp._BIG, t, 0.0), ha[JBC.HA_PRIM],
                         ha[JBC.HA_U], ha[JBC.HA_V],
                         (ha[JBC.HA_FRONT] > 0.0).astype(jnp.float32),
                         flag])
        f2 = jnp.concatenate([s["ld"], s["ls"], s["fspec"][None]])
        return fs_o, is_o, sh, hit, s["surf"], f2
    return jax.jit(body)


EXPORT = {"slot3": dict(nee=NEEMode.NEEAT),
          "slot5": dict(nee=NEEMode.POWER, nee_external=True)}


@pytest.fixture(scope="module")
def export_chains(rooms):
    """slot -> per bounce (0, 1): the port's plain K4 split and the JAX
    body's outputs on the same inputs, the port's outputs carried (the
    tier's NEE merge left out: the kernel's own rows are compared)."""
    chains = {}

    def get(slot):
        if slot not in chains:
            chains[slot] = _export_chain(rooms, slot)
        return chains[slot]
    return get


def _export_chain(rooms, slot):
    _, js, th, ts = rooms
    tbl = ts.cluster_tables
    kw = EXPORT[slot]
    cfg = PathTracerConfig(max_bounces=3, split_channels=True, **kw)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    key = bp._cfg_key(JConfig(max_bounces=3, split_channels=True,
                              nee=JNEE[kw["nee"].name],
                              nee_external=kw.get("nee_external", False)))
    assert kcfg.nee_mode == key[0] == int(slot[-1]) and key[9]
    jk4 = _jax_k4(js.cluster_tables, key)
    fs, is_ = _camera_state(th)
    fs2 = torch.zeros((bf.NF2, fs.shape[1]))
    steps = []
    for b in range(2):
        ha, _ = BC.closest_paged(fs, is_, tbl, KSLOTS, 1, 1e27)
        ha = BC.post_attr_inst(ha, tbl)
        out = BC.shade(ha, fs, is_, tbl, kcfg, SAMPLE, fs2=fs2)
        want = jk4(*(_tiles(x.numpy()) for x in (ha, fs, is_, fs2)),
                   jnp.int32(b))
        steps.append(dict(fs=fs.numpy(), fs2=fs2.numpy(), is_=is_.numpy(),
                          got=[x.numpy() for x in out],
                          want=[_rows(x) for x in want]))
        fs, is_, fs2 = out[0], out[1], out[-1]
    return steps


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("slot", list(EXPORT))
def test_k4_split_export_plain_matches_jax(export_chains, slot, bounce):
    s = export_chains(slot)[bounce]
    got, want = s["got"], s["want"]
    assert len(got) == 6                       # fs, is, sh, hit, surf, fs2
    tfs, tis, tsh, thit, tsurf, tf2 = got
    jfs, jis, jsh, jhit, jsurf, jf2 = want
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) \
        & (thit[5] == jhit[5]) & (tf2[bf.F2_FSPEC] == jf2[bf.F2_FSPEC])
    assert same.mean() >= INT_LANES, same.mean()
    active = s["is_"][bf.IS_ACTIVE] > 0
    assert (same & active).sum() >= 0.3 * same.size
    for name, a, c in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit), ("fs2", tf2, jf2)):
        np.testing.assert_allclose(a[:, same], c[:, same], rtol=TOL,
                                   atol=TOL, err_msg=name)
    shaded = same & (thit[5] > 0.5)
    assert shaded.mean() > 0.1
    np.testing.assert_allclose(tsurf[:, shaded], jsurf[:, shaded], rtol=TOL,
                               atol=TOL, err_msg="SF rows")
    # the export route: no NEE in the kernel, so no diffuse part either
    assert (tsh[BC.SH_DO] == 0).all() and (tsh[BC.SH_CDIFF:BC.SH_CDIFF + 3]
                                           == 0).all()
    lanes = same & active
    fspec = tf2[bf.F2_FSPEC][lanes]
    assert 0.0 < fspec.mean() < 1.0
    gain = tf2[bf.F2_LD:bf.F2_LS + 3] - s["fs2"][bf.F2_LD:bf.F2_LS + 3]
    gain_l = (tfs[bf.FS_L:bf.FS_L + 3]
              - s["fs"][bf.FS_L:bf.FS_L + 3])[:, lanes]
    if bounce == 0 or slot == "slot3":
        # the primary emission stays out of the split, and NEE-AT defers
        # the emission to the tier's merge (external_split)
        assert (gain == 0).all()
        assert (gain_l > 0).any() == (bounce == 0 and slot == "slot5")
    else:
        # lanes past their first vertex keep the first scatter's lobe, and
        # the emission they meet goes whole to that lobe's channel
        np.testing.assert_array_equal(fspec, s["fs2"][bf.F2_FSPEC][lanes])
        g = gain[:, lanes]
        f = fspec > 0.5
        assert (gain_l > 0).any(0).sum() >= 8
        np.testing.assert_allclose(g[0:3] + g[3:6], gain_l, rtol=1e-6,
                                   atol=1e-6)
        assert (g[0:3][:, f] == 0).all() and (g[3:6][:, ~f] == 0).all()


def test_instanced_clustered_aux_matches_tlas_route():
    """On instanced cluster tables the aux buffers are in world space, as
    the TLAS route's (the hits carry their instance; F13)."""
    th = TP.instanced_city(grid=2, subdiv=6)
    ts = prepare(th, device="cpu")
    assert ts.cluster_tables.instanced and ts.tlas is not None
    cam = TP.default_camera(th, 16, 16)
    base = dict(max_bounces=1, split_channels=True)
    got = render_sample(ts, cam, PathTracerConfig(**base), 16, 16, SAMPLE,
                        want_aux=True)
    want = render_sample(ts, cam, PathTracerConfig(kernel_tier="xla", **base),
                         16, 16, SAMPLE, want_aux=True)
    assert (got["kernel_tier"], want["kernel_tier"]) == ("clustered", "xla")
    assert float((want["depth"] > 0).float().mean()) > 0.5
    for k in AUX:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=AUX_TOL, atol=AUX_TOL, err_msg=k)

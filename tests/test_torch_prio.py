"""Nested dielectric priorities in rtxpt_tpu_torch against the JAX package,
on the CPU.

  (a) The closed forms of tests/test_nested_priority.py on the port's
      every tier: water [0, 1] and glass [0.4, 1.2] (both IoR 1, no
      specular reflection) in front of a panel of radiance E, seen along
      +x. With the glass outranking the water the water's back face inside
      the glass is a false hit, and the centre pixel is
      E exp(-SW 0.4 - SG 0.8); with flat priorities it is a real exit
      (E exp(-SW 0.4 - SG 0.6 - SW 0.2)). Each at rtol 5e-3 on the fused
      tier ("torch" on the CPU), the clustered tier (the scene with the
      40 x 40 side wall of tests/test_cluster_omm.py), the general tier
      and the TLAS route (`instancing="force"`).
  (b) K1's and K4's priority variants (`bounce_reference` on tables with
      `prio`, `shade_reference(prio=True)`) against `_bounce_call(prio=
      True)` and `_kernel_a2_call(prio=True)` (interpret mode) at
      iterations 0 and 2, on two cameras' rays: half from inside the
      water box, starting in air (the water's inner walls are false
      exits), half from inside the glass beyond the water, starting in the
      glass (the water's outer face is a false entry, which the interior
      list's lower slot records): integer rows equal and float rows
      within rtol = atol = 2e-3 on >= 99.9% of the lanes, the
      interior-list rows (IS_MED0, IS_MED1) equal on every lane, and at
      least 5% of the compared lanes priority false hits.
      K4 gets the same hit rows in both packages (the port's K3 plain
      version on the JAX-carried state).
  (c) `resolve` equal to the JAX package's on the priority scenes.

The JAX fused tier runs one 128-lane row per block (`bounce_pallas._R`,
set for this module only), as in the texture and micromap tests.
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
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import dispatch as jdispatch
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.scene.scene import HostScene as JHost
from rtxpt_tpu.scene.scene import Materials as JMaterials
from rtxpt_tpu.scene.scene import MeshInstance as JMesh
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays, render
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.scene.camera import look_at

from test_nested_priority import SG, SW, E

SAMPLE = 3
BOUNCES = 3
CHECKED = (0, 2)
TOL = 2e-3
LANES = 0.999
FALSE_HIT_SHARE = 0.05
NESTED = [1, 2, 0, 0]          # the glass outranks the water
FLAT = [0, 0, 0, 0]
FUSED_FRAME = (16, 16)         # 256 rays
CLUSTER_FRAME = (32, 32)       # 1,024 rays: one group of the clustered tier


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_jax_tiling():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(bp, "_R", 1)
    yield
    mp.undo()
    torch.set_num_threads(n)


def _jax_overlap(priorities, wall: bool):
    """The JAX tests' overlap scene (tests/test_nested_priority.py
    `_overlap_scene`; with `wall`, tests/test_cluster_omm.py
    `_overlap_scene_big`), built here as a host: importing the latter
    module sets the JAX package's interpret switch for the process."""
    parts = [
        JP._box([0.0, -1.0, -1.0], [1.0, 1.0, 1.0], 0),
        JP._box([0.4, -0.9, -0.9], [1.2, 0.9, 0.9], 1),
        JP._quad([2.0, -1, -1], [2.0, -1, 1], [2.0, 1, 1], [2.0, 1, -1], 2),
    ]
    if wall:
        parts.append(JP._quad_grid([-3.0, 5.0, -3.0], [4.0, 5.0, -3.0],
                                   [4.0, 5.0, 3.0], [-3.0, 5.0, 3.0],
                                   40, 40, 3))
    pos, nrm, uv, idx, mat = JP._merge(parts)
    m = 4 if wall else 3
    mats = JMaterials.create(m).replace(
        transmission=jnp.asarray([1.0, 1.0, 0.0, 0.0][:m]),
        ior=jnp.asarray([1.0, 1.0, 1.5, 1.5][:m]),
        roughness=jnp.asarray([0.0, 0.0, 0.0, 1.0][:m]),
        specular_f0_scale=jnp.zeros((m,)),
        base_color=jnp.asarray([[1.0] * 3, [1.0] * 3, [0.0] * 3,
                                [0.0] * 3][:m]),
        emissive=jnp.asarray([[0.0] * 3, [0.0] * 3, [E] * 3,
                              [0.0] * 3][:m]),
        volume_absorption=jnp.asarray([[SW] * 3, [SG] * 3, [0.0] * 3,
                                       [0.0] * 3][:m]),
        nested_priority=jnp.asarray(priorities[:m], jnp.int32))
    return JHost(instances=[JMesh(positions=pos, normals=nrm, uvs=uv,
                                  indices=idx, material=mat, name="nest")],
                 materials=mats)


@pytest.fixture(scope="module")
def scenes():
    cache = {}

    def get(wall):
        if wall not in cache:
            pri = NESTED[:4 if wall else 3]
            jh, th = _jax_overlap(NESTED, wall), TP.overlap_boxes(pri, wall)
            cache[wall] = (jh, j_prepare(jh), th, prepare(th, device="cpu"))
        return cache[wall]
    return get


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# (a) the closed forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wall", [False, True])
def test_overlap_scene_matches_jax(scenes, wall):
    """The port's overlap scenes prepare to the JAX tests' tables, and
    both declare the priorities."""
    _, js, _, ts = scenes(wall)
    assert ts.has_nested_priorities and js.has_nested_priorities
    if not wall:
        assert ts.bounce_tables.prio and js.bounce_tables.prio
        for f in ("tri_rows", "attr_rows", "mat_rows", "light_rows"):
            np.testing.assert_array_equal(
                getattr(ts.bounce_tables, f).numpy(),
                np.asarray(getattr(js.bounce_tables, f)), err_msg=f)
        return
    assert ts.bounce_tables is None
    for f in ("blocks", "aabb_lo", "aabb_hi", "mat_rows", "light_rows"):
        np.testing.assert_array_equal(
            getattr(ts.cluster_tables, f).numpy(),
            np.asarray(getattr(js.cluster_tables, f)), err_msg=f)


@pytest.mark.parametrize("priorities", ["nested", "flat"])
@pytest.mark.parametrize("route", ["fused", "clustered", "xla", "tlas"])
def test_overlap_closed_form(route, priorities):
    """tests/test_nested_priority.py's centre pixel on every tier: 4 x 4,
    1 spp, 6 bounces, NEE off, Russian roulette off (3 pass-through
    iterations on the clustered tier, as tests/test_cluster_omm.py)."""
    pri = NESTED if priorities == "nested" else FLAT
    wall = route == "clustered"
    host = TP.overlap_boxes(pri[:4 if wall else 3], wall=wall)
    scene = prepare(host, device="cpu",
                    instancing="force" if route == "tlas" else "off")
    assert scene.has_nested_priorities == (priorities == "nested")
    cfg = PathTracerConfig(max_bounces=6, nee=NEEMode.OFF,
                           enable_russian_roulette=False,
                           passthrough_extra_iters=3 if wall else 2,
                           kernel_tier="xla" if route == "xla" else "auto")
    tier = dispatch.resolve(scene, cfg, "cpu").kernel_tier
    assert tier == dict(fused="torch", clustered="clustered", xla="xla",
                        tlas="xla")[route]
    assert (scene.tlas is not None) == (route == "tlas")
    cam = look_at([-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  10.0, 4, 4)
    kernels.launches.clear()
    hdr = render(scene, cam, cfg, 4, 4, spp=1)[0]
    assert not kernels.launches
    if priorities == "nested":
        want = E * np.exp(-SW * 0.4 - SG * 0.8)     # the glass wins
    else:
        want = E * np.exp(-SW * 0.4 - SG * 0.6 - SW * 0.2)
    np.testing.assert_allclose(float(hdr[2, 2, 0]), want, rtol=5e-3)


# ---------------------------------------------------------------------------
# (b) K1 and K4
# ---------------------------------------------------------------------------


def _inside_state(w, h):
    """The w x h frame's rays: its top half from the first camera of
    procedural.OVERLAP_INSIDE_CAMERAS (false exits), its bottom half from
    the second (false entries), each starting in its camera's medium."""
    parts = []
    for k, (pos, target, up, fov, medium) in enumerate(
            TP.OVERLAP_INSIDE_CAMERAS):
        cam = look_at(pos, target, up, fov, w, h // 2)
        px, py = _pixel_grid(w, h // 2)
        o, d, spread = camera_rays(cam, PathTracerConfig(), px, py, SAMPLE)
        fs, is_ = bf.initial_state(o, d, spread, px, py + k * (h // 2))
        is_[bf.IS_MED0] = medium
        parts.append((fs, is_))
    return tuple(torch.cat([p[i] for p in parts], 1).numpy()
                 for i in range(2))


def _false_hits(is_in, is_out, hit):
    """Lanes that hit and passed through (active before and after, the
    logical bounce kept): on a scene without micromaps, the priority false
    hits."""
    return (is_in[bf.IS_ACTIVE] > 0) & (is_out[bf.IS_ACTIVE] > 0) \
        & (is_out[bf.IS_LBOUNCE] == is_in[bf.IS_LBOUNCE]) & hit


def _lanes_close(got, want, same, what):
    ok = np.isclose(got, want, rtol=TOL, atol=TOL,
                    equal_nan=True).all(0) & same
    assert ok.mean() >= LANES * same.mean(), (what, ok.mean(), same.mean())


def _check_state(tis, jis, is_in, same, hit):
    assert same.mean() >= LANES, same.mean()
    np.testing.assert_array_equal(tis[bf.IS_MED0:bf.IS_MED1 + 1],
                                  jis[bf.IS_MED0:bf.IS_MED1 + 1])
    fh = _false_hits(is_in, jis, hit)
    active = is_in[bf.IS_ACTIVE] > 0
    assert fh.sum() >= FALSE_HIT_SHARE * active.sum(), (fh.sum(),
                                                        active.sum())
    return fh


def _med1_moved(steps_in_out):
    """Some false hit of the chain updated the interior list's lower
    slot (the false entries of the glass camera's rays)."""
    return any(((jis[bf.IS_MED1] != is_in[bf.IS_MED1])
                & _false_hits(is_in, jis, hit)).any()
               for is_in, jis, hit in steps_in_out)


@pytest.fixture(scope="module")
def k1_steps(scenes):
    """The JAX K1 (prio, slot 2) at iterations 0-2 of the inside camera's
    rays, called as trace_paths_pallas calls it."""
    _, js, _, _ = scenes(False)
    jt = js.bounce_tables
    assert jt.prio and not jt.omm
    cfg = jdispatch.resolve(js, JConfig(
        max_bounces=BOUNCES, nee=JNEE.POWER, kernel_tier="fused",
        pallas_interpret=True))
    key = bp._cfg_key(cfg)
    fs, is_ = _inside_state(*FUSED_FRAME)
    steps = []
    for b in range(BOUNCES):
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        out = bp._bounce_call(
            scal, jnp.asarray(fs.reshape(bp.NF, -1, 128)),
            jnp.asarray(is_.reshape(bp.NI, -1, 128)), jt.tri_rows,
            jt.attr_rows, jt.mat_rows, jt.light_rows, jt.env_rows, None,
            None, key, jt.tc, jt.n_chunks, jt.n_lights, jt.tr, True,
            tex_maps=(1, 0, 0, 0), interpret=True, inj=None, fs2=None,
            omm=jt.omm, prio=jt.prio, maxb=cfg.max_bounces,
            first_direct=True)
        outs = tuple(np.asarray(x).reshape(x.shape[0], -1)
                     for x in out[:3])
        steps.append(((fs, is_), outs))
        fs, is_ = outs[0], outs[1]
    return cfg, steps


@pytest.mark.parametrize("bounce", CHECKED)
def test_k1_prio_plain_matches_pallas_kernel(scenes, k1_steps, bounce):
    _, _, _, ts = scenes(False)
    cfg, steps = k1_steps
    (fs, is_), (jf, ji, jhit) = steps[bounce]
    tables = ts.bounce_tables
    assert tables.prio
    kcfg = bf.KernelConfig.from_cfg(cfg)
    before = dict(kernels.launches)
    tf, ti, thit = (x.numpy() for x in bf.bounce(_t(fs), _t(is_), tables,
                                                 kcfg, SAMPLE))
    assert dict(kernels.launches) == before
    same = (ti == ji).all(0) & (thit[1] == jhit[1]) & (thit[5] == jhit[5])
    _check_state(ti, ji, is_, same, jhit[1] >= 0)
    assert _med1_moved([(s[0][1], s[1][1], s[1][2][1] >= 0) for s in steps])
    _lanes_close(tf, jf, same, "fs")
    _lanes_close(np.delete(thit, 1, 0), np.delete(jhit, 1, 0), same, "hit")


@pytest.fixture(scope="module")
def k4_steps(scenes):
    """The JAX K4 (prio, slot 2) at iterations 0-2 of the inside camera's
    rays on the overlap scene with its wall, the hit rows from the port's
    K3 plain version on the JAX-carried state, one page."""
    _, js, _, ts = scenes(True)
    jt, tbl = js.cluster_tables, ts.cluster_tables
    cfg = JConfig(max_bounces=BOUNCES, nee=JNEE.POWER)
    key = bp._cfg_key(cfg)
    rcfg = dispatch.resolve(ts, PathTracerConfig(max_bounces=BOUNCES),
                            "cpu")
    assert rcfg.cluster_pages == 1
    fs, is_ = _inside_state(*CLUSTER_FRAME)
    steps = []
    for b in range(BOUNCES):
        ha, _ = BC.closest_paged(_t(fs), _t(is_), tbl, rcfg.cluster_kslots,
                                 1, float(cfg.max_ray_travel))
        ha = ha.numpy()
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)

        def tiles(x):
            return jnp.asarray(x.reshape(x.shape[0], -1, 128))
        out = JBC._kernel_a2_call(
            scal, tiles(ha), tiles(fs), tiles(is_), jt.mat_rows,
            jt.light_rows, None, None, None, key, jt.n_lights, jt.tr, True,
            tex_maps=(1, 0, 0, 0), interpret=True, fs2=None, prio=True,
            omm=False, maxb=cfg.max_bounces)
        outs = tuple(np.asarray(x).reshape(x.shape[0], -1)
                     for x in out[:4])
        steps.append(dict(fs=fs, is_=is_, ha=ha, out=outs))
        fs, is_ = outs[0], outs[1]
    return cfg, steps


@pytest.mark.parametrize("bounce", CHECKED)
def test_k4_prio_plain_matches_pallas_kernel(scenes, k4_steps, bounce):
    _, _, _, ts = scenes(True)
    cfg, steps = k4_steps
    s = steps[bounce]
    kcfg = bf.KernelConfig.from_cfg(cfg)
    before = dict(kernels.launches)
    tfs, tis, tsh, thit = (x.numpy() for x in BC.shade(
        _t(s["ha"]), _t(s["fs"]), _t(s["is_"]), ts.cluster_tables, kcfg,
        SAMPLE, prio=True))
    assert dict(kernels.launches) == before
    jfs, jis, jsh, jhit = s["out"]
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) & (thit[5] == jhit[5])
    _check_state(tis, jis, s["is_"], same, s["ha"][BC.HA_PRIM] >= 0)
    assert _med1_moved([(x["is_"], x["out"][1], x["ha"][BC.HA_PRIM] >= 0)
                        for x in steps])
    for name, a, b in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit)):
        _lanes_close(a, b, same, name)


def test_k4_without_prio_shades_false_hits(scenes, k4_steps):
    """The priority switch is what passes the false hits through: K4
    without it shades those lanes (their logical bounce advances)."""
    _, _, _, ts = scenes(True)
    cfg, steps = k4_steps
    s = steps[0]
    kcfg = bf.KernelConfig.from_cfg(cfg)
    jis = s["out"][1]
    fh = _false_hits(s["is_"], jis, s["ha"][BC.HA_PRIM] >= 0)
    tis = BC.shade(_t(s["ha"]), _t(s["fs"]), _t(s["is_"]), ts.cluster_tables,
                   kcfg, SAMPLE)[1].numpy()
    assert fh.any()
    assert (tis[bf.IS_LBOUNCE][fh] == s["is_"][bf.IS_LBOUNCE][fh] + 1).all()


# ---------------------------------------------------------------------------
# (c) resolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["auto", "xla"])
@pytest.mark.parametrize("wall", [False, True])
def test_resolve_matches_jax(scenes, wall, tier, monkeypatch):
    """Both packages serve the priority scenes on the same tier: the
    fused tier, the clustered tier (with the wall), the general tier when
    asked; the JAX package considers its kernel tiers on the CPU in
    interpret mode only."""
    _, js, _, ts = scenes(wall)
    monkeypatch.setenv("RTXPT_TPU_PALLAS_INTERPRET", "1")
    want = jdispatch.resolve(js, JConfig(kernel_tier=tier))
    got = dispatch.resolve(ts, PathTracerConfig(kernel_tier=tier), "cuda")
    assert got.kernel_tier == want.kernel_tier
    assert got.kernel_tier == (tier if tier == "xla" else
                               "clustered" if wall else "fused")
    # bounce tables made without the priority switch leave the scene to
    # the general tier under "auto", and a pinned fused tier raises
    if not wall:
        bare = ts.replace(bounce_tables=dataclasses.replace(
            ts.bounce_tables, prio=False))
        assert dispatch.resolve(bare, PathTracerConfig(),
                                "cpu").kernel_tier == "xla"
        with pytest.raises(NotImplementedError, match="priorit"):
            dispatch.resolve(bare, PathTracerConfig(kernel_tier="fused"),
                             "cpu")


# ---------------------------------------------------------------------------
# (d) the overlap curtain: every switch of K1 and K4 on one scene
# ---------------------------------------------------------------------------


def _on_curtain(fs, t):
    """Lanes whose hit at distance t [N] lies in the curtain's plane."""
    y = fs[bf.FS_O + 1] + t * fs[bf.FS_D + 1]
    return np.abs(y - TP.OVERLAP_CURTAIN_Y) < 1e-3


@pytest.mark.parametrize("tier", ["fused", "clustered"])
def test_overlap_curtain_takes_every_switch(tier):
    """procedural.overlap_curtain: its tables take the texture, micromap
    and priority switches, and along three iterations of the inside
    cameras' rays (64 x 64) the priority variant with all of them and the
    split rows (K1's plain version on the fused tables, K4's on K3's hits
    over the clustered ones) meets priority false hits off the curtain on
    at least 5% of the active lanes at iterations 0 and 2, and
    alpha-tested hits on the curtain: the scene of the card's priority
    instantiations (tests/test_torch_cuda.py, chip_smoke.py phase 17)."""
    wall = tier == "clustered"
    scene = prepare(TP.overlap_curtain(NESTED[:4 if wall else 3], wall),
                    device="cpu")
    assert scene.has_nested_priorities and scene.textures is not None
    cfg = PathTracerConfig(max_bounces=3, stochastic_texture_filtering=True)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    fs, is_ = (torch.from_numpy(x) for x in _inside_state(64, 64))
    fs2 = torch.zeros((bf.NF2, fs.shape[1]))
    curtain = 0
    for it in range(BOUNCES):
        if wall:
            tbl = scene.cluster_tables
            assert tbl.omm and scene.bounce_tables is None
            ha, _ = BC.closest_paged(fs, is_, tbl, tbl.n_clusters, 1, 1e27,
                                     omm=True)
            out = BC.shade_reference(ha, fs, is_, tbl, kcfg, SAMPLE,
                                     omm=True, prio=True, fs2=fs2)
            t, hit = ha[BC.HA_T], ha[BC.HA_PRIM] >= 0
        else:
            tbl = scene.bounce_tables
            assert tbl.omm and tbl.prio and bf.use_tex(tbl, kcfg)
            out = bf.bounce_reference(fs, is_, tbl, kcfg, SAMPLE, fs2=fs2)
            t, hit = out[2][0], out[2][1] >= 0
        on = _on_curtain(fs.numpy(), t.numpy())
        fh = _false_hits(is_.numpy(), out[1].numpy(), hit.numpy()) & ~on
        active = (is_[bf.IS_ACTIVE] > 0).numpy()
        if it in CHECKED:
            assert fh.sum() >= FALSE_HIT_SHARE * active.sum(), (
                it, fh.sum(), active.sum())
        curtain += int((on & hit.numpy() & active).sum())
        fs, is_, fs2 = out[0], out[1], out[-1]
    assert curtain >= 100

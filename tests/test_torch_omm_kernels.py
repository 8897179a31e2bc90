"""Opacity micromaps in the kernels' plain versions against the JAX
package's Pallas kernels (interpret mode), on the CPU: the same seeded
camera rays through both packages.

  (a) K1's micromap variant (`bounce_reference` on tables with omm, the
      texture switch on) against `_bounce_call(omm=True)` on the curtain
      Cornell box (one alpha-tested quad with an 8 x 8 checkerboard
      alpha), nee slot 2, iterations 0 and 2 of 3 bounces (at
      iteration 1 the lanes leave the curtain: the pass-through lanes
      head for the back wall, the shaded ones away from the curtain).
  (b) K2's micromap variant (`occlusion_reference`) against
      `shadow_occlusion_call(omm=True)` on the shadow requests of the
      external route on the same scene (nee slot 5, `external_nee`), each
      with its alpha uniform.
  (c) K3, K4 and K5's micromap variants against `_kernel_a1_call`,
      `_kernel_a2_call` and `_kernel_b1_call` (omm=True) at iterations 0
      and 2 of the 40 x 40 curtain (3,212 triangles: the clustered tier).
  (d) the fused and clustered renders against the same JAX tier.

Kernel checks: integer rows equal and float rows within rtol = atol =
2e-3 on >= 99.9% of lanes; at least 5% of the lanes hit a MIXED triangle
and at least 1% an UNKNOWN micro-cell (asserted). Renders: >= 99% of the
pixels within 2e-3 and the means within 1e-3 relative, ray counts and
occupancy equal.

Each JAX kernel is called keyword for keyword as its render calls it and
at the render's padded shape, so the render finds the compile in jit's
cache; the JAX fused tier runs one 128-lane row per block
(`bounce_pallas._R`, set for this module only) and the JAX clustered tier
its unrolled rounds (`bounce_clustered._SCAN`), as in the texture tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.accel.cull import cull_candidates as j_cull
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import dispatch as jdispatch
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.scene.scene import MeshInstance as JMesh
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.pt import wide as W
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.pt.nee_external import external_nee
from rtxpt_tpu_torch.scene import omm as TO
from rtxpt_tpu_torch.scene import procedural as TP

from test_omm_alpha import _alpha_scene

SAMPLE = 3
BOUNCES = 3
CHECKED = (0, 2)                # iteration 1 mostly leaves the curtain
TOL = 2e-3
LANES = 0.999
MIXED_SHARE = 0.05
UNKNOWN_SHARE = 0.01
FUSED_FRAME = (16, 16)          # 256 camera rays
CLUSTER_FRAME = (32, 32)        # 1,024 rays: one group of the clustered tier
KSLOTS = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_jax_tiling():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(bp, "_R", 1)
    mp.setattr(JBC, "_SCAN", False)
    yield
    mp.undo()
    torch.set_num_threads(n)


def _jax_grid_curtain(grid: int):
    """tests/test_cluster_omm.py `_alpha_scene_big(True)` (the curtain as
    a grid x grid quad grid, a 64 x 64 checkerboard alpha), built here
    without importing that module, whose import sets the JAX package's
    interpret switch for the whole process."""
    host = _alpha_scene(True)
    pos, nrm, uv, idx, mat = JP._quad_grid(
        [0.02, 0.02, 0.5], [0.98, 0.02, 0.5], [0.98, 0.98, 0.5],
        [0.02, 0.98, 0.5], grid, grid, 5)
    host.instances[-1] = JMesh(positions=pos, normals=nrm, uvs=uv,
                               indices=idx, material=mat, name="curtain")
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    tex = np.ones((64, 64, 4), np.float32)
    tex[..., :3] = 0.2
    tex[..., 3] = ((yy + xx) % 2).astype(np.float32)
    host.textures = [tex]
    return host


@pytest.fixture(scope="module")
def curtain():
    jh, th = _alpha_scene(True), TP.curtain_cornell(True)
    return jh, j_prepare(jh), th, prepare(th, device="cpu")


@pytest.fixture(scope="module")
def grid_curtain():
    jh, th = _jax_grid_curtain(40), TP.curtain_cornell(True, grid=40)
    return jh, j_prepare(jh), th, prepare(th, device="cpu")


def _cfgs(**kw):
    kw = dict(max_bounces=BOUNCES, stochastic_texture_filtering=True, **kw)
    return JConfig(**kw), TConfig(**kw)


def _camera_state(host, w, h):
    cam = TP.default_camera(host, w, h)
    px, py = _pixel_grid(w, h)
    o, d, spread = camera_rays(cam, TConfig(), px, py, SAMPLE)
    return tuple(x.numpy() for x in bf.initial_state(o, d, spread, px, py))


def _t(x):
    return torch.tensor(np.asarray(x))


def _shares(scene, o, d, tmax=1e27):
    """(MIXED share, UNKNOWN share) of the lanes whose first geometric hit
    (no alpha test) before tmax lies on a MIXED triangle, and on one of
    its UNKNOWN micro-cells."""
    from rtxpt_tpu_torch.accel.traverse import intersect_closest
    n = o.shape[1]
    tmax = torch.full((n,), tmax) if np.ndim(tmax) == 0 else _t(tmax)
    hit = intersect_closest(scene.bvh.replace(tri_micro=None), _t(o.T),
                            _t(d.T), torch.zeros(n), tmax)
    prim = torch.clamp(hit.prim, min=0).long()
    mixed = ~hit.miss & (scene.tri_opacity[prim] == TO.MIXED)
    st = TO.micro_state(scene.tri_micromap[prim],
                        TO.micro_index(hit.bary[:, 0], hit.bary[:, 1]))
    unk = mixed & (st == TO.MICRO_UNKNOWN)
    return float(mixed.float().mean()), float(unk.float().mean())


def _lanes_close(got, want, same, what):
    """Float rows within TOL on >= LANES of the lanes `same`."""
    ok = np.isclose(got, want, rtol=TOL, atol=TOL,
                    equal_nan=True).all(0) & same
    assert ok.mean() >= LANES * same.mean(), (what, ok.mean(), same.mean())


# ---------------------------------------------------------------------------
# (a) K1 and (b) K2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k1_steps(curtain):
    """The JAX K1 (omm, textures, slot 2) at iterations 0-2 on the
    render's camera rays, called as trace_paths_pallas calls it."""
    jh, js, th, ts = curtain
    jt = js.bounce_tables
    assert jt.omm and jt.tex_ct is not None
    cfg = jdispatch.resolve(js, JConfig(
        max_bounces=BOUNCES, stochastic_texture_filtering=True,
        kernel_tier="fused", pallas_interpret=True))
    key = bp._cfg_key(cfg)
    fs, is_ = _camera_state(th, *FUSED_FRAME)
    steps = []
    for b in range(BOUNCES):
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        out = bp._bounce_call(
            scal, jnp.asarray(fs.reshape(bp.NF, -1, 128)),
            jnp.asarray(is_.reshape(bp.NI, -1, 128)), jt.tri_rows,
            jt.attr_rows, jt.mat_rows, jt.light_rows, jt.env_rows,
            jt.tex_ct, jt.tex_meta, key, jt.tc, jt.n_chunks, jt.n_lights,
            jt.tr, True, tex_maps=jt.tex_maps, interpret=True, inj=None,
            fs2=None, omm=jt.omm, prio=jt.prio, maxb=cfg.max_bounces,
            first_direct=True)
        outs = tuple(np.asarray(x).reshape(x.shape[0], -1)
                     for x in out[:3])
        steps.append(((fs, is_), outs))
        fs, is_ = outs[0], outs[1]
    return cfg, steps


@pytest.mark.parametrize("bounce", CHECKED)
def test_k1_omm_plain_matches_pallas_kernel(curtain, k1_steps, bounce):
    _, js, _, ts = curtain
    cfg, steps = k1_steps
    (fs, is_), (jf, ji, jhit) = steps[bounce]
    tables = ts.bounce_tables
    np.testing.assert_array_equal(tables.tri_rows.numpy(),
                                  np.asarray(js.bounce_tables.tri_rows))
    kcfg = bf.KernelConfig.from_cfg(cfg)
    before = dict(kernels.launches)
    tf, ti, thit = (x.numpy() for x in bf.bounce(_t(fs), _t(is_), tables,
                                                 kcfg, SAMPLE))
    assert dict(kernels.launches) == before
    same = (ti == ji).all(0) & (thit[1] == jhit[1]) & (thit[5] == jhit[5])
    assert same.mean() >= LANES, same.mean()
    _lanes_close(tf, jf, same, "fs")
    _lanes_close(np.delete(thit, 1, 0), np.delete(jhit, 1, 0), same, "hit")
    active = is_[bf.IS_ACTIVE] > 0
    mixed, unk = _shares(ts, fs[bf.FS_O:bf.FS_O + 3][:, active],
                         fs[bf.FS_D:bf.FS_D + 3][:, active])
    assert mixed >= MIXED_SHARE and unk >= UNKNOWN_SHARE, (mixed, unk)
    # lanes that passed through: still active, logical bounce kept
    passed = active & (ti[bf.IS_ACTIVE] > 0) \
        & (ti[bf.IS_LBOUNCE] == is_[bf.IS_LBOUNCE])
    assert passed.sum() >= 5, passed.sum()


def test_k2_omm_plain_matches_pallas_kernel(curtain):
    """K2 on the shadow requests of the external route (slot 5) at bounce
    0 of a 32 x 32 frame (the JAX external route's 1,024-lane multiple)."""
    _, js, th, ts = curtain
    tables = ts.bounce_tables
    _, cfg = _cfgs(nee_external=True)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == 5
    fs, is_ = (_t(x) for x in _camera_state(th, *CLUSTER_FRAME))
    tf, ti, thit, surf = bf.bounce(fs, is_, tables, kcfg, SAMPLE)
    res = external_nee(ts, cfg, None, surf, fs[bf.FS_D:bf.FS_D + 3],
                       thit[5] > 0.5, fs[bf.FS_PREVPDF],
                       is_[bf.IS_PREVDELTA] > 0, is_[bf.IS_PX], is_[bf.IS_PY],
                       SAMPLE, 0, lb=is_[bf.IS_LBOUNCE])
    ua = bf.alpha_uniform(cfg, is_[bf.IS_PX], is_[bf.IS_PY],
                          is_[bf.IS_LBOUNCE], SAMPLE)
    sh = bf.shadow_requests(res["shadow_o"], res["shadow_d"], res["sdist"],
                            res["do_nee"], ua)
    n = sh.shape[1]
    # the JAX rows: o, d, dist, alpha uniform (row 7), do (row 10)
    jsh = np.zeros((11, n), np.float32)
    jsh[0:7] = sh[bf.SR_O:bf.SR_DIST + 1].numpy()
    jsh[7] = sh[bf.SR_UA].numpy()
    jsh[10] = sh[bf.SR_DO].numpy()
    jt = js.bounce_tables
    want = np.asarray(bp.shadow_occlusion_call(
        jnp.asarray(jsh.reshape(11, -1, 128)), jt.tri_rows, jt.tc,
        jt.n_chunks, interpret=True, omm=True)).reshape(-1)
    got, tests = bf.occlusion(tables, sh, stats=True)
    req = sh[bf.SR_DO].numpy() > 0.5
    assert req.mean() > 0.2
    same = got.numpy() == want
    assert same[req].mean() >= LANES, same[req].mean()
    assert (got.numpy()[~req] == 1.0).all()
    w = want[req]
    assert 0.0 < w.mean() < 1.0                      # both outcomes occur
    assert (tests.numpy()[req] > 0).all()
    o = sh[bf.SR_O:bf.SR_O + 3].numpy()[:, req]
    d = sh[bf.SR_D:bf.SR_D + 3].numpy()[:, req]
    mixed, unk = _shares(ts, o, d, sh[bf.SR_DIST].numpy()[req])
    assert mixed >= MIXED_SHARE and unk >= UNKNOWN_SHARE, (mixed, unk)


# ---------------------------------------------------------------------------
# (c) K3, K4 and K5
# ---------------------------------------------------------------------------


def _groups(x, g):
    return jnp.asarray(np.ascontiguousarray(
        x.reshape(x.shape[0], g, BC.FL).swapaxes(0, 1)))


def _flat(x):
    x = np.asarray(x)
    return np.ascontiguousarray(x.swapaxes(0, 1).reshape(x.shape[1], -1))


def _tiles(x):
    return jnp.asarray(x.reshape(x.shape[0], -1, 128))


def _jcull(o3, d3, active, tmax, jt, g):
    def g4(x):
        return jnp.asarray(x.reshape(3, g, JBC._R, 128))
    return j_cull(g4(o3), g4(d3), jnp.asarray(active.reshape(g, JBC._R, 128)),
                  tmax if np.ndim(tmax) == 0 else
                  jnp.asarray(tmax.reshape(g, JBC._R, 128)),
                  jt.aabb_lo, jt.aabb_hi, KSLOTS)[0]


@pytest.fixture(scope="module")
def cluster_chain(grid_curtain):
    """The JAX K3, K4 and K5 (omm) along iterations 0-2 of the render's
    unsorted camera rays, one page, each called as the JAX clustered
    tier calls it."""
    jh, js, th, ts = grid_curtain
    jt = js.cluster_tables
    assert jt.omm and ts.cluster_tables.omm
    cfg, _ = _cfgs()
    key = bp._cfg_key(cfg)
    fs, is_ = _camera_state(th, *CLUSTER_FRAME)
    g = fs.shape[1] // BC.FL
    steps = []
    for b in range(BOUNCES):
        o3, d3 = fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3]
        active = is_[bf.IS_ACTIVE] > 0
        od = np.concatenate([d3, W.cross3(_t(o3), _t(d3)).numpy(), o3,
                             active[None].astype(np.float32)])
        cand = _jcull(o3, d3, active, np.float32(cfg.max_ray_travel), jt, g)
        ha = _flat(JBC._kernel_a1_call(
            cand, _groups(od, g), jt.blocks, KSLOTS,
            float(cfg.max_ray_travel), noprune=False, interpret=True,
            omm=True, xf=None))
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        out = JBC._kernel_a2_call(
            scal, _tiles(ha), _tiles(fs), _tiles(is_), jt.mat_rows,
            jt.light_rows, jt.env_rows, jt.tex_ct, jt.tex_meta, key,
            jt.n_lights, jt.tr, True, tex_maps=jt.tex_maps, interpret=True,
            fs2=None, prio=False, omm=True, maxb=cfg.max_bounces)
        fs2, is2, sh, hit = (np.asarray(x).reshape(x.shape[0], -1)
                             for x in out[:4])
        do = sh[BC.SH_DO] > 0.5
        cand_s = _jcull(sh[BC.SH_O:BC.SH_O + 3], sh[BC.SH_D:BC.SH_D + 3],
                        do, np.where(do, sh[BC.SH_DIST], np.float32(-3e38)),
                        jt, g)
        occ = np.asarray(JBC._kernel_b1_call(
            cand_s, _groups(sh, g), jt.blocks, KSLOTS, interpret=True,
            omm=True, xf=None)).reshape(-1)
        steps.append(dict(fs=fs, is_=is_, od=od, cand=np.asarray(cand),
                          ha=ha, out=(fs2, is2, sh, hit),
                          cand_s=np.asarray(cand_s), occ=occ))
        fs, is_ = fs2, is2
    return cfg, steps


@pytest.mark.parametrize("bounce", CHECKED)
def test_k3_k4_k5_omm_plain_match_pallas_kernels(grid_curtain, cluster_chain,
                                                 bounce):
    _, _, _, ts = grid_curtain
    cfg, steps = cluster_chain
    s = steps[bounce]
    tables = ts.cluster_tables
    before = dict(kernels.launches)
    # K3: the winner, its refit and HA_UNK
    ha = BC.closest_hit(_t(s["cand"]), _t(s["od"]), tables.blocks, KSLOTS,
                        float(cfg.max_ray_travel),
                        micro=tables.omm_word).numpy()
    jha = s["ha"]
    same = (ha[BC.HA_PRIM] == jha[BC.HA_PRIM]) \
        & (ha[BC.HA_UNK] == jha[BC.HA_UNK])
    assert same.mean() >= LANES, same.mean()
    _lanes_close(ha, jha, same, "ha")
    hit = jha[BC.HA_PRIM] >= 0
    mixed = hit & (ts.tri_opacity.numpy()[np.maximum(
        jha[BC.HA_PRIM], 0).astype(int)] == TO.MIXED)
    active = s["is_"][bf.IS_ACTIVE] > 0
    assert mixed[active].mean() >= MIXED_SHARE, mixed[active].mean()
    assert (jha[BC.HA_UNK] > 0.5)[active].mean() >= UNKNOWN_SHARE
    # K4 on the JAX K3's rows: the alpha test, the pass-through, SH_UA
    kcfg = bf.KernelConfig.from_cfg(cfg)
    out = [x.numpy() for x in BC.shade(_t(jha), _t(s["fs"]), _t(s["is_"]),
                                       tables, kcfg, SAMPLE, omm=True)]
    jfs, jis, jsh, jhit = s["out"]
    tfs, tis, tsh, thit = out
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) & (thit[5] == jhit[5])
    assert same.mean() >= LANES, same.mean()
    for name, a, b in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit)):
        _lanes_close(a, b, same, name)
    passed = active & (tis[bf.IS_ACTIVE] > 0) \
        & (tis[bf.IS_LBOUNCE] == s["is_"][bf.IS_LBOUNCE])
    assert passed.sum() >= 5, passed.sum()
    # K5 on the JAX K4's requests
    occ = BC.occlusion(_t(s["cand_s"]), _t(jsh), tables.blocks, KSLOTS,
                       micro=tables.omm_word, cover=tables.omm_cov).numpy()
    do = jsh[BC.SH_DO] > 0.5
    same = occ == s["occ"]
    assert same[do].mean() >= LANES, same[do].mean()
    assert 0.0 < s["occ"][do].mean() < 1.0
    mixed, unk = _shares(ts, jsh[BC.SH_O:BC.SH_O + 3][:, do],
                         jsh[BC.SH_D:BC.SH_D + 3][:, do],
                         jsh[BC.SH_DIST][do])
    assert mixed >= MIXED_SHARE and unk >= UNKNOWN_SHARE, (mixed, unk)
    assert dict(kernels.launches) == before


# ---------------------------------------------------------------------------
# (d) renders
# ---------------------------------------------------------------------------


def _render_close(got, want, ray_count, jray_count, occ, jocc):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and got.mean() > 0.01
    close = np.isclose(got, want, rtol=TOL, atol=TOL).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    assert int(ray_count) == int(jray_count)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(jocc))


@pytest.mark.parametrize("tier", ["fused", "clustered"])
def test_omm_render_matches_jax_tier(curtain, grid_curtain, k1_steps,
                                     cluster_chain, tier):
    """The curtain on the fused tier ("torch" on the CPU, 16 x 16) and the
    40 x 40 curtain on the clustered tier (32 x 32, one page), 1 spp,
    3 bounces plus the 2 pass-through iterations, stochastic filtering,
    against the same JAX tier."""
    jh, js, th, ts = curtain if tier == "fused" else grid_curtain
    w, h = FUSED_FRAME if tier == "fused" else CLUSTER_FRAME
    # one page, so that the JAX render's culls are the chain's compiles
    extra = dict(cluster_kslots=KSLOTS, cluster_pages=1) \
        if tier == "clustered" else {}
    jcfg, cfg = _cfgs(**extra)
    jcfg = jdispatch.resolve(js, dataclasses.replace(
        jcfg, kernel_tier=tier, pallas_interpret=True))
    want = jint.render_sample(js, JP.default_camera(jh, w, h), jcfg, w, h,
                              jnp.uint32(SAMPLE))
    resolved = dispatch.resolve(ts, cfg, "cpu")
    assert resolved.kernel_tier == ("torch" if tier == "fused" else tier)
    kernels.launches.clear()
    got = tint.render_sample(ts, TP.default_camera(th, w, h), cfg, w, h,
                             SAMPLE)
    assert not kernels.launches
    assert len(got["occupancy"]) == BOUNCES + 2 + 1
    _render_close(got["L"], want["L"], got["ray_count"], want["ray_count"],
                  got["occupancy"], want["occupancy"])
    if tier == "clustered":
        assert int(got["cull_overflow"]) == int(want["cull_overflow"])

"""The clustered tier's environment and external-NEE route against the JAX
package, on the CPU: the same numpy-seeded inputs through both packages,
the JAX side as its own tests run it (Pallas kernels in interpret mode).

  (f) K4's plain version with the environment table (bounces 0 and 1 and
      the final_env launch, power NEE) and in NEE slots 3 (NEE-AT) and 5
      (power, external) against `_kernel_a2_call` on the same 1,024-lane
      HA rows (the port's K3 output, which equals the JAX K3's,
      tests/test_torch_cluster.py): integer rows equal on >= 99.5% of
      lanes, float rows within rtol = atol = 2e-3, hit row 5 (the shading
      flag) included. The JAX `_kernel_a2` computes the SF_* export rows
      but never stores them (its surf_out stays unwritten; ROADMAP F8), so
      the port's SF_* rows are held against the JAX package's own
      `surface_and_shade` on the same inputs, which `_kernel_a2` calls.
  (g) the sky city (city_scene(4000, seed=1, blocks=2, with_env=True)),
      24x16, 1 spp, 2 bounces, on the clustered tier of both packages:
      every pixel within 2e-3, mean within 1e-4 relative, ray counts,
      occupancy and cull overflow equal; NEE-AT on the same city without
      the sky through render_adaptive on the port's clustered tier
      (external route): image and final tile_pdf against the JAX
      package's general tier at one bounce within 2e-3 (F8 leaves the
      JAX clustered route NaN; one bounce keeps the two tiers' BSDF
      energy-compensation fits out of the image).
Resolution: external NEE, NEE-AT, WRS K > 1 and more than 128 lights on
the clustered tier, flat and instanced.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import NEEMode as JNEE
from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import bounce_pallas as bp
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import NEEMode as TNEE
from rtxpt_tpu_torch.config import PathTracerConfig as TConfig
from rtxpt_tpu_torch.lighting import neeat as tna
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt import integrator as tint
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP

TOL = 2e-3
INT_LANES = 0.995
KSLOTS = 64
SAMPLE = 1
SIDE = 32                 # 1,024 lanes: one group, the renders' wavefront
BOUNCES = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch ops: the test run puts
    several test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _city(mod, with_env):
    return mod.city_scene(tri_budget=4000, seed=1, blocks=2,
                          with_env=with_env)


@pytest.fixture(scope="module")
def sky_city():
    jh, th = _city(JP, True), _city(TP, True)
    return jh, j_prepare(jh), th, prepare(th, device="cpu")


@pytest.fixture(scope="module")
def city():
    jh, th = _city(JP, False), _city(TP, False)
    return jh, j_prepare(jh), th, prepare(th, device="cpu")


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _tiles(x):
    return jnp.asarray(x.reshape(x.shape[0], -1, 128))


def _rows(x):
    return np.asarray(x).reshape(x.shape[0], -1)


def _hit_rows(scene, fs, is_):
    """K3's plain version on the wavefront (one page), post-transformed."""
    tbl = scene.cluster_tables
    ha, _ = BC.closest_paged(torch.tensor(fs), torch.tensor(is_), tbl,
                             KSLOTS, 1, 1e27)
    return BC.post_attr_inst(ha, tbl).numpy()


def _camera_state():
    """1,024 camera rays looking down on the blocks, so that rays hit
    geometry, hit emitters and escape to the sky."""
    aimed = _city(TP, False)
    aimed.camera = dict(position=[10.0, 12.0, 26.0], target=[10.0, 2.0, 8.0],
                        up=[0.0, 1.0, 0.0], fov_y_deg=60.0)
    cam = TP.default_camera(aimed, SIDE, SIDE)
    px, py = _pixel_grid(SIDE, SIDE)
    o, d, spread = camera_rays(cam, TConfig(), px, py, SAMPLE)
    return tuple(x.numpy() for x in bf.initial_state(o, d, spread, px, py))


# the K4 cases: (scene, config, chain of launches)
CASES = {
    "env": (True, dict(nee="POWER")),
    "slot3": (False, dict(nee="NEEAT")),
    "slot5": (False, dict(nee="POWER", nee_external=True)),
}


def _jax_surf(jt, key, ha, fs, is_, sample, bounce):
    """The SF_* rows that `_kernel_a2` computes (bounce_pallas.
    surface_and_shade on the HA rows, bounce_clustered.py:546-561)."""
    def body(ha, fs, is_):
        def attr(i, k=1):
            return ha[JBC.HA_ATTR + i] if k == 1 else \
                ha[JBC.HA_ATTR + i:JBC.HA_ATTR + i + k]
        t = ha[JBC.HA_T]
        s = bp.surface_and_shade(
            o=fs[0:3], d=fs[3:6], t=t, hit=t < bp._BIG,
            front=ha[JBC.HA_FRONT] > 0.0, bu=ha[JBC.HA_U], bv=ha[JBC.HA_V],
            attr=attr, thp=fs[6:9], L=fs[9:12], prev_pdf=fs[12],
            active=is_[0] > 0, prev_delta=is_[1] > 0, med0=is_[2],
            med1=is_[3], px=is_[4], py=is_[5], sample_idx=jnp.uint32(sample),
            bounce=jnp.int32(bounce), mat_ref=jt.mat_rows,
            light_ref=jt.light_rows, cfg_key=key, n_lights=jt.n_lights,
            first_emissive=True, cone=fs[13], spread=fs[14], budget=is_[6],
            lbounce=is_[7])
        return s["surf"]
    return _rows(jax.jit(body)(_tiles(ha), _tiles(fs), _tiles(is_)))


@pytest.fixture(scope="module")
def k4_chains(sky_city, city):
    """case -> the JAX K4 along bounces 0 and 1 (and the final round with
    the environment) on the port K3's hit rows, made at first use. The
    calls carry the keywords of the JAX clustered tier's
    (bounce_clustered.py:1809, :2029), so that the render below finds the
    environment compiles in jit's cache."""
    chains = {}

    def get(case):
        if case not in chains:
            chains[case] = _k4_chain(case, sky_city, city)
        return chains[case]
    return get


def _k4_chain(case, sky_city, city):
    env, mode = CASES[case]
    jh, js, th, ts = sky_city if env else city
    jt = js.cluster_tables
    cfg = JConfig(max_bounces=BOUNCES, nee=JNEE[mode["nee"]],
                  nee_external=mode.get("nee_external", False))
    key = bp._cfg_key(cfg)
    fs, is_ = _camera_state()
    steps = []
    for b in range(BOUNCES + env):
        final = b == BOUNCES
        ha = _hit_rows(ts, fs, is_)
        scal = jnp.stack([jnp.uint32(SAMPLE), jnp.uint32(b)]).reshape(1, 2)
        args = (scal, _tiles(ha), _tiles(fs), _tiles(is_), jt.mat_rows,
                jt.light_rows, jt.env_rows, None, None, key, jt.n_lights,
                jt.tr, True)
        if final:
            out = JBC._kernel_a2_call(*args, final_env=True, interpret=True,
                                      fs2=None)
        else:
            out = JBC._kernel_a2_call(*args, tex_maps=(1, 0, 0, 0),
                                      interpret=True, fs2=None, prio=False,
                                      omm=False, maxb=None)
        outs = tuple(_rows(x) for x in out[:4])
        surf = None
        if key[0] in bf.EXTERNAL_MODES and not final:
            surf = _jax_surf(jt, key, ha, fs, is_, SAMPLE, b)
        steps.append(dict(fs=fs, is_=is_, ha=ha, out=outs, surf=surf))
        fs, is_ = outs[0], outs[1]
    return cfg, ts, steps


@pytest.mark.parametrize("case,step", [
    ("env", "bounce0"), ("env", "bounce1"), ("env", "final_env"),
    ("slot3", "bounce0"), ("slot3", "bounce1"),
    ("slot5", "bounce0"), ("slot5", "bounce1")])
def test_k4_variants_plain_match_pallas_kernel(k4_chains, case, step):
    cfg, scene, steps = k4_chains(case)
    b = ("bounce0", "bounce1", "final_env").index(step)
    s = steps[b]
    tables = scene.cluster_tables
    kcfg = bf.KernelConfig.from_cfg(TConfig(
        max_bounces=BOUNCES, nee=TNEE[cfg.nee.name],
        nee_external=cfg.nee_external))
    assert kcfg.nee_mode == bp._cfg_key(cfg)[0]
    assert (tables.env is not None) == (case == "env")
    before = dict(kernels.launches)
    out = [x.numpy() for x in BC.shade(
        torch.tensor(s["ha"]), torch.tensor(s["fs"]), torch.tensor(s["is_"]),
        tables, kcfg, SAMPLE, final_env=step == "final_env")]
    assert dict(kernels.launches) == before
    jfs, jis, jsh, jhit = s["out"]
    tfs, tis, tsh, thit = out[:4]
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) \
        & (tsh[BC.SH_DO] == jsh[BC.SH_DO])
    assert same.mean() >= INT_LANES, same.mean()
    for name, a, c in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit)):
        _close(a[:, same], c[:, same], TOL, name)
    if s["surf"] is not None:
        # the export: the SF_* rows, and hit row 5 the shading flag
        assert len(out) == 5
        shaded = thit[5] > 0.5
        assert shaded.mean() > 0.1
        _close(out[4][:, same & shaded], s["surf"][:, same & shaded], TOL,
               "SF rows")
        assert set(np.unique(thit[5])) <= {0.0, 1.0 + b}
        assert (tsh[BC.SH_DO] == 0).all()
    else:
        assert len(out) == 4
    if case == "env":
        miss = (s["is_"][bf.IS_ACTIVE] > 0) & (s["ha"][BC.HA_PRIM] < 0)
        assert miss.sum() > 20
        gain = (tfs[bf.FS_L:bf.FS_L + 3]
                - s["fs"][bf.FS_L:bf.FS_L + 3]).sum(0)
        assert (gain[miss] > 0).mean() > 0.9
        if step == "final_env":
            assert (tis[bf.IS_ACTIVE] == 0).all() and (tsh == 0).all()


def test_sky_city_render_matches_jax_clustered_tier(sky_city, monkeypatch):
    jh, js, th, ts = sky_city
    w, h = 24, 16
    monkeypatch.setattr(JBC, "_SCAN", False)
    jcfg = JConfig(max_bounces=BOUNCES, kernel_tier="clustered",
                   pallas_interpret=True, cluster_kslots=KSLOTS,
                   cluster_pages=2)
    ref = jint.render_sample(js, JP.default_camera(jh, w, h), jcfg, w, h,
                             jnp.uint32(SAMPLE))
    kernels.launches.clear()
    out = tint.render_sample(ts, TP.default_camera(th, w, h),
                             TConfig(max_bounces=BOUNCES), w, h, SAMPLE)
    assert not kernels.launches
    assert out["kernel_tier"] == "clustered"
    assert ts.cluster_tables.env is not None
    a, b = np.asarray(ref["L"]), out["L"].numpy()
    assert np.isfinite(b).all()
    _close(b, a, TOL, "image")
    assert abs(b.mean() - a.mean()) <= 1e-4 * abs(a.mean())
    assert int(out["ray_count"]) == int(ref["ray_count"])
    np.testing.assert_array_equal(out["occupancy"].numpy(),
                                  np.asarray(ref["occupancy"]))
    assert int(out["cull_overflow"]) == int(ref["cull_overflow"])
    assert int(out["occupancy"][-1]) == 0           # the final round ran


def test_neeat_city_render_matches_jax(city):
    """NEE-AT through render_adaptive on the clustered tier (K4's slot 3,
    external_nee, K5 and the feedback) against the JAX general tier's
    render_adaptive at one bounce, 24x16, 2 spp."""
    jh, js, th, ts = city
    w, h = 24, 16
    cfg = TConfig(max_bounces=1, nee=TNEE.NEEAT)
    state = tna.init_state(w, h, ts.lights.count, device="cpu")
    resolved = dispatch.resolve(ts, cfg, "cpu", state)
    assert resolved.kernel_tier == "clustered" and resolved.nee_external
    jcfg = JConfig(max_bounces=1, nee=JNEE.NEEAT, kernel_tier="xla")
    want, jstate, _ = jint.render_adaptive(js, JP.default_camera(jh, w, h),
                                           jcfg, w, h, spp=2)
    got, tstate, rays = tint.render_adaptive(ts, TP.default_camera(th, w, h),
                                             cfg, w, h, spp=2)
    assert torch.isfinite(got).all() and rays > 2 * w * h
    _close(got.numpy(), want, TOL, "image")
    _close(tstate.tile_pdf.numpy(), jstate.tile_pdf, TOL, "tile_pdf")
    # the sampler learned: lit tiles left the uniform pmf
    pdf = tstate.tile_pdf.numpy()
    assert np.abs(pdf - 1.0 / ts.lights.count).max() > 0.05


def _more_lights(scene):
    """The scene with a light list (and tables) of 129 lights."""
    kind = torch.zeros((bf.MAX_LIGHTS + 1,), dtype=torch.int32)
    return scene.replace(
        lights=dataclasses.replace(scene.lights, kind=kind),
        cluster_tables=dataclasses.replace(scene.cluster_tables,
                                           n_lights=bf.MAX_LIGHTS + 1))


@pytest.fixture(scope="module")
def instanced():
    host = TP.instanced_city(grid=2, subdiv=6)
    scene = prepare(host, device="cpu")
    assert scene.cluster_tables.instanced
    return host, scene


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", ["neeat", "wrs", "lights",
                                  "instanced_neeat", "instanced_wrs",
                                  "instanced_lights"])
def test_resolve_serves_external_nee_on_the_clustered_tier(
        city, instanced, case, device):
    """NEE-AT with a tile state, WRS K = 4 and more than 128 lights
    resolve to the clustered tier with nee_external, flat and instanced,
    under "auto" and pinned; the in-kernel route keeps it off."""
    scene = instanced[1] if case.startswith("instanced_") else city[3]
    kind = case.replace("instanced_", "")
    cfg, state = TConfig(), None
    if kind == "neeat":
        cfg = TConfig(nee=TNEE.NEEAT)
        state = tna.init_state(8, 8, scene.lights.count, device="cpu")
    elif kind == "wrs":
        cfg = TConfig(nee_candidates=4)
    else:
        scene = _more_lights(scene)
    for asked in (cfg, dataclasses.replace(cfg, kernel_tier="clustered")):
        out = dispatch.resolve(scene, asked, device, state)
        assert out.kernel_tier == "clustered" and out.nee_external
    assert not dispatch.resolve(scene if kind != "lights" else city[3],
                                TConfig(), device).nee_external


def test_instanced_neeat_renders_on_the_clustered_tier(instanced):
    """NEE-AT on the instanced city's clustered tier: the external route
    through K3's and K5's instanced variants, finite, learning."""
    host, scene = instanced
    w, h = 16, 16
    cfg = TConfig(max_bounces=2, nee=TNEE.NEEAT)
    hdr, state, rays = tint.render_adaptive(
        scene, TP.default_camera(host, w, h), cfg, w, h, spp=2)
    assert torch.isfinite(hdr).all() and float(hdr.mean()) > 0.0
    assert rays > w * h
    assert state.tile_pdf.shape[1] == scene.lights.count

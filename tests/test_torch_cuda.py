"""The CUDA kernels on the card: each against its plain PyTorch version on
the same CUDA inputs, and the wrappers' launch counts and checks: K1 on
the Cornell box and the small scenes, K1's external modes and the shadow
kernel K2 on the Cornell box and the rooms, K3, K4 and K5 on the small
city of tests/test_torch_cluster.py, K3's and K5's instanced variants on
the instanced city of tests/test_torch_instancing.py, and the general
tier's brute-force closest hit K8 and BVH walk K9 on the Cornell box, the
rooms and that city, and the environment variants of K1 and K4 (has_env,
final_env) with K4's export slots 3-5, on the sky Cornell box and the sky
city, the texture variants of K1 and K4, the micromap variants of K1,
K2, K3, K4, K5 and K9 on the curtain Cornell box and its 40 x 40 grid,
and the nested-priority variants of K1 and K4 on the overlap boxes and a
small Bistro, with the closed-form overlap radiance on every tier, and
the per-row kernels K6 and K7 on the small city and its sky variant, and
all sixteen instantiations of K1 and K4 (the texture, micromap, priority
and split-channel switches; the priority ones on the overlap curtain),
K4's split variant in the export slots on the rooms, with the split +
aux renders of every tier, and K1's sixteen restart instantiations (the
V-buffer restart and first_direct=False), its inject variant on the
glass-over-mirror box's stable planes, and the real-time frames against
the CPU.
Needs an NVIDIA GPU and nvcc; skips without them. This file imports no
JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel import brute, traverse
from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.lighting.sky import make_sky
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import (
    _pixel_grid, camera_rays, render, render_adaptive, render_sample)
from rtxpt_tpu_torch.pt.nee_external import external_nee
from rtxpt_tpu_torch.scene import procedural as TP

pytestmark = pytest.mark.cuda

TOL = 2e-3


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def cornell(gpu):
    host = TP.cornell_box()
    return host, prepare(host, device=gpu)


def _state(host, cfg, side, device, sample):
    cam = TP.default_camera(host, side, side, device=device)
    px, py = _pixel_grid(side, side, device)
    o, d, spread = camera_rays(cam, cfg, px, py, sample)
    return bf.initial_state(o, d, spread, px, py)


CONFIGS = {
    "power": (TP.cornell_box, {}, {}),
    "uniform_nomis": (TP.cornell_box, {},
                      dict(nee=NEEMode.UNIFORM, enable_mis=False)),
    "off_hash": (TP.cornell_box, {},
                 dict(nee=NEEMode.OFF, low_discrepancy=False)),
    "specular_firefly_noec": (TP.cornell_box, dict(sphere_specular=True),
                              dict(firefly_clamp=2.0,
                                   kernel_energy_comp=False)),
    "furnace_norr": (TP.furnace_box, dict(albedo=0.8, emission=0.5),
                     dict(enable_russian_roulette=False)),
    "triangle_point": (TP.single_triangle, dict(light_kind="point"), {}),
    "triangle_directional": (TP.single_triangle,
                             dict(light_kind="directional"), {}),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_k1_matches_plain_version(gpu, name):
    make, host_kw, cfg_kw = CONFIGS[name]
    host = make(**host_kw)
    scene = prepare(host, device=gpu)
    cfg = PathTracerConfig(max_bounces=5, **cfg_kw)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    for b in range(4):
        plain = bf.bounce_reference(fs, is_, scene.bounce_tables, kcfg, 2)
        kern = bf.bounce(fs, is_, scene.bounce_tables, kcfg, 2)
        torch.cuda.synchronize()
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        assert same.float().mean() >= 0.999
        for k, p in ((kern[0], plain[0]), (kern[2], plain[2])):
            ok = torch.isclose(k, p, rtol=TOL, atol=TOL, equal_nan=True)
            assert ok.float().mean(1).min() >= 0.999, b
        fs, is_ = plain[0], plain[1]


EXTERNAL = {
    "cornell_neeat": (TP.cornell_box, {}, dict(nee=NEEMode.NEEAT)),
    "cornell_uniform_ext": (TP.cornell_box, {},
                            dict(nee=NEEMode.UNIFORM, nee_external=True)),
    "rooms_power_ext": (TP.rooms_scene, dict(n_rooms=16),
                        dict(nee=NEEMode.POWER, nee_external=True)),
}


@pytest.mark.parametrize("name", list(EXTERNAL))
def test_external_modes_and_k2_match_plain_versions(gpu, name):
    """K1 in nee slots 3-5 (the SF_* rows included) and K2 on the shadow
    requests external_nee builds from them, over three bounces of 4096
    camera rays, the state carried by the plain versions."""
    make, host_kw, cfg_kw = EXTERNAL[name]
    host = make(**host_kw)
    scene = prepare(host, device=gpu)
    cfg = PathTracerConfig(max_bounces=5, **cfg_kw)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.external
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    for b in range(3):
        plain = bf.bounce_reference(fs, is_, scene.bounce_tables, kcfg, 2)
        kern = bf.bounce(fs, is_, scene.bounce_tables, kcfg, 2)
        torch.cuda.synchronize()
        assert len(kern) == len(plain) == 4
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        assert same.float().mean() >= 0.999
        for k, p in ((kern[0], plain[0]), (kern[2], plain[2]),
                     (kern[3], plain[3])):
            ok = torch.isclose(k, p, rtol=TOL, atol=TOL, equal_nan=True)
            assert ok.float().mean(1).min() >= 0.999, b
        if kcfg.nee_mode != 3:
            res = external_nee(scene, cfg, None, plain[3], fs[3:6],
                               plain[2][5] > 0.5, fs[bf.FS_PREVPDF],
                               is_[bf.IS_PREVDELTA] > 0, plain[1][bf.IS_PX],
                               plain[1][bf.IS_PY], 2, b)
            sh = bf.shadow_requests(res["shadow_o"], res["shadow_d"],
                                    res["sdist"], res["do_nee"])
            occ_p, tst_p = bf.occlusion_reference(scene.bounce_tables, sh,
                                                  stats=True)
            before = kernels.launches["shadow_occlusion"]
            occ_k, tst_k = bf.occlusion(scene.bounce_tables, sh, stats=True)
            torch.cuda.synchronize()
            assert kernels.launches["shadow_occlusion"] == before + 1
            req = sh[bf.SR_DO] > 0.5
            assert req.any()
            assert (occ_k == occ_p)[req].float().mean() >= 0.999, b
            assert torch.equal(tst_k, tst_p)
            assert res["do_nee"].any()
        fs, is_ = plain[0], plain[1]


@pytest.mark.parametrize("kind", ["neeat", "wrs"])
def test_external_render_runs_through_k1_and_k2(cornell, kind):
    """Every bounce of an external-NEE render launches K1 and K2 once."""
    host, scene = cornell
    cam = TP.default_camera(host, 32, 32)
    kernels.launches.clear()
    if kind == "neeat":
        hdr, state, rays = render_adaptive(
            scene, cam, PathTracerConfig(max_bounces=3, nee=NEEMode.NEEAT),
            32, 32, spp=2)
        assert state.frame == 2
    else:
        hdr, _, rays = render(scene, cam, PathTracerConfig(
            max_bounces=3, nee_candidates=4), 32, 32, spp=2)
    assert dict(kernels.launches) == dict(bounce_fused=3 * 2,
                                          shadow_occlusion=3 * 2)
    assert torch.isfinite(hdr).all() and rays > 0


def test_launch_counter_counts_each_launch(cornell):
    host, scene = cornell
    fs, is_ = _state(host, PathTracerConfig(), 16, scene.bounce_tables.device,
                     0)
    before = kernels.launches["bounce_fused"]
    bf.bounce(fs, is_, scene.bounce_tables, bf.KernelConfig(), 0)
    assert kernels.launches["bounce_fused"] == before + 1


def test_render_runs_every_bounce_through_k1(cornell):
    host, scene = cornell
    cam = TP.default_camera(host, 32, 32)
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, PathTracerConfig(max_bounces=3), 32,
                          32, spp=2)
    assert kernels.launches["bounce_fused"] == 3 * 2
    assert torch.isfinite(hdr).all() and rays > 0


def test_wrapper_refuses_tables_on_another_device(cornell):
    host, scene = cornell
    cpu_tables = prepare(host, device="cpu").bounce_tables
    fs, is_ = _state(host, PathTracerConfig(), 8, scene.bounce_tables.device,
                     0)
    with pytest.raises(ValueError, match="expected cuda"):
        bf.bounce(fs, is_, cpu_tables, bf.KernelConfig(), 0)


@pytest.fixture(scope="module")
def city(gpu):
    host = TP.city_scene(tri_budget=4000, seed=1, blocks=2)
    return host, prepare(host, device=gpu)


@pytest.mark.parametrize("kslots", [64, 8])
def test_clustered_kernels_match_plain_versions(city, kslots):
    """K3, K4 and K5 against their plain versions over three bounces of
    4096 sorted camera rays, the state carried by the plain versions;
    kslots 8 saturates the candidate lists."""
    host, scene = city
    tbl = scene.cluster_tables
    dev = tbl.device
    cfg = PathTracerConfig(max_bounces=4)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    bounds = BC.scene_bounds(tbl)
    fs, is_ = _state(host, cfg, 64, dev, 1)
    src = torch.arange(fs.shape[1], dtype=torch.int32, device=dev)
    for b in range(3):
        fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0, bounds)
        od = BC.ray_operand(fs, is_)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, cfg.max_ray_travel, tbl,
                          kslots)
        ha_p, vis_p = BC.closest_hit_reference(
            cand, od, tbl.blocks, kslots, cfg.max_ray_travel, stats=True)
        ha_k, vis_k = BC.closest_hit(cand, od, tbl.blocks, kslots,
                                     cfg.max_ray_travel, stats=True)
        same = ha_k[BC.HA_PRIM] == ha_p[BC.HA_PRIM]
        assert same.float().mean() >= 0.999, b
        # lanes that missed earlier carry NaN origins, so NaN u, v
        ok = torch.isclose(ha_k, ha_p, rtol=TOL, atol=TOL, equal_nan=True)
        assert ok.float().mean(1).min() >= 0.999, b
        assert torch.equal(vis_k, vis_p)
        plain = BC.shade_reference(ha_p, fs, is_, tbl, kcfg, 1)
        kern = BC.shade(ha_p, fs, is_, tbl, kcfg, 1)
        same = (kern[1] == plain[1]).all(0) & (kern[3][1] == plain[3][1])
        assert same.float().mean() >= 0.999, b
        for k, p in zip(kern, plain):
            ok = torch.isclose(k.float(), p.float(), rtol=TOL, atol=TOL,
                               equal_nan=True)
            assert ok.float().mean(1).min() >= 0.999, b
        shp, _ = BC.sort_shadows(plain[2], bounds)
        dop = shp[BC.SH_DO] > 0.5
        cand_s, _ = BC.cull(shp[BC.SH_O:BC.SH_O + 3],
                            shp[BC.SH_D:BC.SH_D + 3], dop,
                            torch.where(dop, shp[BC.SH_DIST], -3e38), tbl,
                            kslots)
        occ_p, tst_p = BC.occlusion_reference(cand_s, shp, tbl.blocks,
                                              kslots, stats=True)
        occ_k, tst_k = BC.occlusion(cand_s, shp, tbl.blocks, kslots,
                                    stats=True)
        assert (occ_k == occ_p).float().mean() >= 0.999, b
        assert torch.equal(tst_k, tst_p)
        fs, is_ = plain[0], plain[1]


def test_city_render_runs_through_k3_k4_k5(city):
    """Every bounce of a clustered render launches K3 and K5 once per page
    and K4 once (kslots 16: two pages)."""
    host, scene = city
    cam = TP.default_camera(host, 32, 24)
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, PathTracerConfig(
        max_bounces=3, cluster_kslots=16), 32, 24, spp=2)
    assert dict(kernels.launches) == dict(
        cluster_closest=2 * 3 * 2, cluster_shade=3 * 2,
        cluster_shadow=2 * 3 * 2)
    assert torch.isfinite(hdr).all() and rays > 0


def test_clustered_tier_refuses_unserved_feature_on_the_card(city, gpu):
    """A textured city pinned to the clustered tier without stochastic
    texture filtering (the kernels' texture path) raises by name."""
    scene = prepare(TP.city_scene(tri_budget=4000, seed=1, blocks=2,
                                  textured=True), device=gpu)
    with pytest.raises(NotImplementedError,
                       match="clustered tier does not serve: textures "
                             "without stochastic texture filtering"):
        dispatch.resolve(scene, PathTracerConfig(kernel_tier="clustered"),
                         gpu)


def test_clustered_wrappers_refuse_tables_on_another_device(city):
    host, scene = city
    cpu = prepare(host, device="cpu").cluster_tables
    fs, is_ = _state(host, PathTracerConfig(), 32, scene.cluster_tables
                     .device, 0)
    od = BC.ray_operand(fs, is_)
    cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                      is_[bf.IS_ACTIVE] > 0, 1e27, scene.cluster_tables, 8)
    with pytest.raises(ValueError, match="same device"):
        BC.closest_hit(cand, od, cpu.blocks, 8, 1e27)


@pytest.fixture(scope="module")
def instanced_city(gpu):
    host = TP.instanced_city(grid=2, subdiv=6)
    return host, prepare(host, device=gpu)


@pytest.mark.parametrize("kslots", [32, 8])
def test_instanced_kernels_match_plain_versions(instanced_city, kslots):
    """K3's and K5's instanced variants against their plain versions over
    three bounces of 4096 sorted camera rays of the instanced city, the
    state carried by the plain versions (K4 on the post-transformed hits);
    kslots 8 saturates the candidate lists of its 32 world candidates."""
    host, scene = instanced_city
    tbl = scene.cluster_tables
    assert tbl.instanced
    dev = tbl.device
    cfg = PathTracerConfig(max_bounces=4)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    bounds = BC.scene_bounds(tbl)
    fs, is_ = _state(host, cfg, 64, dev, 1)
    src = torch.arange(fs.shape[1], dtype=torch.int32, device=dev)
    kernels.launches.clear()
    for b in range(3):
        fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0, bounds)
        od = BC.ray_operand(fs, is_)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, cfg.max_ray_travel, tbl,
                          kslots)
        cand = BC.map_cand_inst(cand, tbl, kslots)
        ha_p, vis_p = BC.closest_hit_reference(
            cand, od, tbl.blocks, kslots, cfg.max_ray_travel, stats=True,
            xf=tbl.xf)
        ha_k, vis_k = BC.closest_hit(cand, od, tbl.blocks, kslots,
                                     cfg.max_ray_travel, stats=True,
                                     xf=tbl.xf)
        same = (ha_k[BC.HA_PRIM] == ha_p[BC.HA_PRIM]) \
            & (ha_k[BC.HA_INST] == ha_p[BC.HA_INST]) \
            & ((ha_k[BC.HA_FRONT] > 0) == (ha_p[BC.HA_FRONT] > 0))
        assert same.float().mean() >= 0.999, b
        ok = torch.isclose(ha_k, ha_p, rtol=TOL, atol=TOL, equal_nan=True)
        assert ok.float().mean(1).min() >= 0.999, b
        assert torch.equal(vis_k, vis_p)
        if b == 0:
            hit = ha_p[BC.HA_PRIM] >= 0
            assert hit.float().mean() > 0.5
            assert len(torch.unique(ha_p[BC.HA_INST][hit])) >= 3
        plain = BC.shade_reference(BC.post_attr_inst(ha_p, tbl), fs, is_,
                                   tbl, kcfg, 1)
        shp, _ = BC.sort_shadows(plain[2], bounds)
        dop = shp[BC.SH_DO] > 0.5
        cand_s, _ = BC.cull(shp[BC.SH_O:BC.SH_O + 3],
                            shp[BC.SH_D:BC.SH_D + 3], dop,
                            torch.where(dop, shp[BC.SH_DIST], -3e38), tbl,
                            kslots)
        cand_s = BC.map_cand_inst(cand_s, tbl, kslots)
        occ_p, tst_p = BC.occlusion_reference(cand_s, shp, tbl.blocks,
                                              kslots, stats=True, xf=tbl.xf)
        occ_k, tst_k = BC.occlusion(cand_s, shp, tbl.blocks, kslots,
                                    stats=True, xf=tbl.xf)
        assert (occ_k == occ_p).float().mean() >= 0.999, b
        assert torch.equal(tst_k, tst_p)
        fs, is_ = plain[0], plain[1]
    assert dict(kernels.launches) == dict(cluster_closest_inst=3,
                                          cluster_shadow_inst=3)


def test_instanced_render_runs_through_the_instanced_kernels(
        instanced_city):
    """Every bounce of an instanced clustered render launches K3's and
    K5's instanced variants once per page and K4 once (kslots 16: two
    pages); the TLAS route launches none."""
    host, scene = instanced_city
    cam = TP.default_camera(host, 32, 24)
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, PathTracerConfig(
        max_bounces=3, cluster_kslots=16), 32, 24, spp=2)
    assert dict(kernels.launches) == dict(
        cluster_closest_inst=2 * 3 * 2, cluster_shade=3 * 2,
        cluster_shadow_inst=2 * 3 * 2)
    assert torch.isfinite(hdr).all() and float(hdr.mean()) > 1e-3
    kernels.launches.clear()
    hdr_x, _, _ = render(scene, cam, PathTracerConfig(
        max_bounces=3, kernel_tier="xla"), 32, 24, spp=2)
    assert not kernels.launches and torch.isfinite(hdr_x).all()


# ---------------------------------------------------------------------------
# The general tier: K8 (brute-force closest hit) and K9 (BVH walk)
# ---------------------------------------------------------------------------


def _query_rays(host, device, side, seed):
    """Camera rays of a side x side frame, then as many rays from random
    points inside the scene's bounds in random directions with random
    shadow-like tmax, and a few NaN rays: (o, d, tmin, tmax)."""
    cfg = PathTracerConfig()
    cam = TP.default_camera(host, side, side, device=device)
    px, py = _pixel_grid(side, side, device)
    o, d, _ = camera_rays(cam, cfg, px, py, 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = o.shape[0]
    pos = torch.as_tensor(host.flatten().geometry.positions)
    lo, hi = pos.min(0).values, pos.max(0).values
    o2 = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    d2 = torch.randn((n, 3), generator=g)
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    o = torch.cat([o, o2.to(device)]).contiguous()
    d = torch.cat([d, d2.to(device)]).contiguous()
    d[:4] = float("nan")
    tmin = torch.zeros((2 * n,), device=device)
    tmax = torch.cat([torch.full((n,), 1e27),
                      torch.rand((n,), generator=g) * (hi - lo).norm()])
    return o, d, tmin, tmax.to(device)


def _hits_agree(k, p):
    same = k["prim"] == p["prim"]
    assert same.float().mean() >= 0.999
    assert (p["prim"] >= 0).float().mean() > 0.2
    for key in ("t", "uv"):
        ok = torch.isclose(k[key], p[key], rtol=TOL, atol=TOL,
                           equal_nan=True)
        ok = ok if ok.ndim == 1 else ok.all(1)
        assert ok.float().mean() >= 0.999, key
    assert (k["front"] == p["front"]).float().mean() >= 0.999


@pytest.mark.parametrize("scene_name", ["cornell", "rooms"])
def test_k8_matches_plain_version(gpu, scene_name):
    host = TP.cornell_box() if scene_name == "cornell" else \
        TP.rooms_scene(16)
    scene = prepare(host, device=gpu)
    assert scene.bvh.brute is not None
    rays = _query_rays(host, gpu, 64, 1)
    kern = brute.closest(scene.bvh.brute, *rays)
    plain = brute._closest_plain(scene.bvh.brute, *rays)
    torch.cuda.synchronize()
    _hits_agree(kern, plain)


@pytest.mark.parametrize("any_hit", [False, True])
def test_k9_matches_plain_version(city, any_hit):
    host, scene = city
    rays = _query_rays(host, scene.bvh.device, 64, 2)
    kern = traverse.walk(scene.bvh, *rays, any_hit=any_hit, stats=True)
    plain = traverse._traverse(scene.bvh, *rays, any_hit, stats=True)
    torch.cuda.synchronize()
    if any_hit:
        occ_k, occ_p = kern["prim"] >= 0, plain["prim"] >= 0
        assert (occ_k == occ_p).float().mean() >= 0.999
    else:
        _hits_agree(kern, plain)
    assert torch.equal(kern["visits"], plain["visits"])
    assert torch.equal(kern["tests"], plain["tests"])


@pytest.mark.parametrize("walk", [False, True])
def test_general_render_runs_through_k8_or_k9(gpu, monkeypatch, walk):
    """A general-tier render launches K8 once per bounce and chunk (the
    shadow rays ride in the next bounce's query), or, with the brute
    force disabled, K9 once per bounce for the closest hits and once per
    NEE bounce for the shadow rays."""
    if walk:
        monkeypatch.setattr(brute, "BRUTE_MAX_TRIS", 16)
    host = TP.cornell_box()
    scene = prepare(host, device=gpu)
    assert (scene.bvh.brute is None) == walk
    cam = TP.default_camera(host, 32, 32)
    cfg = PathTracerConfig(max_bounces=3, kernel_tier="xla")
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, cfg, 32, 32, spp=2)
    want = dict(bvh_traverse=(4 + 3) * 2) if walk else \
        dict(brute_closest=4 * 2)
    assert dict(kernels.launches) == want
    assert torch.isfinite(hdr).all() and rays > 0


def test_general_tier_refuses_a_cpu_light_list(cornell):
    host, scene = cornell
    cpu_lights = prepare(host, device="cpu").lights
    with pytest.raises(ValueError, match="one device"):
        render(scene.replace(lights=cpu_lights),
               TP.default_camera(host, 8, 8),
               PathTracerConfig(kernel_tier="xla"), 8, 8, spp=1)


# ---------------------------------------------------------------------------
# The environment variants of K1 and K4, and K4's export
# ---------------------------------------------------------------------------


def _close_rows(kern, plain):
    for k, p in zip(kern, plain):
        if k.dtype == torch.int32:
            continue
        ok = torch.isclose(k, p, rtol=TOL, atol=TOL, equal_nan=True)
        assert ok.float().mean(-1).min() >= 0.999


@pytest.mark.parametrize("nee", ["POWER", "UNIFORM", "POWER_EXT"])
def test_k1_env_matches_plain_version(gpu, nee):
    """K1 with the environment table (has_env) over three bounces of 4096
    Cornell + sky camera rays, then the final_env launch."""
    host = TP.cornell_box()
    host.envmap_image = make_sky()
    scene = prepare(host, device=gpu)
    assert scene.bounce_tables.env is not None
    cfg = PathTracerConfig(max_bounces=3, nee=NEEMode[nee.split("_")[0]],
                           nee_external=nee.endswith("EXT"))
    kcfg = bf.KernelConfig.from_cfg(cfg)
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    for b in range(4):
        final = b == 3
        plain = bf.bounce_reference(fs, is_, scene.bounce_tables, kcfg, 2,
                                    final_env=final)
        before = dict(kernels.launches)
        kern = bf.bounce(fs, is_, scene.bounce_tables, kcfg, 2,
                         final_env=final)
        torch.cuda.synchronize()
        name = "bounce_fused_final" if final else "bounce_fused_env"
        assert kernels.launches[name] == before.get(name, 0) + 1
        assert len(kern) == len(plain)
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        fs, is_ = plain[0], plain[1]
    assert int(is_[bf.IS_ACTIVE].sum()) == 0


@pytest.fixture(scope="module")
def sky_city(gpu):
    host = TP.city_scene(tri_budget=4000, seed=1, blocks=2, with_env=True)
    return host, prepare(host, device=gpu)


@pytest.mark.parametrize("nee", ["POWER", "NEEAT", "POWER_EXT"])
def test_k4_env_and_export_match_plain_version(gpu, sky_city, city, nee):
    """K4 with the environment table, its final_env launch (power NEE on
    the sky city) and its export slots 3 and 5 (the city), SF_* rows and
    hit row 5 included, over three bounces of 4096 lanes."""
    host, scene = sky_city if nee == "POWER" else city
    tbl = scene.cluster_tables
    cfg = PathTracerConfig(max_bounces=3, nee=NEEMode[nee.split("_")[0]],
                           nee_external=nee.endswith("EXT"))
    kcfg = bf.KernelConfig.from_cfg(cfg)
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    for b in range(3 + (tbl.env is not None)):
        final = b == 3
        ha, _ = BC.closest_paged(fs, is_, tbl, 64, 1, 1e27)
        plain = BC.shade_reference(ha, fs, is_, tbl, kcfg, 2, final)
        kern = BC.shade(ha, fs, is_, tbl, kcfg, 2, final_env=final)
        torch.cuda.synchronize()
        assert len(kern) == len(plain) == (5 if kcfg.external and not final
                                           else 4)
        same = (kern[1] == plain[1]).all(0) & (kern[3][5] == plain[3][5])
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        fs, is_ = plain[0], plain[1]


def test_env_renders_count_their_launches(gpu, sky_city):
    """A render of the sky Cornell box and of the sky city: K1 runs its
    environment variant per bounce and one final launch per sample; the
    clustered tier runs K3 per page and bounce plus the final round's
    pages, K4's environment variant per bounce and one final K4."""
    host = TP.cornell_box()
    host.envmap_image = make_sky()
    scene = prepare(host, device=gpu)
    kernels.launches.clear()
    hdr, _, rays = render(scene, TP.default_camera(host, 32, 32, device=gpu),
                          PathTracerConfig(max_bounces=3), 32, 32, spp=2)
    assert dict(kernels.launches) == dict(bounce_fused_env=3 * 2,
                                          bounce_fused_final=2)
    assert torch.isfinite(hdr).all() and rays > 0
    host, scene = sky_city
    kernels.launches.clear()
    hdr, _, rays = render(scene, TP.default_camera(host, 32, 24, device=gpu),
                          PathTracerConfig(max_bounces=3, cluster_kslots=16),
                          32, 24, spp=2)
    assert dict(kernels.launches) == dict(
        cluster_closest=2 * 4 * 2, cluster_shade_env=3 * 2,
        cluster_shade_final=2, cluster_shadow=2 * 3 * 2)
    assert torch.isfinite(hdr).all() and rays > 0


def _textured_cornell(env=True):
    """The textured Cornell box with every map: checker, metal-rough,
    ripple normal map, and the light's emission textured."""
    host = TP.textured_cornell(with_env=env, with_mr=True, with_normal=True)
    host.materials = host.materials.replace(
        emissive_tex=torch.tensor([-1, -1, -1, 1, -1], dtype=torch.int32))
    return host


@pytest.mark.parametrize("case", ["slot2_env", "slot2", "slot5_kitchen"])
def test_k1_tex_matches_plain_version(gpu, case):
    """K1's texture variant (tex_maps (1, 1, 1, 1) on the textured Cornell
    box, with and without the sky; the kitchen's external slot 5 with its
    SF_* rows) over three bounces of 4096 camera rays."""
    if case == "slot5_kitchen":
        host = TP.kitchen_scene()
    else:
        host = _textured_cornell(env=case.endswith("env"))
    scene = prepare(host, device=gpu)
    tbl = scene.bounce_tables
    assert tbl.tex is not None
    cfg = dispatch.resolve(scene, PathTracerConfig(
        max_bounces=3, stochastic_texture_filtering=True), gpu)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == (5 if case == "slot5_kitchen" else 2)
    name = bf.variant_name("bounce_fused", tbl.env is not None, False, True)
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    for _ in range(3):
        plain = bf.bounce_reference(fs, is_, tbl, kcfg, 2)
        before = dict(kernels.launches)
        kern = bf.bounce(fs, is_, tbl, kcfg, 2)
        torch.cuda.synchronize()
        assert kernels.launches[name] == before.get(name, 0) + 1
        assert len(kern) == len(plain)
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        fs, is_ = plain[0], plain[1]


@pytest.mark.parametrize("nee", ["POWER", "NEEAT"])
def test_k4_tex_matches_plain_version(gpu, nee):
    """K4's texture variant on the textured, normal-mapped sky city (nee
    slot 2, and slot 3's export with its SF_* rows) over three bounces of
    4096 lanes."""
    host = TP.city_scene(tri_budget=4000, seed=1, blocks=2, textured=True,
                         normal_mapped=True, with_env=True)
    scene = prepare(host, device=gpu)
    tbl = scene.cluster_tables
    assert tbl.tex is not None and tbl.tex_maps == (1, 0, 0, 1)
    cfg = PathTracerConfig(max_bounces=3, nee=NEEMode[nee],
                           stochastic_texture_filtering=True)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    for _ in range(3):
        ha, _ = BC.closest_paged(fs, is_, tbl, 64, 1, 1e27)
        plain = BC.shade_reference(ha, fs, is_, tbl, kcfg, 2)
        before = kernels.launches["cluster_shade_tex_env"]
        kern = BC.shade(ha, fs, is_, tbl, kcfg, 2)
        torch.cuda.synchronize()
        assert kernels.launches["cluster_shade_tex_env"] == before + 1
        assert len(kern) == len(plain) == (5 if nee == "NEEAT" else 4)
        same = (kern[1] == plain[1]).all(0) & (kern[3][5] == plain[3][5])
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        fs, is_ = plain[0], plain[1]


def test_textured_renders_count_their_launches(gpu):
    """A textured render with stochastic filtering runs the texture
    variants (the final environment round stays untextured); without it a
    textured scene renders on the general tier."""
    host = _textured_cornell()
    scene = prepare(host, device=gpu)
    cam = TP.default_camera(host, 32, 32, device=gpu)
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, PathTracerConfig(
        max_bounces=3, stochastic_texture_filtering=True), 32, 32, spp=2)
    assert dict(kernels.launches) == dict(bounce_fused_tex_env=3 * 2,
                                          bounce_fused_final=2)
    assert torch.isfinite(hdr).all() and rays > 0
    kernels.launches.clear()
    hdr, _, _ = render(scene, cam, PathTracerConfig(max_bounces=3), 32, 32,
                       spp=1)
    assert set(kernels.launches) == {"brute_closest"}
    assert torch.isfinite(hdr).all()
    host = TP.city_scene(tri_budget=4000, seed=1, blocks=2, textured=True,
                         normal_mapped=True, with_env=True)
    scene = prepare(host, device=gpu)
    kernels.launches.clear()
    hdr, _, rays = render(scene, TP.default_camera(host, 32, 24, device=gpu),
                          PathTracerConfig(max_bounces=3, cluster_kslots=16,
                                           stochastic_texture_filtering=True),
                          32, 24, spp=2)
    assert dict(kernels.launches) == dict(
        cluster_closest=2 * 4 * 2, cluster_shade_tex_env=3 * 2,
        cluster_shade_final=2, cluster_shadow=2 * 3 * 2)
    assert torch.isfinite(hdr).all() and rays > 0


# ---------------------------------------------------------------------------
# Opacity micromaps: the micromap variants of K1, K2, K3, K4, K5 and K9
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def alpha_scenes(gpu):
    """The curtain Cornell box (fused) and its 40 x 40 grid (clustered)."""
    hosts = dict(curtain=TP.curtain_cornell(True),
                 grid=TP.curtain_cornell(True, grid=40))
    return {k: (h, prepare(h, device=gpu)) for k, h in hosts.items()}


@pytest.mark.parametrize("slot", [2, 5])
def test_k1_omm_matches_plain_version(alpha_scenes, gpu, slot):
    """K1's micromap variant over four iterations of 4096 camera rays on
    the curtain (nee slot 2, and slot 5's export), and K2's micromap
    variant on slot 5's shadow requests."""
    host, scene = alpha_scenes["curtain"]
    tbl = scene.bounce_tables
    assert tbl.omm and tbl.tex is not None
    cfg = PathTracerConfig(max_bounces=3, stochastic_texture_filtering=True,
                           nee_external=slot == 5)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == slot
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    passed = 0
    for b in range(4):
        plain = bf.bounce_reference(fs, is_, tbl, kcfg, 2)
        before = dict(kernels.launches)
        kern = bf.bounce(fs, is_, tbl, kcfg, 2)
        torch.cuda.synchronize()
        assert kernels.launches["bounce_fused_omm_tex"] == \
            before.get("bounce_fused_omm_tex", 0) + 1
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        passed += int(((is_[bf.IS_ACTIVE] > 0) & (plain[1][bf.IS_ACTIVE] > 0)
                       & (plain[1][bf.IS_LBOUNCE] == is_[bf.IS_LBOUNCE]))
                      .sum())
        if slot == 5:
            res = external_nee(scene, cfg, None, plain[3],
                               fs[bf.FS_D:bf.FS_D + 3], plain[2][5] > 0.5,
                               fs[bf.FS_PREVPDF], is_[bf.IS_PREVDELTA] > 0,
                               is_[bf.IS_PX], is_[bf.IS_PY], 2, b,
                               lb=is_[bf.IS_LBOUNCE])
            sh = bf.shadow_requests(
                res["shadow_o"], res["shadow_d"], res["sdist"],
                res["do_nee"], bf.alpha_uniform(
                    cfg, is_[bf.IS_PX], is_[bf.IS_PY], is_[bf.IS_LBOUNCE],
                    2))
            occ_k, tst_k = bf.occlusion(tbl, sh, stats=True)
            occ_p, tst_p = bf.occlusion_reference(tbl, sh, stats=True)
            req = sh[bf.SR_DO] > 0.5
            assert (occ_k == occ_p)[req].float().mean() >= 0.999
            assert torch.equal(tst_k, tst_p)
        fs, is_ = plain[0], plain[1]
    assert passed > 100
    assert kernels.launches["shadow_occlusion_omm"] >= (4 if slot == 5
                                                        else 0)


def test_k3_k4_k5_omm_match_plain_versions(alpha_scenes, gpu):
    """K3, K4 and K5's micromap variants on the 40 x 40 curtain over three
    bounces of 4096 camera rays: the winner with HA_UNK, the alpha test
    and pass-through, the stochastic shadow test."""
    host, scene = alpha_scenes["grid"]
    tbl = scene.cluster_tables
    assert tbl.omm and tbl.tex is not None
    cfg = PathTracerConfig(max_bounces=3, stochastic_texture_filtering=True)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    kslots = tbl.n_clusters
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    unknown = 0
    for _ in range(3):
        od = BC.ray_operand(fs, is_)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, 1e27, tbl, kslots)
        ha_k, vis_k = BC.closest_hit(cand, od, tbl.blocks, kslots, 1e27,
                                     stats=True, micro=tbl.omm_word)
        ha_p, vis_p = BC.closest_hit_reference(cand, od, tbl.blocks, kslots,
                                               1e27, stats=True,
                                               micro=tbl.omm_word)
        torch.cuda.synchronize()
        same = (ha_k[BC.HA_PRIM] == ha_p[BC.HA_PRIM]) \
            & (ha_k[BC.HA_UNK] == ha_p[BC.HA_UNK])
        assert same.float().mean() >= 0.999 and torch.equal(vis_k, vis_p)
        unknown += int((ha_p[BC.HA_UNK] > 0.5).sum())
        plain = BC.shade_reference(ha_p, fs, is_, tbl, kcfg, 2, omm=True)
        kern = BC.shade(ha_p, fs, is_, tbl, kcfg, 2, omm=True)
        torch.cuda.synchronize()
        same = (kern[1] == plain[1]).all(0) & (kern[3][5] == plain[3][5])
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        sh = plain[2]
        do = sh[BC.SH_DO] > 0.5
        cand_s, _ = BC.cull(sh[BC.SH_O:BC.SH_O + 3], sh[BC.SH_D:BC.SH_D + 3],
                            do, torch.where(do, sh[BC.SH_DIST], -3e38), tbl,
                            kslots)
        occ_k, tst_k = BC.occlusion(cand_s, sh, tbl.blocks, kslots,
                                    stats=True, micro=tbl.omm_word,
                                    cover=tbl.omm_cov)
        occ_p, tst_p = BC.occlusion_reference(cand_s, sh, tbl.blocks, kslots,
                                              stats=True, micro=tbl.omm_word,
                                              cover=tbl.omm_cov)
        assert (occ_k == occ_p).float().mean() >= 0.999
        assert torch.equal(tst_k, tst_p)
        fs, is_ = plain[0], plain[1]
    assert unknown > 40


@pytest.mark.parametrize("any_hit", [False, True])
def test_k9_omm_matches_plain_version(alpha_scenes, gpu, any_hit):
    """K9's micromap test on the 40 x 40 curtain's BVH: 8192 seeded rays
    through the curtain."""
    _, scene = alpha_scenes["grid"]
    bvh = scene.bvh
    assert bvh.tri_micro is not None
    g = torch.Generator().manual_seed(5)
    n = 8192
    o = torch.stack([torch.rand(n, generator=g) * 0.9 + 0.05,
                     torch.rand(n, generator=g) * 0.9 + 0.05,
                     torch.full((n,), 0.95)], 1)
    d = torch.stack([torch.rand(n, generator=g) * 0.6 - 0.3,
                     torch.rand(n, generator=g) * 0.6 - 0.3,
                     -torch.ones(n)], 1)
    d = d / d.norm(dim=1, keepdim=True)
    o, d = o.to(gpu), d.to(gpu)
    tmin = torch.zeros(n, device=gpu)
    tmax = torch.full((n,), 10.0, device=gpu)
    before = kernels.launches["bvh_traverse_omm"]
    kern = traverse.walk(bvh, o, d, tmin, tmax, any_hit, stats=True)
    plain = traverse._traverse(bvh, o, d, tmin, tmax, any_hit, stats=True)
    torch.cuda.synchronize()
    assert kernels.launches["bvh_traverse_omm"] == before + 1
    for key in ("prim", "visits", "tests"):
        assert torch.equal(kern[key], plain[key]), key
    same = kern["prim"] == plain["prim"]
    assert torch.allclose(kern["t"][same], plain["t"][same], rtol=TOL,
                          atol=TOL)
    # rays reach the back wall through the cutouts
    back = plain["prim"] >= 0
    assert 0.2 < float(back.float().mean()) <= 1.0


def test_omm_renders_count_their_launches(alpha_scenes, gpu):
    """Alpha-tested renders run the micromap variants, the two
    pass-through iterations included; without stochastic filtering they
    render on the general tier (K8 and its retraces on the curtain)."""
    host, scene = alpha_scenes["curtain"]
    cam = TP.default_camera(host, 32, 32, device=gpu)
    cfg = PathTracerConfig(max_bounces=3, stochastic_texture_filtering=True)
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, cfg, 32, 32, spp=2)
    assert dict(kernels.launches) == dict(bounce_fused_omm_tex=(3 + 2) * 2)
    assert torch.isfinite(hdr).all() and rays > 0
    kernels.launches.clear()
    hdr, _, rays = render(scene, cam, PathTracerConfig(max_bounces=3), 32,
                          32, spp=1)
    assert set(kernels.launches) == {"brute_closest"}
    assert kernels.launches["brute_closest"] >= 4
    assert torch.isfinite(hdr).all()
    host, scene = alpha_scenes["grid"]
    kernels.launches.clear()
    hdr, _, rays = render(scene, TP.default_camera(host, 32, 24, device=gpu),
                          dataclasses.replace(cfg, cluster_pages=1), 32, 24,
                          spp=2)
    assert dict(kernels.launches) == dict(
        cluster_closest_omm=5 * 2, cluster_shade_omm_tex=5 * 2,
        cluster_shadow_omm=5 * 2)
    assert torch.isfinite(hdr).all() and rays > 0


# ---------------------------------------------------------------------------
# Nested priorities: the priority variants of K1 and K4
# ---------------------------------------------------------------------------

def _prio_state(side, device, sample):
    """side x side rays, half from each of procedural.OVERLAP_INSIDE_
    CAMERAS (false exits, false entries), each starting in its medium."""
    from rtxpt_tpu_torch.scene.camera import look_at
    parts = []
    for k, (pos, target, up, fov, medium) in enumerate(
            TP.OVERLAP_INSIDE_CAMERAS):
        cam = look_at(pos, target, up, fov, side, side // 2, device=device)
        px, py = _pixel_grid(side, side // 2, device)
        o, d, spread = camera_rays(cam, PathTracerConfig(), px, py, sample)
        fs, is_ = bf.initial_state(o, d, spread, px, py + k * (side // 2))
        is_[bf.IS_MED0] = medium
        parts.append((fs, is_))
    return tuple(torch.cat([p[i] for p in parts], 1) for i in range(2))


def _false_hits(is_in, is_out, hit):
    return (is_in[bf.IS_ACTIVE] > 0) & (is_out[bf.IS_ACTIVE] > 0) \
        & (is_out[bf.IS_LBOUNCE] == is_in[bf.IS_LBOUNCE]) & hit


@pytest.fixture(scope="module")
def prio_scenes(gpu):
    """The overlap boxes (fused), with their side wall (clustered), and a
    small Bistro in two sizes of string lights (in-kernel NEE with 40
    bulbs, the external route with 150)."""
    hosts = dict(boxes=TP.overlap_boxes([1, 2, 0]),
                 wall=TP.overlap_boxes([1, 2, 0, 0], wall=True),
                 bistro40=TP.bistro_scene(15_000, n_bulbs=40),
                 bistro150=TP.bistro_scene(15_000, n_bulbs=150))
    return {k: (h, prepare(h, device=gpu)) for k, h in hosts.items()}


def test_k1_prio_matches_plain_version(prio_scenes, gpu):
    """K1's priority variant over three iterations of 8192 rays of the two
    cameras (slot 2): the interior list equal on every lane."""
    _, scene = prio_scenes["boxes"]
    tbl = scene.bounce_tables
    assert tbl.prio and not tbl.omm
    kcfg = bf.KernelConfig.from_cfg(PathTracerConfig(max_bounces=3))
    fs, is_ = _prio_state(128, gpu, 2)
    false_hits = 0
    for _ in range(3):
        plain = bf.bounce_reference(fs, is_, tbl, kcfg, 2)
        before = kernels.launches["bounce_fused_prio"]
        kern = bf.bounce(fs, is_, tbl, kcfg, 2)
        torch.cuda.synchronize()
        assert kernels.launches["bounce_fused_prio"] == before + 1
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        assert same.float().mean() >= 0.999
        assert torch.equal(kern[1][bf.IS_MED0:bf.IS_MED1 + 1],
                           plain[1][bf.IS_MED0:bf.IS_MED1 + 1])
        _close_rows(kern, plain)
        false_hits += int(_false_hits(is_, plain[1],
                                      plain[2][1] >= 0).sum())
        fs, is_ = plain[0], plain[1]
    assert false_hits > 0.05 * 3 * 128 * 128


@pytest.mark.parametrize("case", ["wall_slot2", "bistro_slot2",
                                  "bistro_slot5"])
def test_k4_prio_matches_plain_version(prio_scenes, gpu, case):
    """K4's priority variant on K3's hits over three iterations: alone on
    the overlap boxes with their wall, with the texture and micromap
    variants on the small Bistro in slot 2 and in slot 5 (the SF_* export
    rows of the external route)."""
    host, scene = prio_scenes[dict(wall_slot2="wall", bistro_slot2="bistro40",
                                   bistro_slot5="bistro150")[case]]
    tbl = scene.cluster_tables
    bistro = case.startswith("bistro")
    cfg = dispatch.resolve(scene, PathTracerConfig(
        max_bounces=3, stochastic_texture_filtering=bistro), gpu)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == (5 if case.endswith("5") else 2)
    omm = bistro and tbl.omm
    name = "cluster_shade_omm_tex_prio" if bistro else "cluster_shade_prio"
    kslots = min(64, tbl.n_clusters)
    pages = -(-tbl.n_clusters // kslots)
    fs, is_ = (_state(host, cfg, 64, gpu, 2) if bistro
               else _prio_state(64, gpu, 2))
    for _ in range(3):
        ha, _ = BC.closest_paged(fs, is_, tbl, kslots, pages, 1e27, omm=omm)
        plain = BC.shade_reference(ha, fs, is_, tbl, kcfg, 2, omm=omm,
                                   prio=True)
        before = kernels.launches[name]
        kern = BC.shade(ha, fs, is_, tbl, kcfg, 2, omm=omm, prio=True)
        torch.cuda.synchronize()
        assert kernels.launches[name] == before + 1
        same = (kern[1] == plain[1]).all(0) & (kern[3][5] == plain[3][5])
        assert same.float().mean() >= 0.999
        assert torch.equal(kern[1][bf.IS_MED0:bf.IS_MED1 + 1],
                           plain[1][bf.IS_MED0:bf.IS_MED1 + 1])
        _close_rows(kern, plain)
        fs, is_ = plain[0], plain[1]


@pytest.mark.parametrize("route", ["fused", "clustered", "xla"])
def test_overlap_closed_form_on_the_card(prio_scenes, gpu, route):
    """tests/test_nested_priority.py's centre pixel through the kernels:
    the glass wins the overlap, E exp(-SW 0.4 - SG 0.8) at rtol 5e-3."""
    import math
    _, scene = prio_scenes["wall" if route == "clustered" else "boxes"]
    from rtxpt_tpu_torch.scene.camera import look_at
    cam = look_at([-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], 10.0,
                  4, 4, device=gpu)
    cfg = PathTracerConfig(max_bounces=6, nee=NEEMode.OFF,
                           enable_russian_roulette=False,
                           passthrough_extra_iters=3,
                           kernel_tier="xla" if route == "xla" else "auto")
    kernels.launches.clear()
    hdr, _, _ = render(scene, cam, cfg, 4, 4, spp=1)
    want = TP.OVERLAP_E * math.exp(-TP.OVERLAP_SW * 0.4
                                   - TP.OVERLAP_SG * 0.8)
    assert abs(float(hdr[2, 2, 0]) / want - 1.0) < 5e-3
    shade = dict(fused="bounce_fused_prio", clustered="cluster_shade_prio",
                 xla="brute_closest")[route]
    assert kernels.launches[shade] >= 6


def test_prio_renders_count_their_launches(prio_scenes, gpu):
    """Priority renders run the priority variants, the two pass-through
    iterations included: K1 on the boxes; K3 / K5 micromap variants and
    K4 omm_tex_prio on the small Bistro, in slot 5 past 128 lights."""
    host, scene = prio_scenes["boxes"]
    cfg = PathTracerConfig(max_bounces=3)
    kernels.launches.clear()
    hdr, _, rays = render(scene, TP.default_camera(host, 32, 32, device=gpu),
                          cfg, 32, 32, spp=2)
    assert dict(kernels.launches) == dict(bounce_fused_prio=(3 + 2) * 2)
    assert torch.isfinite(hdr).all() and rays > 0
    for name in ("bistro40", "bistro150"):
        host, scene = prio_scenes[name]
        bcfg = PathTracerConfig(max_bounces=3,
                                stochastic_texture_filtering=True)
        pages = dispatch.resolve(scene, bcfg, gpu).cluster_pages
        kernels.launches.clear()
        hdr, _, rays = render(scene, TP.default_camera(host, 32, 24,
                                                       device=gpu),
                              bcfg, 32, 24, spp=2)
        assert dict(kernels.launches) == dict(
            cluster_closest_omm=pages * 5 * 2,
            cluster_shade_omm_tex_prio=5 * 2,
            cluster_shadow_omm=pages * 5 * 2)
        assert torch.isfinite(hdr).all() and float(hdr.mean()) > 1e-3


@pytest.mark.parametrize("case", ["city", "sky", "kslots8"])
def test_per_row_kernels_match_plain_versions(city, sky_city, case):
    """K6 (its plain variant, or on the sky city `_env` and `_final`) and
    K7 against their plain versions over three bounces of 4096 sorted
    camera rays, the state carried by the plain versions: integer rows,
    prim ids, row visits, occlusion and K7's pairs equal, float rows
    within 2e-3 (bit-exact under -fmad=false); kslots 8 saturates the
    lists."""
    host, scene = sky_city if case == "sky" else city
    tbl = scene.cluster_tables
    dev = tbl.device
    kslots = 8 if case == "kslots8" else 46
    cfg = PathTracerConfig(max_bounces=4)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    bounds = BC.scene_bounds(tbl)
    fs, is_ = _state(host, cfg, 64, dev, 1)
    src = torch.arange(fs.shape[1], dtype=torch.int32, device=dev)
    for b in range(3):
        fs, is_, src = BC.sort_wavefront(fs, is_, src, b == 0, bounds)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, cfg.max_ray_travel, tbl,
                          kslots)
        for final in (False, True) if case == "sky" else (False,):
            plain = BC.closest_shade_reference(
                cand, fs, is_, tbl, kcfg, 1, kslots, cfg.max_ray_travel,
                final_env=final, stats=True)
            kern = BC.closest_shade(cand, fs, is_, tbl, kcfg, 1, kslots,
                                    cfg.max_ray_travel, final_env=final,
                                    stats=True)
            assert torch.equal(kern[1], plain[1]), (b, final)
            assert torch.equal(kern[3][1], plain[3][1]), (b, final)
            assert torch.equal(kern[4], plain[4]), (b, final)
            for k, p in zip(kern[:4], plain[:4]):
                ok = torch.isclose(k.float(), p.float(), rtol=TOL, atol=TOL,
                                   equal_nan=True)
                assert ok.float().mean(1).min() >= 0.999, (b, final)
            if not final:
                out = plain
        shp, _ = BC.sort_shadows(out[2], bounds)
        dop = shp[BC.SH_DO] > 0.5
        cand_s, _ = BC.cull(shp[BC.SH_O:BC.SH_O + 3],
                            shp[BC.SH_D:BC.SH_D + 3], dop, shp[BC.SH_DIST],
                            tbl, kslots)
        occ_p, tst_p = BC.occlusion_rows_reference(cand_s, shp, tbl.blocks,
                                                   kslots, stats=True)
        occ_k, tst_k = BC.occlusion_rows(cand_s, shp, tbl.blocks, kslots,
                                         stats=True)
        assert torch.equal(occ_k, occ_p) and torch.equal(tst_k, tst_p), b
        fs, is_ = out[0], out[1]


def test_per_row_render_runs_through_k6_k7(city, sky_city, monkeypatch):
    """On the per-row route every bounce launches K6 and K7 once (one
    page), plus K6's final round with an environment, and the image
    equals the flat route's at one page on this small city."""
    monkeypatch.setattr(BC, "FLAT", False)
    for (host, scene), env in ((city, False), (sky_city, True)):
        cam = TP.default_camera(host, 32, 24)
        cfg = PathTracerConfig(max_bounces=3, cluster_pages=1)
        kernels.launches.clear()
        hdr, _, rays = render(scene, cam, cfg, 32, 24, spp=2)
        want = {("cluster_rows_closest_shade_env" if env else
                 "cluster_rows_closest_shade"): 3 * 2,
                "cluster_rows_shadow": 3 * 2}
        if env:
            want["cluster_rows_closest_shade_final"] = 2
        assert dict(kernels.launches) == want
        assert torch.isfinite(hdr).all() and rays > 0
        monkeypatch.setattr(BC, "FLAT", True)
        flat, _, rays_flat = render(scene, cam, cfg, 32, 24, spp=2)
        monkeypatch.setattr(BC, "FLAT", False)
        assert torch.equal(hdr, flat) and rays == rays_flat


# ---------------------------------------------------------------------------
# The split-channel variants of K1 and K4, and the split + aux renders
# ---------------------------------------------------------------------------

SWITCHES = [(t, o, p, s) for t in (False, True) for o in (False, True)
            for p in (False, True) for s in (False, True)]


def _switch_id(sw):
    return "_".join(n if on else "no" + n
                    for n, on in zip(("tex", "omm", "prio", "split"), sw))


def _with_switches(tables, omm, prio):
    """The tables with the micromap and priority switches set: every
    instantiation runs on one scene."""
    return dataclasses.replace(tables, omm=omm and tables.omm, prio=prio)


@pytest.fixture(scope="module")
def curtain_scenes(gpu):
    """procedural.overlap_curtain, fused and (with the wall) clustered:
    the priority instantiations' scenes, whose inside cameras' rays meet
    priority false hits beside the alpha-tested curtain."""
    return {wall: prepare(TP.overlap_curtain([1, 2, 0, 0][:4 if wall else 3],
                                             wall), device=gpu)
            for wall in (False, True)}


def _off_curtain_false_hits(fs, is_in, is_out, t, hit):
    """Priority false hits: lanes that passed through a hit that does not
    lie in the curtain's plane."""
    y = fs[bf.FS_O + 1] + t * fs[bf.FS_D + 1]
    return _false_hits(is_in, is_out, hit) \
        & ((y - TP.OVERLAP_CURTAIN_Y).abs() >= 1e-3)


def _switch_state(prio, gpu, cfg, host):
    """4096 rays: the overlap curtain's inside cameras' with the priority
    switch, else the camera's of `host`."""
    return _prio_state(64, gpu, 2) if prio else _state(host, cfg, 64, gpu, 2)


@pytest.mark.parametrize("sw", SWITCHES, ids=_switch_id)
def test_k1_instantiations_match_plain_version(alpha_scenes, curtain_scenes,
                                               gpu, sw):
    """Each of K1's sixteen instantiations (tex, omm, prio, split) over
    three bounces of 4096 camera rays, the split rows carried: on the
    curtain Cornell box, and with the priority switch on the overlap
    curtain, where at bounces 0 and 2 at least 5% of the active lanes are
    priority false hits: the integer rows and the first-scatter flag
    equal, the float rows within 2e-3, each on >= 99.9% of the lanes."""
    tex, omm, prio, split = sw
    host, scene = alpha_scenes["curtain"]
    if prio:
        scene = curtain_scenes[False]
    tables = _with_switches(scene.bounce_tables, omm, prio)
    cfg = PathTracerConfig(max_bounces=3, stochastic_texture_filtering=tex)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert bf.use_tex(tables, kcfg) == tex
    fs, is_ = _switch_state(prio, gpu, cfg, host)
    fs2 = torch.zeros((bf.NF2, fs.shape[1]), device=gpu) if split else None
    name = bf.variant_name("bounce_fused", False, False, tex, omm, prio,
                           split)
    kernels.launches.clear()
    for b in range(3):
        plain = bf.bounce_reference(fs, is_, tables, kcfg, 2, fs2=fs2)
        kern = bf.bounce(fs, is_, tables, kcfg, 2, fs2=fs2)
        torch.cuda.synchronize()
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        if split:
            same &= kern[-1][bf.F2_FSPEC] == plain[-1][bf.F2_FSPEC]
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        if prio and b != 1:
            fh = _off_curtain_false_hits(fs, is_, plain[1], plain[2][0],
                                         plain[2][1] >= 0)
            assert fh.sum() >= 0.05 * (is_[bf.IS_ACTIVE] > 0).sum()
        fs, is_ = plain[0], plain[1]
        fs2 = plain[-1] if split else None
    assert dict(kernels.launches) == {name: 3}


@pytest.mark.parametrize("sw", SWITCHES, ids=_switch_id)
def test_k4_instantiations_match_plain_version(alpha_scenes, curtain_scenes,
                                               gpu, sw):
    """Each of K4's sixteen instantiations on K3's hits over three bounces
    of 4096 camera rays, the split rows carried (SH_CDIFF included in the
    shadow rows): on the 40 x 40 curtain, and with the priority switch on
    the overlap curtain with its wall, at least 5% of the active lanes
    priority false hits at bounces 0 and 2."""
    tex, omm, prio, split = sw
    host, scene = alpha_scenes["grid"]
    if prio:
        scene = curtain_scenes[True]
    tbl = scene.cluster_tables
    assert tbl.omm
    cfg = PathTracerConfig(max_bounces=3, stochastic_texture_filtering=tex)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    kslots = tbl.n_clusters
    fs, is_ = _switch_state(prio, gpu, cfg, host)
    fs2 = torch.zeros((bf.NF2, fs.shape[1]), device=gpu) if split else None
    kernels.launches.clear()
    for b in range(3):
        od = BC.ray_operand(fs, is_)
        cand, _ = BC.cull(fs[bf.FS_O:bf.FS_O + 3], fs[bf.FS_D:bf.FS_D + 3],
                          is_[bf.IS_ACTIVE] > 0, 1e27, tbl, kslots)
        ha = BC.closest_hit_reference(cand, od, tbl.blocks, kslots, 1e27,
                                      micro=tbl.omm_word if omm else None)
        plain = BC.shade_reference(ha, fs, is_, tbl, kcfg, 2, omm=omm,
                                   prio=prio, fs2=fs2)
        kern = BC.shade(ha, fs, is_, tbl, kcfg, 2, omm=omm, prio=prio,
                        fs2=fs2)
        torch.cuda.synchronize()
        same = (kern[1] == plain[1]).all(0) & (kern[3][5] == plain[3][5])
        if split:
            same &= kern[-1][bf.F2_FSPEC] == plain[-1][bf.F2_FSPEC]
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        if prio and b != 1:
            fh = _off_curtain_false_hits(fs, is_, plain[1], ha[BC.HA_T],
                                         ha[BC.HA_PRIM] >= 0)
            assert fh.sum() >= 0.05 * (is_[bf.IS_ACTIVE] > 0).sum()
        fs, is_ = plain[0], plain[1]
        fs2 = plain[-1] if split else None
    name = bf.variant_name("cluster_shade", False, False, tex, omm, prio,
                           split)
    assert dict(kernels.launches) == {name: 3}


@pytest.mark.parametrize("slot", [3, 5])
def test_k4_split_export_matches_plain_version(gpu, slot):
    """K4's split variant in the export slots (3: NEE-AT, 5: power NEE on
    the external route) on K3's hits over three bounces of 4096 camera
    rays of four closed rooms (rooms_scene(4, subdiv=8), the clustered
    tier), the split rows carried: the state, SH, hit, SF_* and fs2 rows
    against the plain version's."""
    host = TP.rooms_scene(4, subdiv=8)
    scene = prepare(host, device=gpu)
    tbl = scene.cluster_tables
    assert tbl is not None and scene.bounce_tables is None
    cfg = PathTracerConfig(max_bounces=3, split_channels=True,
                           nee=NEEMode.NEEAT if slot == 3 else NEEMode.POWER,
                           nee_external=slot == 5)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    assert kcfg.nee_mode == slot
    fs, is_ = _state(host, cfg, 64, gpu, 2)
    fs2 = torch.zeros((bf.NF2, fs.shape[1]), device=gpu)
    kernels.launches.clear()
    for _ in range(3):
        ha, _ = BC.closest_paged(fs, is_, tbl, 64, 1, 1e27)
        plain = BC.shade_reference(ha, fs, is_, tbl, kcfg, 2, fs2=fs2)
        kern = BC.shade(ha, fs, is_, tbl, kcfg, 2, fs2=fs2)
        torch.cuda.synchronize()
        assert len(kern) == len(plain) == 6          # SF_* rows and fs2
        same = (kern[1] == plain[1]).all(0) & (kern[3][5] == plain[3][5]) \
            & (kern[-1][bf.F2_FSPEC] == plain[-1][bf.F2_FSPEC])
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        assert (plain[3][5] > 0.5).float().mean() > 0.1
        fs, is_, fs2 = plain[0], plain[1], plain[-1]
    assert dict(kernels.launches) == {"cluster_closest": 3,
                                      "cluster_shade_split": 3}


SPLIT_RENDERS = {
    # tier: (scene, config fields, the split kernels it launches per frame)
    "fused": ("cornell", {}, {"bounce_fused_split": 3}),
    "fused_external": ("rooms", dict(nee_candidates=2),
                       {"bounce_fused_split": 3, "shadow_occlusion": 3}),
    "clustered": ("city", {}, {"cluster_shade_split": 3}),
    "fused_sky": ("sky_cornell", {}, {"bounce_fused_split_env": 3,
                                      "bounce_fused_final_split": 1}),
    "clustered_sky": ("sky_city", {}, {"cluster_shade_split_env": 3,
                                       "cluster_shade_final_split": 1}),
    "xla": ("cornell", dict(kernel_tier="xla"), {}),
}


def _sky_cornell():
    host = TP.cornell_box()
    host.envmap_image = make_sky(64, 32)
    return host


@pytest.mark.parametrize("tier", list(SPLIT_RENDERS))
def test_split_aux_renders_match_cpu(gpu, city, sky_city, tier):
    """A 32x24 frame with split_channels and want_aux through the kernels
    against the same frame through the plain versions on the CPU: every
    per-pixel key within 2e-3 on >= 99% of the pixels, the partition
    |L - emission - L_diff - L_spec| < 2e-2, and the split variants'
    launches (with an environment, the final round's too)."""
    which, cfg_kw, launches = SPLIT_RENDERS[tier]
    host = dict(cornell=TP.cornell_box, rooms=lambda: TP.rooms_scene(4),
                city=lambda: city[0], sky_cornell=_sky_cornell,
                sky_city=lambda: sky_city[0])[which]()
    cfg = PathTracerConfig(max_bounces=3, split_channels=True, **cfg_kw)
    cam = TP.default_camera(host, 32, 24)
    outs = {}
    for dev in (gpu, torch.device("cpu")):
        gpu_scenes = dict(city=city[1], sky_city=sky_city[1])
        scene = gpu_scenes[which] if which in gpu_scenes and dev == gpu \
            else prepare(host, device=dev)
        kernels.launches.clear()
        outs[dev.type] = render_sample(scene, cam, cfg, 32, 24, 1,
                                       want_aux=True)
        if dev == gpu:
            torch.cuda.synchronize()
            counted = {k: v for k, v in kernels.launches.items()
                       if "split" in k or k in launches}
            assert counted == launches
    got, want = outs["cuda"], outs["cpu"]
    for key in ("L", "L_diff", "L_spec", "albedo", "albedo_diff",
                "albedo_spec", "normal", "depth", "wpos", "emission"):
        ok = torch.isclose(got[key].cpu(), want[key], rtol=TOL, atol=TOL)
        ok = ok.reshape(ok.shape[0], ok.shape[1], -1).all(-1)
        assert ok.float().mean() >= 0.99, key
    resid = (got["L"] - got["emission"] - got["L_diff"] - got["L_spec"])
    assert resid.abs().max() < 2e-2


@pytest.mark.parametrize("sw", SWITCHES, ids=_switch_id)
def test_k1_restart_instantiations_match_plain_version(
        alpha_scenes, curtain_scenes, gpu, sw):
    """Each of K1's sixteen restart instantiations (the real-time fill:
    first_direct=False, the V-buffer rows injected at bounce 0) over three
    bounces of 4096 camera rays, the injected rows the plain version's own
    bounce-0 hits: as test_k1_instantiations_match_plain_version, and the
    launches counted as the inject and no-direct variants."""
    tex, omm, prio, split = sw
    host, scene = alpha_scenes["curtain"]
    if prio:
        scene = curtain_scenes[False]
    tables = _with_switches(scene.bounce_tables, omm, prio)
    cfg = PathTracerConfig(max_bounces=3, stochastic_texture_filtering=tex)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    fs, is_ = _switch_state(prio, gpu, cfg, host)
    fs2 = torch.zeros((bf.NF2, fs.shape[1]), device=gpu) if split else None
    inj = bf.bounce_reference(fs, is_, tables, kcfg, 2,
                              fs2=fs2)[2][:bf.NINJ].contiguous()
    assert (inj[bf.INJ_PRIM] >= 0).float().mean() > 0.5
    kernels.launches.clear()
    for b in range(3):
        kw = dict(fs2=fs2, inj=inj if b == 0 else None, first_direct=False)
        plain = bf.bounce_reference(fs, is_, tables, kcfg, 2, **kw)
        kern = bf.bounce(fs, is_, tables, kcfg, 2, **kw)
        torch.cuda.synchronize()
        same = (kern[1] == plain[1]).all(0) & (kern[2][1] == plain[2][1])
        if split:
            same &= kern[-1][bf.F2_FSPEC] == plain[-1][bf.F2_FSPEC]
        assert same.float().mean() >= 0.999
        _close_rows(kern, plain)
        if b == 0:
            assert torch.equal(plain[2][1], inj[bf.INJ_PRIM])
            assert plain[2][5].max() == 0.0          # no first-vertex NEE
        fs, is_ = plain[0], plain[1]
        fs2 = plain[-1] if split else None
    names = [bf.variant_name("bounce_fused", False, False, tex, omm, prio,
                             split, r) for r in ("_inj", "_nodirect")]
    assert dict(kernels.launches) == {names[0]: 1, names[1]: 2}


@pytest.fixture(scope="module")
def glass(gpu):
    host = TP.glass_mirror_cornell()
    return host, prepare(host, device=gpu)


@pytest.mark.parametrize("first_direct", [True, False])
def test_k1_inject_on_stable_planes(glass, gpu, first_direct):
    """K1's inject variant on the V-buffers of the glass-over-mirror box's
    three stable planes (64 x 64 rays), with their budgets: bit-exact with
    the plain version on >= 99.9% of the lanes, every plane non-empty."""
    from rtxpt_tpu_torch.pt.stable_planes import decompose
    host, scene = glass
    cfg = PathTracerConfig(max_bounces=4)
    kcfg = bf.KernelConfig.from_cfg(cfg)
    cam = TP.default_camera(host, 64, 64, device=gpu)
    px, py = _pixel_grid(64, 64, gpu)
    o, d, spread = camera_rays(cam, cfg, px, py, 1)
    planes, _ = decompose(scene, o, d)
    for plane in planes:
        assert plane.valid.any()
        fs, is_ = bf.initial_state(plane.o, plane.d, spread, px, py)
        is_[bf.IS_BUDGET] = torch.where(plane.valid, torch.clamp(
            4 - plane.nverts, min=0), 0).to(torch.int32)
        inj = bf.pack_injection(plane.vbuffer(cfg.max_ray_travel))
        kw = dict(inj=inj, first_direct=first_direct)
        plain = bf.bounce_reference(fs, is_, scene.bounce_tables, kcfg, 1,
                                    **kw)
        kern = bf.bounce(fs, is_, scene.bounce_tables, kcfg, 1, **kw)
        torch.cuda.synchronize()
        same = None
        for k, p in zip(kern, plain):
            eq = ((k == p) | (torch.isnan(k) & torch.isnan(p))).all(0)
            same = eq if same is None else same & eq
        assert same.float().mean() >= 0.999


@pytest.mark.parametrize("planes", [False, True])
def test_realtime_frames_match_cpu(glass, gpu, planes):
    """Two 32x24 real-time frames (RELAX, TAA, bloom; stable planes or not)
    through the kernels against the same frames through the plain versions
    on the CPU: hdr within 2e-3 on >= 99% of the pixels; the stable-planes
    frame launches K1's inject variant once per plane."""
    from rtxpt_tpu_torch.config import DenoiserMode, RenderConfig
    from rtxpt_tpu_torch.pt import realtime
    host = glass[0]
    cfg = PathTracerConfig(max_bounces=3)
    rc = RenderConfig(width=32, height=24, denoiser=DenoiserMode.RELAX,
                      enable_taa=True, enable_bloom=True)
    fn = realtime.render_frame_stable_planes if planes \
        else realtime.render_frame
    cam = TP.default_camera(host, 32, 24)
    hdrs = {}
    for dev in (gpu, torch.device("cpu")):
        scene = glass[1] if dev == gpu else prepare(host, device=dev)
        state = realtime.init_state(24, 32, scene, cfg)
        kernels.launches.clear()
        for _ in range(2):
            _, hdr, state = fn(scene, cam, cfg, rc, state)
        if dev == gpu:
            torch.cuda.synchronize()
            n_inj = kernels.launches.get("bounce_fused_inj", 0)
            assert n_inj == (6 if planes else 0)
            assert kernels.launches.get("bounce_fused", 0) > 0
        hdrs[dev.type] = hdr.cpu()
    ok = torch.isclose(hdrs["cuda"], hdrs["cpu"], rtol=TOL, atol=TOL)
    assert ok.all(-1).float().mean() >= 0.99

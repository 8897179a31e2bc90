"""The clustered tier's per-row route (K6 closest hit and shading in one
kernel, K7 per-row shadow any-hit) against the JAX package, on the CPU.

The route runs with bounce_clustered.FLAT set to False in the port and
with `_FLAT` (and `_SCAN`, the unrolled bounce chain) monkeypatched to
False in the JAX package, for this module only. Everything runs on the
small city of tests/test_torch_cluster.py (city_scene(4000, seed=1,
blocks=2): 3,512 triangles, 46 clusters) at 48x32 (two 1024-lane groups
after padding), 3 bounces, sample 1:

  * the port's per-row render_sample against the JAX per-row render at
    kslots 64: >= 99% of pixels within 2e-3, mean within 1e-3 relative,
    ray counts, occupancy and cull overflow equal;
  * K6's and K7's plain versions against the JAX render's own
    `_kernel_a_call` and `_kernel_b_call` launches at bounces 0 and 2,
    which a recorder captures on the way through (the same inputs, so no
    extra JAX compile): K6's state, shadow and hit rows, K7's raw
    occlusion (1 on lanes without a request) on every lane;
  * the port's per-row render against its flat route at cluster_pages=1,
    equal on every pixel with equal counts: at kslots 64, at kslots 8
    (saturated lists) and on the sky city (K6's environment and final
    round). The JAX package's two routes agree bit for bit on these;
  * the dispatch's refusals on the per-row route.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.config import PathTracerConfig as JConfig
from rtxpt_tpu.prepare import prepare as j_prepare
from rtxpt_tpu.pt import bounce_clustered as JBC
from rtxpt_tpu.pt import integrator as jint
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.config import PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import render_sample
from rtxpt_tpu_torch.scene import procedural as TP

TOL = 2e-3
SAMPLE = 1
W_IMG, H_IMG = 48, 32
BOUNCES = 3
KSLOTS = 46              # the default 64 clamps to the small city's clusters


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_cluster.py: the test run
    puts several processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _city(mod, with_env=False):
    return mod.city_scene(tri_budget=4000, seed=1, blocks=2,
                          with_env=with_env)


@pytest.fixture(scope="module")
def city():
    th = _city(TP)
    return th, prepare(th, device="cpu")


def _np(x):
    return np.asarray(x).reshape(x.shape[0], -1)


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX per-row render of the small city (kslots 64, interpret
    mode) and its K6 / K7 launches in order, inputs and outputs as numpy
    [rows, N] arrays."""
    jh = _city(JP)
    js = j_prepare(jh)
    calls = dict(k6=[], k7=[])
    k6, k7 = JBC._kernel_a_call, JBC._kernel_b_call

    def record_k6(*args, **kw):
        out = k6(*args, **kw)
        scal, cand, fs, is_ = (np.asarray(x) for x in args[:4])
        calls["k6"].append(dict(bounce=int(scal[0, 1]), cand=cand,
                                fs=_np(fs), is_=_np(is_), kw=kw,
                                out=[_np(x) for x in out]))
        return out

    def record_k7(cand, sh, blocks, kslots, **kw):
        occ = k7(cand, sh, blocks, kslots, **kw)
        calls["k7"].append(dict(cand=np.asarray(cand), sh=_np(sh),
                                occ=np.asarray(occ).reshape(-1)))
        return occ

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBC, "_FLAT", False)
        mp.setattr(JBC, "_SCAN", False)
        mp.setattr(JBC, "_kernel_a_call", record_k6)
        mp.setattr(JBC, "_kernel_b_call", record_k7)
        ref = jint.render_sample(
            js, JP.default_camera(jh, W_IMG, H_IMG),
            JConfig(max_bounces=BOUNCES, kernel_tier="clustered",
                    pallas_interpret=True, cluster_kslots=64),
            W_IMG, H_IMG, jnp.uint32(SAMPLE))
    assert [c["bounce"] for c in calls["k6"]] == list(range(BOUNCES))
    assert len(calls["k7"]) == BOUNCES
    return ref, calls


@pytest.fixture(scope="module")
def port_rows(city):
    """The port's per-row render of the small city at kslots 64."""
    th, ts = city
    mp = pytest.MonkeyPatch()
    mp.setattr(BC, "FLAT", False)
    try:
        kernels.launches.clear()
        out = render_sample(ts, TP.default_camera(th, W_IMG, H_IMG),
                            PathTracerConfig(max_bounces=BOUNCES), W_IMG,
                            H_IMG, SAMPLE)
    finally:
        mp.undo()
    assert out["kernel_tier"] == "clustered"
    assert not kernels.launches          # CPU tensors: no kernel launched
    return out


def test_render_sample_matches_jax_per_row_route(jax_rows, port_rows):
    ref, _ = jax_rows
    out = port_rows
    a, b = np.asarray(ref["L"]), out["L"].numpy()
    close = np.isclose(b, a, rtol=TOL, atol=TOL).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(b.mean() - a.mean()) <= 1e-3 * abs(a.mean())
    assert int(out["ray_count"]) == int(ref["ray_count"])
    np.testing.assert_array_equal(out["occupancy"].numpy(),
                                  np.asarray(ref["occupancy"]))
    assert int(out["cull_overflow"]) == int(ref["cull_overflow"]) == 0


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("bounce", [0, 2])
def test_k6_plain_matches_pallas_kernel(city, jax_rows, bounce):
    """K6's plain version on the inputs of the JAX render's K6 launch at
    this bounce: every integer row, prim id and request flag equal on
    every active lane (the route is exact on this scene), the float rows
    within 2e-3 on every lane, and visits only to listed slots."""
    c = jax_rows[1]["k6"][bounce]
    tables = city[1].cluster_tables
    kcfg = bf.KernelConfig.from_cfg(PathTracerConfig(max_bounces=BOUNCES))
    out = BC.closest_shade(_t(c["cand"]), _t(c["fs"]), _t(c["is_"]), tables,
                           kcfg, SAMPLE, KSLOTS, 1.0e27, stats=True)
    tfs, tis, tsh, thit, visited = (x.numpy() for x in out)
    jfs, jis, jsh, jhit = c["out"]
    active = c["is_"][bf.IS_ACTIVE] > 0
    same = (tis == jis).all(0) & (thit[1] == jhit[1]) \
        & (tsh[BC.SH_DO] == jsh[BC.SH_DO])
    assert same[active].all(), (~same[active]).sum()
    assert same.all(), (~same).sum()
    for name, a, b in (("fs", tfs, jfs), ("sh", tsh, jsh),
                       ("hit", thit, jhit)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)
    # the render's camera sees mostly sky: at bounce 2, 44 lanes are
    # active, 26 hit and 8 request a shadow ray
    assert (jhit[1] >= 0).sum() >= 20                 # lanes hit
    assert jsh[BC.SH_DO].sum() >= 5                   # NEE requests made
    count = np.repeat(c["cand"][:, 0, 0], BC.R)
    listed = np.arange(KSLOTS)[None] < count[:, None]
    assert visited.shape == (count.size, KSLOTS)
    assert not (visited & ~listed).any() and visited.any()


@pytest.mark.parametrize("bounce", [0, 2])
def test_k7_plain_matches_pallas_kernel(city, jax_rows, bounce):
    """K7's plain version on the inputs of the JAX render's K7 launch at
    this bounce: the raw output (1 on lanes without a request) equal on
    every lane that requests a shadow ray, and on every other lane."""
    c = jax_rows[1]["k7"][bounce]
    tables = city[1].cluster_tables
    occ, tests = BC.occlusion_rows(_t(c["cand"]), _t(c["sh"]),
                                   tables.blocks, KSLOTS, stats=True)
    same = occ.numpy() == c["occ"]
    do = c["sh"][BC.SH_DO] > 0.5
    assert same[do].all(), (~same[do]).sum()
    assert same.all(), (~same).sum()
    assert (c["occ"][~do] == 1.0).all() and (~do).any()
    assert 0.0 < c["occ"][do].mean() < 1.0          # both outcomes occur
    do_g = do.reshape(-1, BC.FL).sum(1)
    assert (tests.numpy() <= do_g * c["cand"][:, 0, 0] * BC.CT).all()


@pytest.mark.parametrize("case", ["kslots64", "kslots8", "sky"])
def test_per_row_route_equals_flat_route_with_one_page(city, port_rows,
                                                       case):
    """The port's two routes agree on every pixel at cluster_pages=1, with
    the same ray counts, occupancy and cull overflow: K6's per-row gates
    only skip work that cannot change a lane. kslots 8 saturates the
    lists (overflow > 0); the sky city runs K6's environment variant and
    its final round."""
    th, ts = city
    kslots = 8 if case == "kslots8" else 64
    if case == "sky":
        th = _city(TP, with_env=True)
        ts = prepare(th, device="cpu")
    cam = TP.default_camera(th, W_IMG, H_IMG)
    cfg = PathTracerConfig(max_bounces=BOUNCES, cluster_kslots=kslots,
                           cluster_pages=1)
    flat = render_sample(ts, cam, cfg, W_IMG, H_IMG, SAMPLE)
    if case == "kslots64":
        rows = port_rows
    else:
        mp = pytest.MonkeyPatch()
        mp.setattr(BC, "FLAT", False)
        try:
            rows = render_sample(ts, cam, cfg, W_IMG, H_IMG, SAMPLE)
        finally:
            mp.undo()
    assert torch.equal(rows["L"], flat["L"])
    assert float(flat["L"].mean()) > 0.0
    for key in ("ray_count", "occupancy", "cull_overflow"):
        assert torch.equal(rows[key], flat[key]), key
    assert (int(flat["cull_overflow"]) > 0) == (case == "kslots8")


@pytest.mark.parametrize("case", ["micromaps", "priorities", "instanced",
                                  "external"])
def test_per_row_route_refuses_what_only_the_flat_route_serves(city, case,
                                                               monkeypatch):
    """On the per-row route "auto" takes the general tier for micromaps,
    nested priorities and instanced cluster tables (the JAX package's
    clustered_structural_ok with _FLAT false), a pinned clustered tier
    refuses them by name, and external NEE is refused by name (where the
    JAX package takes its clustered tier and fails an assert)."""
    monkeypatch.setattr(BC, "FLAT", False)
    scene = city[1]
    cfg = PathTracerConfig()
    if case == "micromaps":
        scene = scene.replace(tri_opacity=object())
    elif case == "priorities":
        scene = scene.replace(has_nested_priorities=True)
    elif case == "instanced":
        scene = scene.replace(cluster_tables=dataclasses.replace(
            scene.cluster_tables, instanced=True))
    else:
        cfg = PathTracerConfig(nee_candidates=4)
    if case == "external":
        with pytest.raises(NotImplementedError, match="external NEE"):
            dispatch.resolve(scene, cfg, "cpu")
    else:
        assert dispatch.resolve(scene, cfg, "cpu").kernel_tier == "xla"
        name = dict(micromaps="opacity micromaps",
                    priorities="nested priorities",
                    instanced="instanced cluster tables")[case]
        with pytest.raises(NotImplementedError,
                           match=f"{name} on the per-row route"):
            dispatch.resolve(scene, dataclasses.replace(
                cfg, kernel_tier="clustered"), "cpu")
    # the flat route serves these two on this scene and config
    monkeypatch.setattr(BC, "FLAT", True)
    if case in ("priorities", "external"):
        assert dispatch.resolve(scene, cfg, "cpu").kernel_tier == "clustered"


def test_per_row_wrappers_refuse_other_and_mixed_devices(city):
    tables = city[1].cluster_tables
    kcfg = bf.KernelConfig()
    cand = torch.zeros((1, 1, 1 + (2 + BC.R) * 4), dtype=torch.int32)
    fs = torch.zeros((bf.NF, BC.FL), device="meta")
    is_ = torch.zeros((bf.NI, BC.FL), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        BC.closest_shade(cand, fs, is_, tables, kcfg, SAMPLE, 4, 1e27)
    with pytest.raises(ValueError, match="same device"):
        BC.occlusion_rows(cand.to("meta"), torch.zeros((BC.SH_ROWS, BC.FL)),
                          tables.blocks, 4)
    with pytest.raises(ValueError, match="kernel NEE modes"):
        BC.closest_shade(cand, torch.zeros((bf.NF, BC.FL)),
                         torch.zeros((bf.NI, BC.FL), dtype=torch.int32),
                         tables, dataclasses.replace(kcfg, nee_mode=5),
                         SAMPLE, 4, 1e27)

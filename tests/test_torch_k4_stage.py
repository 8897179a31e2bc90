"""K4's staging plan (csrc/cluster_shade.cuh StagePlan) on the CPU.

K4 copies each block's input rows into shared memory with bulk
asynchronous copies and shades from there: the HA rows its variant reads,
the state rows and the split rows, one 512-byte slot each, in the order of
bounce_clustered.shade_stage_rows. These tests hold the plan's row lists
and byte counts to the kernel's constants, its two stages to the card's
shared memory, and the plan to what the shading reads: the plain version
(shade_reference, the kernel's arithmetic) gives the same outputs, bit for
bit, when every row a launch does not copy holds NaN. The small city of
tests/test_torch_cluster.py, with its sky and textures; no JAX."""

import dataclasses
import functools
import re
from pathlib import Path

import pytest
import torch

from rtxpt_tpu_torch.config import NEEMode, PathTracerConfig
from rtxpt_tpu_torch.prepare import prepare
from rtxpt_tpu_torch.pt import bounce_clustered as BC
from rtxpt_tpu_torch.pt import bounce_fused as bf
from rtxpt_tpu_torch.pt import dispatch
from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
from rtxpt_tpu_torch.scene import procedural as TP

SRC = (Path(BC.__file__).resolve().parents[1] / "csrc"
       / "cluster_shade.cuh").read_text()
SMEM_PER_BLOCK = 232_448      # the most a block may ask for on the H100
VARIANTS = [(t, o, s) for t in (False, True) for o in (False, True)
            for s in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _array(name):
    """The entries of `constexpr int name[...] = {...};` in cluster_shade.cuh,
    evaluated with the Python row constants."""
    body = re.search(name + r"\[[^\]]*\] = \{([^}]*)\};", SRC).group(1)
    env = {k: getattr(BC, k) for k in dir(BC) if k.startswith("HA_")}
    env.update({k: getattr(bf, k) for k in dir(bf) if k.startswith("AT_")})
    return tuple(eval(x.strip(), {}, env)   # noqa: S307
                 for x in body.split(","))


def test_plan_rows_match_the_kernel():
    assert _array("kHaBase") == BC.SHADE_HA_BASE
    assert _array("kHaTex") == BC.SHADE_HA_TEX
    assert f"kStageLanes = {BC.SHADE_STAGE_LANES};" in SRC
    assert f"kHaBaseN = {len(BC.SHADE_HA_BASE)}, kHaTexN = " \
           f"{len(BC.SHADE_HA_TEX)};" in SRC
    # the hit rows come first (final_env copies only them), AT_LID last
    assert BC.SHADE_HA_BASE[:5] == (BC.HA_T, BC.HA_U, BC.HA_V, BC.HA_FRONT,
                                    BC.HA_PRIM)
    assert "kHaHit = 5;" in SRC
    assert BC.SHADE_HA_BASE[-1] == BC.HA_ATTR + bf.AT_LID
    assert BC.HA_INST not in BC.SHADE_HA_BASE + BC.SHADE_HA_TEX


@pytest.mark.parametrize("tex,omm,split", VARIANTS)
def test_plan_bytes_and_stages_fit(tex, omm, split):
    rows, nbytes = BC.shade_stage_rows(tex, omm, split)
    ha = (len(BC.SHADE_HA_BASE) + len(BC.SHADE_HA_TEX) * tex + omm)
    assert len(rows) == ha + bf.NF + bf.NI + bf.NF2 * split
    assert nbytes == len(rows) * 128 * 4
    assert len(set(rows)) == len(rows)
    assert [r for a, r in rows if a == "fs"] == list(range(bf.NF))
    assert [r for a, r in rows if a == "is"] == list(range(bf.NI))
    # two stages and the two mbarriers in one block's shared memory
    assert 2 * nbytes + 16 <= SMEM_PER_BLOCK


@functools.lru_cache(maxsize=None)
def city(textured):
    """(tables, kcfg, ha, fs, is_) of 32 x 32 camera rays of the small sky
    city (textured: with stochastic texture filtering) at bounce 0."""
    host = TP.city_scene(tri_budget=4000, seed=1, blocks=2, with_env=True,
                         textured=textured)
    scene = prepare(host, device="cpu")
    tbl = scene.cluster_tables
    cfg = dispatch.resolve(scene, PathTracerConfig(
        max_bounces=3, nee=NEEMode.POWER,
        stochastic_texture_filtering=textured), "cpu")
    cam = TP.default_camera(host, 32, 32, device="cpu")
    px, py = _pixel_grid(32, 32, "cpu")
    o, d, spread = camera_rays(cam, cfg, px, py, 1)
    fs, is_ = bf.initial_state(o, d, spread, px, py)
    ha, _ = BC.closest_paged(fs, is_, tbl, cfg.cluster_kslots,
                             cfg.cluster_pages, 1e27)
    ha = BC.post_attr_inst(ha, tbl)
    return tbl, bf.KernelConfig.from_cfg(cfg), ha, fs, is_


def _same(a, b):
    if a.dtype.is_floating_point:
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


@pytest.mark.parametrize("mode", ["slot2", "slot5", "final_env"])
@pytest.mark.parametrize("textured,omm,split", [
    (False, False, False), (False, True, True), (True, False, False),
    (True, True, False)])
def test_rows_not_copied_are_not_read(textured, omm, split, mode):
    tbl, kcfg, ha, fs, is_ = city(textured)
    final = mode == "final_env"
    if mode == "slot5":
        kcfg = dataclasses.replace(kcfg, nee_mode=5)
    tex = bf.use_tex(tbl, kcfg) and not final
    assert tex == (textured and not final)
    omm, prio = omm and not final, False
    rows, _ = BC.shade_stage_rows(tex, omm, split)
    staged = {r for a, r in rows if a == "ha"}
    exports = kcfg.external and tbl.n_lights > 0 and not final
    copied = set(BC.shade_ha_read(tex, omm, final, exports))
    assert copied <= staged
    if final:
        assert copied == set(BC.SHADE_HA_BASE[:5])
    else:
        assert staged - copied == (
            set() if exports else {BC.HA_ATTR + bf.AT_LID})
    fs2 = torch.zeros((bf.NF2, fs.shape[1])) if split else None
    poisoned = ha.clone()
    for r in set(range(BC.HA_ROWS)) - copied:
        poisoned[r] = torch.nan
    want = BC.shade_reference(ha, fs, is_, tbl, kcfg, 1, final, omm, prio,
                              fs2)
    got = BC.shade_reference(poisoned, fs, is_, tbl, kcfg, 1, final, omm,
                             prio, fs2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert (ha[BC.HA_PRIM] >= 0).any()

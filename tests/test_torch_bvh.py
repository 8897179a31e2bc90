"""The port's LBVH and ray queries against the JAX package, on the CPU.

  - `lbvh.build_bvh`, numpy and native (csrc/lbvh.cpp) versions, against
    the JAX package's build of the same seeded triangle soups: node rows,
    prim_tri, the leaf triangles and the brute-force operands equal entry
    by entry, and `bvh.bvh_from_numpy` of the JAX package's fields equal to
    the port's own build.
  - The brute force (accel/brute.py, K8's plain version) against
    `rtxpt_tpu.accel.brute.intersect_closest_brute`, and the BVH walk
    (accel/traverse.py, K9's plain version) against the JAX package's
    `_traverse`, closest and any-hit, on seeded rays (a few with NaN or
    axis-parallel components): prim ids, front and occlusion equal on
    >= 99.9% of rays, t, u and v within rtol = atol = 1e-5 on >= 99.9% of
    the rays whose prims agree (the two packages sum the dot products in
    other orders).
  - The plain walk against the plain brute force on the same scene (as
    tests/test_bvh.py:33-56 holds the JAX walk to brute force): prim ids
    equal, t within 1e-4; the any-hit walk against the closest walk; the
    visit counts of the walk.
  - The native LBVH raises instead of falling back to numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.accel import brute as jbrute
from rtxpt_tpu.accel import lbvh as jlbvh
from rtxpt_tpu.accel import traverse as jtrav
from rtxpt_tpu_torch.accel import brute, lbvh, native, traverse
from rtxpt_tpu_torch.accel.bvh import bvh_from_numpy

LANES = 0.999
TOL = 1e-5


def _soup(n, seed, extent=10.0):
    """Random triangle soup (positions [3n,3], indices [n,3]), the JAX
    package's random_triangles."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    edges = rng.normal(0, 0.5, (n, 2, 3)).astype(np.float32)
    pos = np.stack([centers, centers + edges[:, 0], centers + edges[:, 1]],
                   axis=1).reshape(-1, 3)
    return pos, np.arange(3 * n, dtype=np.int32).reshape(-1, 3)


def _rays(pos, idx, n, seed):
    """Rays aimed near random triangles from outside, with a few NaN and
    axis-parallel lanes and some short tmax."""
    rng = np.random.default_rng(seed)
    targets = pos[idx[rng.integers(0, len(idx), n), 0]] \
        + rng.normal(0, 0.2, (n, 3))
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = np.nan
    o[4:8] = np.nan
    d[8:24, 0] = 0.0
    tmin = np.full((n,), 1e-3, np.float32)
    tmax = np.full((n,), 1e9, np.float32)
    tmax[24:88] = 6.0
    return o, d, tmin, tmax


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("ntri", [1, 2, 33, 1000, 5000])
def test_lbvh_matches_jax_package(ntri, use_native):
    pos, idx = _soup(ntri, ntri)
    jb = jlbvh.build_bvh(pos, idx, use_native=use_native)
    tb = lbvh.build_bvh(pos, idx, use_native=use_native, device="cpu")
    assert tb.num_nodes == 2 * ntri - 1
    names = ("nodes", "tri_v0", "tri_e1", "tri_e2", "prim_tri")
    for name in names:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    np.testing.assert_array_equal(tb.nodes[:, 6:8].numpy(), np.stack(
        [np.asarray(jb.node_prim), np.asarray(jb.node_miss)], 1))
    assert (tb.brute is None) == (jb.brute is None) == (ntri > 4096)
    fields = {k: np.asarray(getattr(jb, k)) for k in names}
    if tb.brute is not None:
        assert torch.equal(brute.build_brute(pos, idx, "cpu").table,
                           tb.brute.table)
        table = tb.brute.table.numpy()
        for name, col in brute.FIELDS:
            np.testing.assert_array_equal(
                table[:, col:col + 3], np.asarray(getattr(jb.brute, name)).T)
        np.testing.assert_array_equal(table[:, brute.TB_V0N],
                                      np.asarray(jb.brute.v0n))
        fields["brute"] = {k: np.asarray(getattr(jb.brute, k))
                           for k in ("e1_t", "e2_t", "n_t", "v0xe2_t",
                                     "v0xe1_t", "v0n")}
    # the JAX package's BVH carried across as numpy arrays is the port's
    carried = bvh_from_numpy(fields, device="cpu")
    for name in names:
        assert torch.equal(getattr(carried, name), getattr(tb, name)), name
    assert (carried.brute is None) == (tb.brute is None)
    if tb.brute is not None:
        assert torch.equal(carried.brute.table, tb.brute.table)


def test_native_and_numpy_lbvh_agree():
    pos, idx = _soup(3000, 11)
    a = lbvh.build_bvh(pos, idx, use_native=True, device="cpu")
    b = lbvh.build_bvh(pos, idx, use_native=False, device="cpu")
    assert torch.equal(a.nodes, b.nodes) and torch.equal(a.prim_tri,
                                                         b.prim_tri)


def test_native_lbvh_raises_instead_of_falling_back(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    pos, idx = _soup(8, 0)
    with pytest.raises(RuntimeError, match="missing"):
        lbvh.build_bvh(pos, idx, device="cpu")


@pytest.fixture(scope="module")
def soup():
    """A 700-triangle soup (brute tables) with its JAX and port BVHs and
    2,048 rays."""
    pos, idx = _soup(700, 3)
    jb = jlbvh.build_bvh(pos, idx)
    tb = lbvh.build_bvh(pos, idx, device="cpu")
    return jb, tb, _rays(pos, idx, 2048, 4)


def _agree(t_out, j_out, tag, finite):
    """prim and front equal on >= 99.9% of rays; t, u and v within
    rtol = atol = 1e-5 on >= 99.9% of the rays with finite inputs whose
    prims agree (near grazing hits, |det| small, the factored form's
    cancellation in another summation order moves u or v past 1e-5 on a
    lane or two). On a ray with NaN components the JAX walk reports t and
    uv NaN (it derives its loop carry as (o + d + tmin + tmax) * 0); the
    port reports tmax and 0, as the JAX brute force does."""
    prim_t = t_out["prim"].numpy()
    prim_j = np.asarray(j_out["prim"])
    same = prim_t == prim_j
    assert same.mean() >= LANES, (tag, same.mean())
    same = same & finite
    assert (prim_t >= 0).sum() > 100, tag
    for key in ("t", "uv"):
        a = t_out[key].numpy()[same].reshape(same.sum(), -1)
        b = np.asarray(j_out[key])[same].reshape(same.sum(), -1)
        close = np.isclose(a, b, rtol=TOL, atol=TOL, equal_nan=True)
        assert close.all(-1).mean() >= LANES, (tag, key)
    front_same = t_out["front"].numpy() == np.asarray(j_out["front"])
    assert front_same[same].mean() >= LANES, tag


def test_brute_matches_jax_package(soup):
    jb, tb, (o, d, tmin, tmax) = soup
    jh = jbrute.intersect_closest_brute(
        jb.brute, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax))
    th = brute.closest(tb.brute, *map(torch.from_numpy, (o, d, tmin, tmax)))
    _agree(th, dict(t=jh.t, prim=jh.prim, uv=jh.bary, front=jh.front),
           "brute", np.ones(len(o), bool))
    occ_j = np.asarray(jbrute.intersect_any_brute(
        jb.brute, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax)))
    occ_t = brute.intersect_any_brute(
        tb.brute, *map(torch.from_numpy, (o, d, tmin, tmax))).numpy()
    assert (occ_t == occ_j).mean() >= LANES


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_matches_jax_package(soup, any_hit):
    jb, tb, (o, d, tmin, tmax) = soup
    js = jtrav._traverse(jb, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(tmin), jnp.asarray(tmax), any_hit)
    ts = traverse.walk(tb, *map(torch.from_numpy, (o, d, tmin, tmax)),
                       any_hit=any_hit)
    if any_hit:
        occ_t = ts["prim"].numpy() >= 0
        occ_j = np.asarray(js["prim"]) >= 0
        assert (occ_t == occ_j).mean() >= LANES
        assert occ_t.sum() > 100
    else:
        _agree(ts, js, "walk", np.isfinite(o).all(1) & np.isfinite(d).all(1))


def test_walk_matches_brute_force():
    """The plain walk against the plain brute force of the same scene, and
    the scene queries taking each path."""
    pos, idx = _soup(1000, 5)
    bvh = lbvh.build_bvh(pos, idx, device="cpu")
    o, d, tmin, tmax = map(torch.from_numpy, _rays(pos, idx, 1024, 6))
    w = traverse.walk(bvh, o, d, tmin, tmax, stats=True)
    prim_w = torch.where(w["prim"] >= 0,
                         bvh.prim_tri[w["prim"].clamp(min=0).long()], -1)
    b = brute.closest(bvh.brute, o, d, tmin, tmax)
    assert torch.equal(prim_w, b["prim"])
    torch.testing.assert_close(w["t"], b["t"], rtol=1e-4, atol=1e-4)
    # the queries: brute first, the walk when the BVH has no brute tables
    walk_only = bvh.replace(brute=None)
    hit = traverse.intersect_closest(walk_only, o, d, tmin, tmax)
    assert torch.equal(hit.prim, prim_w)
    assert torch.equal(traverse.intersect_closest(bvh, o, d, tmin,
                                                  tmax).prim, b["prim"])
    occ = traverse.intersect_any(walk_only, o, d, tmin, tmax)
    assert torch.equal(occ, ~hit.miss)
    # every ray visits the root; a hit needs a triangle test
    assert bool((w["visits"] >= 1).all())
    assert bool((w["tests"][prim_w >= 0] >= 1).all())
    assert int(w["visits"].sum()) < 1024 * bvh.num_nodes


def test_plain_walk_is_the_per_ray_walk():
    """Dropping finished rays between steps changes no ray's result: a
    wavefront walk equals the walks of its rays one by one."""
    pos, idx = _soup(200, 7)
    bvh = lbvh.build_bvh(pos, idx, device="cpu")
    o, d, tmin, tmax = map(torch.from_numpy, _rays(pos, idx, 48, 8))
    full = traverse.walk(bvh, o, d, tmin, tmax, stats=True)
    for i in range(0, 48, 5):
        one = traverse.walk(bvh, o[i:i + 1], d[i:i + 1], tmin[i:i + 1],
                            tmax[i:i + 1], stats=True)
        for key, value in one.items():
            torch.testing.assert_close(value, full[key][i:i + 1],
                                       rtol=0, atol=0, equal_nan=True)

"""K9's 4-wide BVH (accel/bvh.py collapse_wide) and its plain walk
(accel/traverse.py _traverse_wide) on the CPU, without JAX.

  - The collapse: every leaf appears once, each child box is bit-equal to
    the AABB of the binary node that covers the same leaves, the recorded
    depth and stack bound are those of the tree, and a tree whose walk
    could need more stack than K9 keeps raises in the build.
  - The wide walk against the threaded walk `_traverse` (held to the JAX
    package's walk in tests/test_torch_bvh.py) on seeded triangle soups,
    a soup of coincident triangles (the tie rule and the prune's slack), a
    small city, and the curtain Cornell box's micromap BVH: prim, front,
    t, u and v equal on every lane, closest-hit and any-hit, except lanes
    whose two winners' t agree within 1e-6 relative: there the threaded
    walk, in its fixed order, pruned a leaf whose hit lies an ulp or two
    nearer than the one it kept (its box entry rounded above the best t
    at the time), and the nearest-first walk keeps that leaf. The test
    counts and prints such lanes (`pytest -s`): 11 of 2,048 on the small
    city's closest hits, 0 elsewhere.
  - The wide walk visits fewer nodes than the threaded walk.
"""

import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.accel import bvh as B
from rtxpt_tpu_torch.accel import lbvh, traverse
from rtxpt_tpu_torch.scene import procedural as TP

NEAR_TIE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(n, seed, extent=10.0):
    """Random triangle soup (positions [3n,3], indices [n,3]), as
    tests/test_torch_bvh.py builds it."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    edges = rng.normal(0, 0.5, (n, 2, 3)).astype(np.float32)
    pos = np.stack([centers, centers + edges[:, 0], centers + edges[:, 1]],
                   axis=1).reshape(-1, 3)
    return pos, np.arange(3 * n, dtype=np.int32).reshape(-1, 3)


def _coincident(n, seed):
    """A soup in which every triangle appears three times (the same
    vertices, so the same t on every ray) and a third of them once more
    slid within its own plane, so that rays meet equal and near-equal t
    at several leaves."""
    pos, idx = _soup(n, seed, extent=4.0)
    tri = pos.reshape(n, 3, 3)
    rng = np.random.default_rng(seed + 1)
    k = n // 3
    e1, e2 = tri[:k, 1] - tri[:k, 0], tri[:k, 2] - tri[:k, 0]
    slide = (rng.uniform(0.05, 0.3, (k, 1)) * e1
             + rng.uniform(0.05, 0.3, (k, 1)) * e2).astype(np.float32)
    tris = np.concatenate([tri, tri, tri, tri[:k] + slide[:, None]])
    tris = tris[rng.permutation(len(tris))]
    return tris.reshape(-1, 3), np.arange(3 * len(tris),
                                          dtype=np.int32).reshape(-1, 3)


def _rays(pos, idx, n, seed):
    """Rays aimed near random triangles from outside, with a few NaN and
    axis-parallel lanes and some short tmax (tests/test_torch_bvh.py)."""
    rng = np.random.default_rng(seed)
    targets = pos[idx[rng.integers(0, len(idx), n), 0]] \
        + rng.normal(0, 0.2, (n, 3))
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = np.nan
    o[4:8] = np.nan
    d[8:24, 0] = 0.0
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[24:64] = rng.uniform(1.0, 10.0, 40).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (o, d, tmin, tmax))


def _city():
    g = TP.city_scene(tri_budget=4000, seed=1, blocks=2).flatten().geometry
    return g.positions.numpy(), g.indices.numpy()


def _curtain():
    """(BVH with the curtain's micromap words, 2,048 camera rays over its
    frame)."""
    from rtxpt_tpu_torch.config import PathTracerConfig
    from rtxpt_tpu_torch.prepare import prepare
    from rtxpt_tpu_torch.pt.integrator import _pixel_grid, camera_rays
    host = TP.curtain_cornell(True)
    scene = prepare(host, device="cpu")
    cam = TP.default_camera(host, 64, 32)
    px, py = _pixel_grid(64, 32, "cpu")
    o, d, _ = camera_rays(cam, PathTracerConfig(), px, py, 1)
    n = o.shape[0]
    return scene.bvh, (o.contiguous(), d.contiguous(), torch.zeros(n),
                       torch.full((n,), 1e27))


SCENES = {
    "soup700": lambda: _soup(700, 3),
    "soup1000": lambda: _soup(1000, 5),
    "coincident": lambda: _coincident(600, 21),
    "city": _city,
}


def _scene(name):
    if name == "curtain":
        return _curtain()
    pos, idx = SCENES[name]()
    return (lbvh.build_bvh(pos, idx, device="cpu"),
            _rays(pos, idx, 2048, len(idx)))


def _leaf_ranges(packed):
    """Each binary node's first and last leaf index (its subtree is the
    preorder span node .. miss - 1)."""
    m = len(packed)
    prim = packed[:, 6].astype(np.int64)
    miss = packed[:, 7].astype(np.int64)
    end = np.where(miss < 0, m, miss)
    leaf_at = np.where(prim >= 0, prim, -1)
    lo = np.empty(m, np.int64)
    hi = np.empty(m, np.int64)
    for i in range(m):
        leaves = leaf_at[i:end[i]]
        leaves = leaves[leaves >= 0]
        lo[i], hi[i] = leaves.min(), leaves.max()
    return lo, hi


def _wide_leaves(refs, node, memo):
    """The leaves under wide node `node`, sorted."""
    if node not in memo:
        out = []
        for r in refs[node]:
            if r > 0:
                out += _wide_leaves(refs, int(r), memo)
            elif r < 0:
                out.append(int(-r - 1))
        memo[node] = sorted(out)
    return memo[node]


@pytest.mark.parametrize("name", ["one", "two", "three", "soup700", "city"])
def test_collapse_keeps_leaves_boxes_depth_and_stack(name):
    if name in ("one", "two", "three"):
        pos, idx = _soup({"one": 1, "two": 2, "three": 3}[name], 4)
    else:
        pos, idx = SCENES[name]()
    packed, _ = lbvh.build_packed(pos, idx)
    wide, tris, depth, stack = B.collapse_wide(packed)
    assert wide.shape[1] == B.WIDE_ROWS and wide.dtype == np.float32
    refs = wide[:, B.WIDE_REF:B.WIDE_REF + 4].view(np.int32)
    # every leaf once, every inner wide node referenced once
    leaves = -refs[refs < 0] - 1
    assert np.array_equal(np.sort(leaves), np.arange(len(idx)))
    inner = refs[refs > 0]
    assert np.array_equal(np.sort(inner), np.arange(1, len(wide)))
    assert np.all(wide[:, 28:] == 0)
    # each child box bit for bit the AABB of the binary node covering the
    # same leaves
    lo, hi = _leaf_ranges(packed)
    node_of = {(int(a), int(b)): i for i, (a, b) in enumerate(zip(lo, hi))}
    memo = {}
    boxes = wide[:, :B.WIDE_REF].reshape(-1, 6, 4)
    for w in range(len(wide)):
        for c, r in enumerate(refs[w]):
            if r == 0:
                continue
            under = [int(-r - 1)] if r < 0 else _wide_leaves(refs, int(r),
                                                              memo)
            assert under == list(range(under[0], under[-1] + 1))
            b = node_of[(under[0], under[-1])]
            assert np.array_equal(boxes[w, :, c].view(np.int32),
                                  packed[b, 0:6].view(np.int32))
    # the triangle rows are the leaf rows' v0, e1, e2
    leaf_rows = packed[packed[:, 6] >= 0]
    order = leaf_rows[:, 6].astype(np.int64)
    for k, cols in enumerate(((0, 3), (4, 7), (8, 11))):
        assert np.array_equal(tris[order, cols[0]:cols[1]].view(np.int32),
                              leaf_rows[:, 8 + 3 * k:11 + 3 * k]
                              .view(np.int32))

    # the depth and the stack bound, from the references
    def walk(node, below):
        k = int((refs[node] > 0).sum())
        levels, need = 1, below + k
        for r in refs[node][refs[node] > 0]:
            lv, nd = walk(int(r), below + k - 1)
            levels, need = max(levels, lv + 1), max(need, nd)
        return levels, need
    levels, need = walk(0, 0)
    assert depth == levels and stack == max(need, 1)
    if name == "city":
        assert depth >= 4 and len(wide) < len(packed) // 3


def test_tree_deeper_than_the_stack_raises(monkeypatch):
    pos, idx = SCENES["soup700"]()
    built = lbvh.build_bvh(pos, idx, device="cpu")
    monkeypatch.setattr(B, "WIDE_STACK", built.wide_stack - 1)
    with pytest.raises(ValueError, match=f"{built.wide_depth} levels"):
        lbvh.build_bvh(pos, idx, device="cpu")


def test_stack_limit_matches_the_kernel():
    from pathlib import Path
    src = (Path(B.__file__).resolve().parents[1] / "csrc"
           / "accel.cuh").read_text()
    assert f"kWideStack = {B.WIDE_STACK};" in src
    assert "kWideSlack = 1.0f / 1048576.0f" in src
    assert traverse.WIDE_SLACK == 1.0 / 1048576.0


def _differ(a, b, any_hit):
    """(lanes that differ, lanes whose winners' t agree within NEAR_TIE
    relative among them)."""
    if any_hit:
        return int(((a["prim"] >= 0) != (b["prim"] >= 0)).sum()), 0
    bits = lambda x: x.contiguous().view(torch.int32)   # noqa: E731
    same = ((a["prim"] == b["prim"]) & (a["front"] == b["front"])
            & (bits(a["t"]) == bits(b["t"]))
            & (bits(a["uv"]) == bits(b["uv"])).all(1))
    bad = ~same
    near = bad & ((a["t"] - b["t"]).abs()
                  <= NEAR_TIE * torch.maximum(a["t"].abs(), b["t"].abs()))
    return int(bad.sum()), int(near.sum())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", ["soup700", "soup1000", "coincident",
                                  "city", "curtain"])
def test_wide_walk_matches_the_threaded_walk(name, any_hit, capsys):
    bvh, (o, d, tmin, tmax) = _scene(name)
    assert (bvh.tri_micro is not None) == (name == "curtain")
    wide = traverse._traverse_wide(bvh, o, d, tmin, tmax, any_hit, True)
    thr = traverse._traverse(bvh, o, d, tmin, tmax, any_hit, True)
    differ, near = _differ(wide, thr, any_hit)
    with capsys.disabled():
        print(f"\nK9 wide walk {name} {'any' if any_hit else 'closest'}: "
              f"{differ} of {o.shape[0]} lanes differ ({near} near ties); "
              f"visits {float(wide['visits'].float().mean()):.2f} wide vs "
              f"{float(thr['visits'].float().mean()):.2f} threaded, tests "
              f"{float(wide['tests'].float().mean()):.3f} vs "
              f"{float(thr['tests'].float().mean()):.3f} per ray")
    # a differing lane is a near tie: the threaded walk pruned, by its
    # order, a leaf whose hit lies within an ulp or two of the one it kept
    assert differ == near
    hits = int((wide["prim"] >= 0).sum())
    assert hits > (50 if name == "curtain" else 100)
    assert bool((wide["visits"] >= 1).all())
    assert int(wide["visits"].sum()) < int(thr["visits"].sum())
    # the walk is the wrapper's on CPU tensors
    via_walk = traverse.walk(bvh, o, d, tmin, tmax, any_hit, True)
    for key, value in wide.items():
        assert torch.equal(value, via_walk[key]), key


def test_wide_walk_is_the_per_ray_walk():
    """Dropping finished rays between steps and sharing a step changes no
    ray's result or counts."""
    bvh, (o, d, tmin, tmax) = _scene("coincident")
    full = traverse._traverse_wide(bvh, o, d, tmin, tmax, False, True)
    for i in range(0, 2048, 97):
        one = traverse._traverse_wide(bvh, o[i:i + 1], d[i:i + 1],
                                      tmin[i:i + 1], tmax[i:i + 1], False,
                                      True)
        for key, value in one.items():
            torch.testing.assert_close(value, full[key][i:i + 1], rtol=0,
                                       atol=0, equal_nan=True)

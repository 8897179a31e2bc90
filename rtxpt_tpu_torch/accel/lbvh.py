"""LBVH construction (counterpart of rtxpt_tpu/accel/lbvh.py): Morton sort +
Karras radix-tree topology, host-side numpy, emitted in the threaded
preorder layout of accel/bvh.py.

Stages (all O(n) vectorized passes; loops run over bit counts, not
primitives):
  1. Morton-30 codes of triangle-AABB centroids, key = code<<32 | index
  2. Karras internal-node ranges and splits from longest-common-prefix
     deltas
  3. bottom-up AABB propagation (masked passes, <= 64 = key length)
  4. analytic preorder numbering + miss links from contiguous leaf ranges

The numpy code is the JAX package's, so both packages build the same
table; the C++ code of csrc/lbvh.cpp (accel/native.py) builds it too.
"""

from __future__ import annotations

import numpy as np

from rtxpt_tpu_torch.accel import brute as brute_mod
from rtxpt_tpu_torch.accel.bvh import NODE_ROWS, ThreadedBVH, bvh_from_packed

_AABB_EPS = 1e-7


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd position (uint32)."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton3d(centroids: np.ndarray, lo: np.ndarray,
             hi: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points normalized to [lo,hi], shape [n]."""
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip((centroids - lo) / ext * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (_expand_bits(q[:, 0]) * np.uint64(4)
            + _expand_bits(q[:, 1]) * np.uint64(2)
            + _expand_bits(q[:, 2])).astype(np.uint64)


def _msb_pos(x: np.ndarray) -> np.ndarray:
    """Position of most significant set bit of uint64 (x>0), vectorized."""
    r = np.zeros(x.shape, np.int64)
    x = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        m = (x >> np.uint64(shift)) != 0
        r += shift * m
        x = np.where(m, x >> np.uint64(shift), x)
    return r


def build_packed(positions, indices, use_native: bool = True):
    """The LBVH's host arrays: (packed [2n-1, 17] f32 node table, order
    [n] leaf -> original triangle). `use_native` runs the C++ code
    (csrc/lbvh.cpp through accel/native.py, which raises when it cannot
    build or run it); `use_native=False` the vectorized numpy version
    below. Both give the same table."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    assert len(indices) >= 1
    if use_native:
        from rtxpt_tpu_torch.accel import native
        return native.build_packed_native(positions, indices)
    return _build_packed(positions[indices[:, 0]], positions[indices[:, 1]],
                         positions[indices[:, 2]])


def build_bvh(positions, indices, use_native: bool = True,
              device="cuda") -> ThreadedBVH:
    """Build a threaded LBVH over triangles (host arrays) on `device` (the
    GPU by default; raises without one), with the brute-force operands
    when the scene has at most brute.BRUTE_MAX_TRIS triangles.
    `use_native` as in `build_packed`."""
    import rtxpt_tpu_torch

    device = rtxpt_tpu_torch.device(device)
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    n = len(indices)
    assert n >= 1
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    brute = None
    if n <= brute_mod.BRUTE_MAX_TRIS:
        brute = brute_mod.brute_from_edges(v0, v1 - v0, v2 - v0, device)
    packed, order = build_packed(positions, indices, use_native)
    sv0, sv1, sv2 = v0[order], v1[order], v2[order]
    return bvh_from_packed(packed, order, sv0, sv1 - sv0, sv2 - sv0,
                           brute=brute, device=device)


def _build_packed(v0, v1, v2):
    """The numpy LBVH: (packed [2n-1, 17] f32, order [n] leaf -> original
    triangle)."""
    n = len(v0)

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5

    codes = morton3d(centroid, tmin.min(0), tmax.max(0))
    order = np.argsort(codes, kind="stable").astype(np.int64)
    # Unique 62-bit keys: morton<<32 | sorted position.
    keys = (codes[order] << np.uint64(32)) | np.arange(n, dtype=np.uint64)

    leaf_min = tmin[order]
    leaf_max = tmax[order]

    if n == 1:
        return _emit(np.asarray([[0, 0]]), np.zeros((1, 2), np.int64),
                     leaf_min, leaf_max, order, v0, v1, v2,
                     single_leaf=True), order

    ni = n - 1  # internal nodes
    i = np.arange(ni, dtype=np.int64)

    def delta(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Common-prefix length of keys[a], keys[b]; -1 when b out of range."""
        valid = (b >= 0) & (b < n)
        bs = np.clip(b, 0, n - 1)
        x = keys[a] ^ keys[bs]
        d = np.where(x == 0, np.int64(64), 63 - _msb_pos(np.maximum(x, 1)))
        return np.where(valid, d, np.int64(-1))

    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Exponential search for range length upper bound.
    lmax = np.full(ni, 2, np.int64)
    for _ in range(64):
        cond = delta(i, i + lmax * d) > delta_min
        if not cond.any():
            break
        lmax = np.where(cond, lmax * 2, lmax)

    # Binary search for exact length l.
    l = np.zeros(ni, np.int64)
    t = lmax // 2
    while (t > 0).any():
        tt = np.maximum(t, 0)
        cond = (t > 0) & (delta(i, i + (l + tt) * d) > delta_min)
        l = np.where(cond, l + tt, l)
        t = t // 2
    j = i + l * d
    delta_node = delta(i, j)

    # Binary search for split position s.
    s = np.zeros(ni, np.int64)
    t = l.copy()
    active = np.ones(ni, bool)
    for _ in range(64):
        if not active.any():
            break
        t = np.where(active, (t + 1) >> 1, t)
        cond = active & (delta(i, i + (s + t) * d) > delta_node)
        s = np.where(cond, s + t, s)
        active = active & (t > 1)
    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    # Child encoding: internal nodes are 0..n-2, leaf k is (n-1)+k.
    left = np.where(lo == gamma, gamma + ni, gamma)
    right = np.where(hi == gamma + 1, gamma + 1 + ni, gamma + 1)

    children = np.stack([left, right], axis=1)          # [ni,2]
    ranges = np.stack([lo, hi], axis=1)                  # [ni,2]
    return _emit(children, ranges, leaf_min, leaf_max, order, v0, v1, v2,
                 gamma=gamma), order


def _emit(children, ranges, leaf_min, leaf_max, order, v0, v1, v2,
          gamma=None, single_leaf=False) -> np.ndarray:
    n = len(leaf_min)
    if single_leaf:
        node_min = leaf_min - _AABB_EPS
        node_max = leaf_max + _AABB_EPS
        node_prim = np.zeros((1,), np.int32)
        node_miss = np.full((1,), -1, np.int32)
        return _pack(node_min, node_max, node_prim, node_miss, order, v0,
                     v1, v2)

    ni = n - 1
    m = 2 * n - 1

    # ---- bottom-up AABB propagation (masked passes) ----
    amin = np.empty((m, 3), np.float32)
    amax = np.empty((m, 3), np.float32)
    amin[ni:] = leaf_min
    amax[ni:] = leaf_max
    done = np.zeros(m, bool)
    done[ni:] = True
    left, right = children[:, 0], children[:, 1]
    for _ in range(72):
        ready = ~done[:ni] & done[left] & done[right]
        if not ready.any():
            if done[:ni].all():
                break
            continue
        idx = np.nonzero(ready)[0]
        amin[idx] = np.minimum(amin[left[idx]], amin[right[idx]])
        amax[idx] = np.maximum(amax[left[idx]], amax[right[idx]])
        done[idx] = True
    assert done.all(), "AABB propagation did not converge"

    # ---- preorder numbering + miss links (top-down masked passes) ----
    # Internal node covering sorted-leaf range [lo,hi] with split gamma:
    #   subtree size = 2*(hi-lo+1)-1 ; left size = 2*(gamma-lo+1)-1
    lo, hi = ranges[:, 0], ranges[:, 1]
    left_size = 2 * (gamma - lo + 1) - 1
    pre = np.full(m, -1, np.int64)
    miss = np.full(m, -2, np.int64)
    pre[0] = 0
    miss[0] = -1
    known = np.zeros(m, bool)
    known[0] = True
    child_assigned = np.zeros(ni, bool)
    for _ in range(72):
        ready = known[:ni] & ~child_assigned
        if not ready.any():
            if child_assigned.all():
                break
            continue
        idx = np.nonzero(ready)[0]
        pl = pre[idx] + 1
        pr = pre[idx] + 1 + left_size[idx]
        pre[left[idx]] = pl
        pre[right[idx]] = pr
        miss[left[idx]] = pr
        miss[right[idx]] = miss[idx]
        known[left[idx]] = True
        known[right[idx]] = True
        child_assigned[idx] = True
    assert child_assigned.all(), "preorder assignment did not converge"

    # ---- scatter to preorder layout ----
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    node_prim = np.empty(m, np.int32)
    node_miss = np.empty(m, np.int32)
    node_min[pre] = amin - _AABB_EPS
    node_max[pre] = amax + _AABB_EPS
    prim_of_node = np.concatenate([np.full(ni, -1, np.int64),
                                   np.arange(n, dtype=np.int64)])
    node_prim[pre] = prim_of_node.astype(np.int32)
    node_miss[pre] = miss.astype(np.int32)
    return _pack(node_min, node_max, node_prim, node_miss, order, v0, v1, v2)


def _pack(node_min, node_max, node_prim, node_miss, order, v0, v1, v2):
    sv0 = v0[order].astype(np.float32)
    sv1 = v1[order].astype(np.float32)
    sv2 = v2[order].astype(np.float32)
    m = len(node_min)
    assert m < (1 << 24), "int-in-f32 packing limit"
    packed = np.zeros((m, NODE_ROWS), np.float32)
    packed[:, 0:3] = node_min
    packed[:, 3:6] = node_max
    packed[:, 6] = node_prim.astype(np.float32)
    packed[:, 7] = node_miss.astype(np.float32)
    leaf = node_prim >= 0
    li = node_prim[leaf]
    packed[leaf, 8:11] = sv0[li]
    packed[leaf, 11:14] = sv1[li] - sv0[li]
    packed[leaf, 14:17] = sv2[li] - sv0[li]
    return packed

"""Stateless sample generators (counterpart of rtxpt_tpu/utils/rng.py).

Every sample is a pure function of uint32 indices keyed by (pixel, path
vertex, effect, sample index, dimension): hash-based Owen-scrambled
Sobol' (Burley, "Practical Hash-Based Owen Scrambling", JCGT 2020) plus
plain hash chains. The results are bit-identical to the JAX package.

uint32 arithmetic is emulated in int64 tensors that hold values in
[0, 2^32): torch on the CPU has no uint32 right shift. Every operation
masks back to 32 bits, and products go through `_mul32`, which splits one
factor into 16-bit halves so that no intermediate leaves int64's range
(no reliance on signed wraparound). The CUDA kernel computes the same
functions in native uint32 (csrc/rng.cuh).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """Any integer tensor / array / scalar -> int64 tensor in [0, 2^32)
    (the value jnp's astype(uint32) gives, e.g. int32 -1 -> 0xFFFFFFFF)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(np.asarray(x, dtype=np.int64)) & M32


def _mul32(a, b):
    """Low 32 bits of a*b for a, b in [0, 2^32); b may be a Python int."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def reverse_bits_u32(x):
    """Bit-reverse each uint32 lane."""
    x = _u32(x)
    x = ((x >> 16) | (x << 16)) & M32
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def lowbias32(x):
    """Low-bias integer hash (Chris Wellons' constants)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_combine(a, b):
    """Order-dependent combine of two uint32 streams."""
    a = _u32(a)
    b = _u32(b)
    return lowbias32(a ^ ((b + 0x9E3779B9 + (a << 6) + (a >> 2)) & M32))


def pcg_hash(x):
    """PCG output permutation of an LCG step."""
    x = _u32(x)
    state = (_mul32(x, 747796405) + 2891336453) & M32
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def u32_to_unit_float(x):
    """uint32 -> f32 in [0, 1) with 24 bits of mantissa (exact)."""
    return (_u32(x) >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# Sobol' direction vectors (Joe & Kuo), as in rtxpt_tpu/utils/rng.py
# ---------------------------------------------------------------------------

SOBOL_NDIM = 8

_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
]


def _make_direction_vectors() -> np.ndarray:
    """32-bit Sobol' direction vectors, shape [SOBOL_NDIM, 32]."""
    nbits = 32
    v = np.zeros((SOBOL_NDIM, nbits), dtype=np.uint64)
    for k in range(nbits):
        v[0, k] = np.uint64(1) << np.uint64(31 - k)
    for d, (s, a, m_init) in enumerate(_JOE_KUO, start=1):
        m = list(m_init)
        for k in range(s, nbits):
            mk = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if (a >> (s - 1 - i)) & 1:
                    mk ^= m[k - i] << i
            m.append(mk)
        for k in range(nbits):
            v[d, k] = np.uint64(m[k]) << np.uint64(31 - k)
    return v.astype(np.uint32)


def _rev32_np(v):
    r = np.zeros_like(v)
    for b in range(32):
        r |= ((v >> np.uint32(b)) & np.uint32(1)) << np.uint32(31 - b)
    return r


SOBOL_V = _make_direction_vectors()          # [NDIM, 32] uint32
REV_SOBOL_V = _rev32_np(SOBOL_V)             # bit-reversed vectors

INDEX_BITS = 16
"""Sample-index space is 2**INDEX_BITS, as in the JAX package: the Owen
index shuffle permutes [0, 2^16) and the folds read 16 index bits. Sample
indices of 65,536 and above therefore alias earlier points (index i and
i + 65,536 give the same sample). Kept for bit-exact parity; `render`
refuses sample indices past the limit."""


def sobol_u32(index, dim: int, nbits: int = 32, rev: bool = False):
    """Sobol' sample `index` in dimension `dim` (static), as uint32.

    `rev=True` folds the bit-reversed direction vectors, which yields
    reverse_bits_u32(sobol). The JAX package builds each fold mask by
    shifting bit k to int32 bit 31 and sign-extending it; here the bit is
    taken out and negated in int64, which gives the same all-ones/zero
    mask over the low 32 bits."""
    if not 0 <= dim < SOBOL_NDIM:
        raise ValueError(f"Sobol' dimension {dim} outside [0, {SOBOL_NDIM})")
    index = _u32(index)
    if dim == 0:
        return index if rev else reverse_bits_u32(index)
    table = REV_SOBOL_V if rev else SOBOL_V
    result = torch.zeros_like(index)
    for k in range(nbits):
        mask = -((index >> k) & 1)               # 0 or all ones
        result = result ^ (mask & int(table[dim, k]))
    return result


# ---------------------------------------------------------------------------
# Hash-based Owen scrambling
# ---------------------------------------------------------------------------


def laine_karras_permutation(x, seed):
    """Seed-keyed per-bit permutation (Burley's improved variant)."""
    x = _u32(x)
    seed = _u32(seed)
    x = x ^ _mul32(x, 0x3D20ADEA)
    x = (x + seed) & M32
    x = _mul32(x, (seed >> 16) | 1)
    x = x ^ _mul32(x, 0x05526C56)
    return x ^ _mul32(x, 0x53A22864)


def _shuffle_index(index, shuffle_seed):
    """Owen shuffle of the sample index within [0, 2**INDEX_BITS)."""
    x = reverse_bits_u32(index) >> (32 - INDEX_BITS)
    x = laine_karras_permutation(x, shuffle_seed)
    x = x & ((1 << INDEX_BITS) - 1)
    return reverse_bits_u32(x) >> (32 - INDEX_BITS)


def _block_seed(seed, block: int):
    if block:
        seed = hash_combine(seed, (block * 0x55555555 + 0x68BC21EB) & M32)
    return seed


def shuffled_scrambled_sobol_u32(index, seed, dim: int):
    """Owen-shuffled, Owen-scrambled Sobol' point in one dimension; dims
    past SOBOL_NDIM decorrelate the seed per block of 8."""
    block, d = divmod(dim, SOBOL_NDIM)
    seed = _block_seed(_u32(seed), block)
    shuffle_seed = lowbias32(seed ^ 0xA511E9B3)
    scramble_seed = hash_combine(seed, d + 1)
    shuffled = _shuffle_index(index, shuffle_seed)
    p_rev = sobol_u32(shuffled, d, nbits=INDEX_BITS, rev=True)
    return reverse_bits_u32(laine_karras_permutation(p_rev, scramble_seed))


# ---------------------------------------------------------------------------
# Public sampling API
# ---------------------------------------------------------------------------


def pixel_seed(px, py, vertex_index, effect):
    """Per-(pixel, path vertex, effect) decorrelation seed."""
    h = hash_combine(px, py)
    h = hash_combine(h, vertex_index)
    return hash_combine(h, effect)


def ld_sample(sample_index, seed, dim: int):
    """Low-discrepancy f32 sample in [0, 1)."""
    return u32_to_unit_float(
        shuffled_scrambled_sobol_u32(sample_index, seed, dim))


def ld_samples(sample_index, seed, dims):
    """Several LD dims sharing the per-block Owen index shuffle."""
    seed = _u32(seed)
    index = _u32(sample_index)
    by_block = {}
    for d in dims:
        by_block.setdefault(d // SOBOL_NDIM, []).append(d)
    out = {}
    for block, ds in by_block.items():
        sb = _block_seed(seed, block)
        shuffled = _shuffle_index(index, lowbias32(sb ^ 0xA511E9B3))
        for d in ds:
            dd = d % SOBOL_NDIM
            p_rev = sobol_u32(shuffled, dd, nbits=INDEX_BITS, rev=True)
            out[d] = u32_to_unit_float(reverse_bits_u32(
                laine_karras_permutation(p_rev, hash_combine(sb, dd + 1))))
    return tuple(out[d] for d in dims)


def uniform_sample(seed, dim):
    """Plain hash-chain uniform f32 in [0, 1)."""
    return u32_to_unit_float(hash_combine(seed, dim))

"""rtxpt_tpu_torch.utils.rng against rtxpt_tpu.utils.rng: bit-identical
uint32 and float32 samples over a grid of pixels, sample indices (across
the 16-bit index space and past it) and dimensions (across a Sobol'
block), plus the CUDA sampler's constant table."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.utils import rng as R
from rtxpt_tpu_torch.utils import rng as T

SAMPLES = [0, 1, 7, 65535, 65536, 2**31 + 5]
DIMS = list(range(18))


def _grid():
    py, px = np.meshgrid(np.arange(64, dtype=np.int32),
                         np.arange(64, dtype=np.int32), indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _u32(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _seeds():
    px, py = _grid()
    j = R.pixel_seed(jnp.asarray(px), jnp.asarray(py), 3, 31)
    t = T.pixel_seed(torch.from_numpy(px), torch.from_numpy(py), 3, 31)
    return _u32(j), t.numpy()


def test_pixel_seed_bit_identical():
    j, t = _seeds()
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("name", ["lowbias32", "pcg_hash", "reverse_bits_u32"])
def test_hashes_bit_identical(name):
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    j = _u32(getattr(R, name)(jnp.asarray(x)))
    t = getattr(T, name)(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(j, t)


def test_hash_combine_and_mul32_wraparound():
    g = np.random.default_rng(1)
    a = g.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    b = g.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    ta = torch.from_numpy(a.astype(np.int64))
    tb = torch.from_numpy(b.astype(np.int64))
    np.testing.assert_array_equal(
        _u32(R.hash_combine(jnp.asarray(a), jnp.asarray(b))),
        T.hash_combine(ta, tb).numpy())
    # the 16-bit split product keeps exactly the low 32 bits of a*b
    np.testing.assert_array_equal((a * b).astype(np.int64),
                                  T._mul32(ta, tb).numpy())


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("nbits", [16, 32])
def test_sobol_folds_bit_identical(rev, nbits):
    idx = np.arange(0, 2**16, 7, dtype=np.uint32)
    for dim in range(R.SOBOL_NDIM):
        j = _u32(R.sobol_u32(jnp.asarray(idx), dim, nbits=nbits, rev=rev))
        t = T.sobol_u32(torch.from_numpy(idx.astype(np.int64)), dim,
                        nbits=nbits, rev=rev).numpy()
        np.testing.assert_array_equal(j, t, err_msg=f"dim {dim}")


def test_owen_pieces_bit_identical():
    js, ts = _seeds()
    x = np.arange(js.shape[0], dtype=np.uint32) * np.uint32(2654435761)
    np.testing.assert_array_equal(
        _u32(R.laine_karras_permutation(jnp.asarray(x),
                                        jnp.asarray(js.astype(np.uint32)))),
        T.laine_karras_permutation(torch.from_numpy(x.astype(np.int64)),
                                   torch.from_numpy(ts)).numpy())
    for s in SAMPLES:
        np.testing.assert_array_equal(
            _u32(R._shuffle_index(jnp.uint32(s),
                                  jnp.asarray(js.astype(np.uint32)))),
            T._shuffle_index(s, torch.from_numpy(ts)).numpy())


@pytest.mark.parametrize("sample", SAMPLES)
def test_ld_samples_bit_identical(sample):
    """u32 per dimension and the f32 sample, dims 0-17 (crossing the
    8-dim Sobol' blocks), at one sample index over 64x64 pixels."""
    js, ts = _seeds()
    jseed = jnp.asarray(js.astype(np.uint32))
    tseed = torch.from_numpy(ts)
    for d in DIMS:
        np.testing.assert_array_equal(
            _u32(R.shuffled_scrambled_sobol_u32(jnp.uint32(sample), jseed,
                                                d)),
            T.shuffled_scrambled_sobol_u32(sample, tseed, d).numpy(),
            err_msg=f"dim {d}")
    jf = R.ld_samples(jnp.uint32(sample), jseed, DIMS)
    tf = T.ld_samples(sample, tseed, DIMS)
    for d, a, b in zip(DIMS, jf, tf):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32),
                                      err_msg=f"dim {d}")
    np.testing.assert_array_equal(
        np.asarray(R.ld_sample(jnp.uint32(sample), jseed, 5)),
        T.ld_sample(sample, tseed, 5).numpy())


def test_uniform_sample_bit_identical():
    js, ts = _seeds()
    for dim in (0, 3, 2**31 + 5):
        np.testing.assert_array_equal(
            np.asarray(R.uniform_sample(jnp.asarray(js.astype(np.uint32)),
                                        jnp.uint32(dim))),
            T.uniform_sample(torch.from_numpy(ts), dim).numpy())


def test_index_space_aliasing_documented():
    """INDEX_BITS = 16 as in the JAX package: index i and i + 2^16 give
    the same sample."""
    assert T.INDEX_BITS == R.INDEX_BITS == 16
    _, ts = _seeds()
    seed = torch.from_numpy(ts)
    for d in (0, 3, 9):
        assert torch.equal(T.ld_sample(5, seed, d),
                           T.ld_sample(5 + (1 << 16), seed, d))


def test_cuda_sobol_table_matches():
    """csrc/rng.cuh's kRevSobol is REV_SOBOL_V[:, :16]."""
    src = (Path(T.__file__).resolve().parents[1] / "csrc" / "rng.cuh") \
        .read_text()
    body = src[src.index("kRevSobol[8][16]"):]
    body = body[:body.index("};")]
    vals = [int(v, 16) for v in re.findall(r"0x([0-9A-Fa-f]+)u", body)]
    np.testing.assert_array_equal(
        np.asarray(vals, np.uint32).reshape(8, 16),
        T.REV_SOBOL_V[:, :16])
    np.testing.assert_array_equal(T.REV_SOBOL_V, R._REV_SOBOL_V)

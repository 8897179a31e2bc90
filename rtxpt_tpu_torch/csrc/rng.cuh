// Stateless sample generators in native uint32 (counterpart of
// rtxpt_tpu/utils/rng.py and rtxpt_tpu_torch/utils/rng.py): low-bias hash,
// hash_combine, and the Owen-shuffled / Owen-scrambled Sobol' sampler over a
// 16-bit sample-index space (INDEX_BITS = 16). Bit-identical to both Python
// versions; 32-bit wraparound is the hardware's.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define RT_HD __device__ __forceinline__
#define RT_CONST __constant__
#else
#define RT_HD inline
#define RT_CONST
#endif

namespace rt {

// Bit-reversed Sobol' direction vectors (Joe & Kuo), dims 0..7, the 16 index
// bits the fold reads: rtxpt_tpu_torch.utils.rng.REV_SOBOL_V[:, :16]
// (tests/test_torch_rng.py checks this table against it).
RT_CONST const uint32_t kRevSobol[8][16] = {
{0x00000001u, 0x00000002u, 0x00000004u, 0x00000008u, 0x00000010u, 0x00000020u, 0x00000040u, 0x00000080u, 0x00000100u, 0x00000200u, 0x00000400u, 0x00000800u, 0x00001000u, 0x00002000u, 0x00004000u, 0x00008000u},
{0x00000001u, 0x00000003u, 0x00000005u, 0x0000000Fu, 0x00000011u, 0x00000033u, 0x00000055u, 0x000000FFu, 0x00000101u, 0x00000303u, 0x00000505u, 0x00000F0Fu, 0x00001111u, 0x00003333u, 0x00005555u, 0x0000FFFFu},
{0x00000001u, 0x00000003u, 0x00000006u, 0x00000009u, 0x00000017u, 0x0000003Au, 0x00000071u, 0x000000A3u, 0x00000116u, 0x00000339u, 0x00000677u, 0x000009AAu, 0x00001601u, 0x00003903u, 0x00007706u, 0x0000AA09u},
{0x00000001u, 0x00000003u, 0x00000004u, 0x0000000Au, 0x0000001Fu, 0x0000002Eu, 0x00000045u, 0x000000C9u, 0x0000011Bu, 0x000002A4u, 0x0000079Au, 0x00000B67u, 0x0000101Eu, 0x0000302Du, 0x00004041u, 0x0000A0C3u},
{0x00000001u, 0x00000002u, 0x00000004u, 0x0000000Du, 0x0000001Fu, 0x0000003Bu, 0x0000005Eu, 0x000000B9u, 0x0000015Au, 0x000003F4u, 0x00000685u, 0x00000D0Fu, 0x0000115Bu, 0x000023F6u, 0x00004681u, 0x0000DD02u},
{0x00000001u, 0x00000002u, 0x00000006u, 0x0000000Cu, 0x00000013u, 0x00000024u, 0x0000006Au, 0x000000DFu, 0x00000107u, 0x0000020Eu, 0x00000615u, 0x00000C28u, 0x00001379u, 0x000024FBu, 0x00006B6Du, 0x0000DDD1u},
{0x00000001u, 0x00000003u, 0x00000005u, 0x0000000Bu, 0x0000001Au, 0x00000029u, 0x0000007Cu, 0x000000C7u, 0x0000017Du, 0x000003C4u, 0x00000478u, 0x000008CFu, 0x00001E62u, 0x000021E6u, 0x0000621Eu, 0x0000E621u},
{0x00000001u, 0x00000002u, 0x00000005u, 0x0000000Au, 0x00000011u, 0x00000024u, 0x00000048u, 0x000000B4u, 0x0000016Eu, 0x00000279u, 0x00000410u, 0x00000826u, 0x0000144Du, 0x000028BEu, 0x0000457Fu, 0x0000925Du},
};

RT_HD uint32_t reverse_bits(uint32_t x) {
#ifdef __CUDACC__
  return __brev(x);
#else
  x = (x >> 16) | (x << 16);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
  return x;
#endif
}

RT_HD uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

RT_HD uint32_t hash_combine(uint32_t a, uint32_t b) {
  return lowbias32(a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2)));
}

// uint32 -> float in [0, 1) with 24 bits of mantissa (exact).
RT_HD float u32_to_unit_float(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

RT_HD uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x ^= x * 0x3D20ADEAu;
  x += seed;
  x *= (seed >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return x;
}

// Owen shuffle of the sample index within [0, 2^16).
RT_HD uint32_t shuffle_index(uint32_t index, uint32_t shuffle_seed) {
  uint32_t x = reverse_bits(index) >> 16;
  x = laine_karras(x, shuffle_seed) & 0xFFFFu;
  return reverse_bits(x) >> 16;
}

// reverse_bits(sobol(index, d)) over the low 16 index bits.
RT_HD uint32_t sobol_rev16(uint32_t index, int d) {
  if (d == 0) return index;
  uint32_t r = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if ((index >> k) & 1u) r ^= kRevSobol[d][k];
  }
  return r;
}

// The sampler draws of one effect: dims of Sobol' block 0 sharing one index
// shuffle (rng.ld_samples), or hash chains (rng.uniform_sample).
struct Sampler {
  uint32_t seed;
  uint32_t sample_idx;
  uint32_t shuffled;
  bool low_discrepancy;

  RT_HD Sampler(uint32_t seed_, uint32_t sample_idx_, bool ld)
      : seed(seed_), sample_idx(sample_idx_), shuffled(0u),
        low_discrepancy(ld) {
    if (ld) shuffled = shuffle_index(sample_idx, lowbias32(seed ^ 0xA511E9B3u));
  }

  RT_HD float dim(int d) const {   // d < 8
    if (!low_discrepancy)
      return u32_to_unit_float(hash_combine(seed, hash_combine(sample_idx, (uint32_t)d)));
    uint32_t p_rev = sobol_rev16(shuffled, d);
    return u32_to_unit_float(
        reverse_bits(laine_karras(p_rev, hash_combine(seed, (uint32_t)(d + 1)))));
  }
};

}  // namespace rt

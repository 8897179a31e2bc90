// Opacity micromaps (rtxpt_tpu_torch/scene/omm.py): the level-2 micro-triangle
// index of a barycentric (u, v), in the f32 operations of the plain
// micro_index (and of the JAX kernels' _micro_state), and the 2-bit state of
// micro-triangle mi in a u32 word (0 opaque, 1 unknown, 2 transparent). Shared
// by K1 and K2 (bounce_fused.cuh), K3 and K5 (cluster.cuh) and K9 (accel.cuh).
#pragma once

#include <math.h>
#include <stdint.h>

#include "wide.cuh"

namespace rt {

enum { MICRO_OPAQUE = 0, MICRO_UNKNOWN = 1, MICRO_TRANSPARENT = 2 };

// The index is clamped to 0..15: a lane whose (u, v) is NaN or out of the
// triangle never keeps a hit, and the clamp keeps its shift defined.
RT_HD int micro_index(float u, float v) {
  const float uu = u * 4.0f, vv = v * 4.0f;
  float a = min_(floorf(uu), 3.0f);
  const float b = min_(floorf(vv), 3.0f);
  const bool inv = (uu - a) + (vv - b) > (float)(1.0 + 1e-7);
  a = min_(a, 3.0f - b);
  const float idx = b * (8.0f - b) + 2.0f * a + ((inv && a + b < 3.0f) ? 1.0f : 0.0f);
  const int mi = (int)idx;
  return mi < 0 ? 0 : (mi > 15 ? 15 : mi);
}

RT_HD int micro_state(uint32_t word, int mi) { return (int)((word >> (2 * mi)) & 3u); }

}  // namespace rt

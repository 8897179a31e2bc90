// K8, the brute-force closest-hit kernel of the general tier, written by hand
// for Hopper (sm_90a).
//
// Replaces rtxpt_tpu/accel/brute_pallas.py::_kernel (launched by _call,
// pl.pallas_call at brute_pallas.py:93, through intersect_brute_pallas), the
// TPU kernel of rtxpt_tpu/accel/brute.py's all-pairs test. Plain version:
// rtxpt_tpu_torch/accel/brute.py::_intersect_chunk; wrapper: brute.closest.
//
// Input: rays o, d [n, 3], tmin, tmax [n]; the triangle table [n_tris, 16]
// (accel/brute.py TB_*: the factored operands n, e2, v0 x e2, e1, v0 x e1,
// v0 . n, one 64-byte row per triangle, n_tris <= 4096); for the
// tensor-core route the scene's coefficient tile of those rows
// (accel/brute.py brute_tile: [30, t8] bf16, [t8] f32). Output: t [n] (tmax
// on a miss), prim [n] (-1 on a miss), uv [n, 2] (0 on a miss), front [n]
// (bool, det > 0 at the hit).
//
// Design. The TPU kernel computes the four Moller-Trumbore quantities of a
// 512 x 512 tile of pairs as one [512, 128] x [128, 2048] matrix product and
// min-reduces along the triangles. Here a ray's pairs are screened before
// the divide, in one of two routes, and the pairs that pass are resolved by
// brute.cuh's brute_accept / brute_pair, the plain version's arithmetic, so
// t, prim, uv and front stay bit-equal to it. The winner is the least (t,
// triangle index): the plain version's first strict minimum in table order.
//
//  - The CUDA-core route (brute_closest_kernel; tables of at most
//    brute.MMA_TRIS = 80 triangles, and those past the tensor-core tile's
//    2048): kRays = 2 rays a thread in blocks of kThreads = 128; the block
//    stages the table in tiles of 128 rows (8 KB) in shared memory, and each
//    staged row (four 16-byte broadcasts) feeds the thread's two rays. Per
//    pair it computes det and u_num exactly as brute_pair does and screens
//    them (brute.cuh brute_screen_u: |det| and u's sign), v_num only where
//    they pass, then the whole screen (brute_screen: the signs and the sum
//    against |det| with a 2^-20 slack), and marks the pair in its ray's
//    mask of 32 triangles; after each 32 the ray's marked pairs go through
//    brute_pair (t's numerator, the IEEE reciprocal and the range tests)
//    in triangle order.
//  - The tensor-core route (brute_closest_kernel_mma): K1's screen
//    (bounce_fused_mma.cuh): each warp's 32 rays against the staged tile as
//    split-bf16 mma.sync products [d | o x d] x [c_hi | c_lo], screened with
//    K1's margins; every pair brute_pair accepts passes (the tile's error
//    term covers the products' and the f32 sums' rounding), and the passing
//    pairs are resolved per group of 128 triangles by brute_pair on the f32
//    rows.
// The launch shapes, the early u test, the resolve and the routes'
// crossover were measured on the card (tools/k1_bench.py --kernel k8
// --sweep at commits 7518973 and eab1932; PERF.md): 1, 2 or 4 rays a
// thread in 64-256-thread blocks were within 4% of each other without the
// u test, two rays a thread with it the fastest on the 2,073,600-ray
// launches; the tensor-core route passes the CUDA-core one at about 80
// triangles and is 1.25x faster at the kitchen's 1,186.
//
// What bounds it: issued instructions. The plain test costs 48 f32
// operations a pair (chip_smoke.py K8_PAIR_F32, the bound's count); the
// CUDA-core screen spends about 16 on det and u for every pair, 11 more on
// v and 8 on the screen where u passes, and the rest only on the few
// pairs that pass; the tensor-core route 60 bf16 product operations and 13
// f32 of the screen a pair. Per ray 32 bytes are read and 17 written.
#include <cuda_runtime.h>

#include "bounce_fused_launch.cuh"
#include "brute.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;

constexpr int kTile = 128;     // triangles per shared-memory tile (CUDA-core route)
constexpr int kRow4 = TB_ROWS / 4;
constexpr int kRays = 2;       // rays a thread (CUDA-core route)
constexpr int kThreads = 128;  // threads a block (CUDA-core route)

// The screen counters' host copy: whether launches count (the counting
// instantiations run then).
int g_count_host = 0;

// Add the counts of a warp's threads (lane 0's atomics) to k1::g_screen:
// pairs, passed, accepted pairs the screen rejected.
__device__ __forceinline__ void add_counts(unsigned long long pairs, int passed, int missed) {
  unsigned long long p = pairs;
  for (int s = 16; s > 0; s >>= 1) p += __shfl_xor_sync(k1::kFull, p, s);
  const unsigned int ps = __reduce_add_sync(k1::kFull, (unsigned int)passed);
  const unsigned int ms = __reduce_add_sync(k1::kFull, (unsigned int)missed);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&k1::g_screen[k1::SC_PAIRS], p);
    atomicAdd(&k1::g_screen[k1::SC_PASSED], (unsigned long long)ps);
    if (ms) atomicAdd(&k1::g_screen[k1::SC_MISSED], (unsigned long long)ms);
  }
}

// Triangle j's row of the staged tile (CUDA-core route; four 16-byte
// shared-memory broadcasts) or of the table in device memory.
__device__ __forceinline__ void row_of(const float4* rows, int j, float (&r)[TB_ROWS]) {
#pragma unroll
  for (int k = 0; k < kRow4; ++k) {
    const float4 q = rows[j * kRow4 + k];
    r[4 * k] = q.x; r[4 * k + 1] = q.y; r[4 * k + 2] = q.z; r[4 * k + 3] = q.w;
  }
}

__device__ __forceinline__ void row_ldg(const float* table, int j, float (&r)[TB_ROWS]) {
  const float4* p = reinterpret_cast<const float4*>(table) + (size_t)j * kRow4;
#pragma unroll
  for (int k = 0; k < kRow4; ++k) {
    const float4 q = __ldg(p + k);
    r[4 * k] = q.x; r[4 * k + 1] = q.y; r[4 * k + 2] = q.z; r[4 * k + 3] = q.w;
  }
}

struct Ray {
  V3 o, d, x;
  float lo, hi;
};

struct Best {
  float t, u, v, det;
  int j;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ tmin,
                                        const float* __restrict__ tmax, int i, bool live) {
  Ray r;
  r.o = v3(0.0f, 0.0f, 0.0f);
  r.d = v3(0.0f, 0.0f, 1.0f);
  r.lo = 0.0f;
  r.hi = -1.0f;
  if (live) {
    r.o = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    r.d = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    r.lo = tmin[i];
    r.hi = tmax[i];
  }
  r.x = cross3(r.o, r.d);
  return r;
}

__device__ __forceinline__ void store_hit(const Best& b, float t_hi, int i,
                                          float* __restrict__ t_out, int* __restrict__ prim_out,
                                          float* __restrict__ uv_out,
                                          uint8_t* __restrict__ front_out) {
  const bool hit = b.j >= 0;
  t_out[i] = hit ? b.t : t_hi;
  prim_out[i] = b.j;
  uv_out[2 * i] = hit ? b.u : 0.0f;
  uv_out[2 * i + 1] = hit ? b.v : 0.0f;
  front_out[i] = (hit && b.det > 0.0f) ? 1 : 0;
}

// The CUDA-core route: kRays rays a thread (ray r of thread k of block b is
// (b kRays + r) kThreads + k, so each of the thread's loads is coalesced).
// kCount: the screen counters (and the exact test on every rejected pair).
// The passing pairs of each 32 triangles are marked in a mask and resolved
// after them, each lane walking its own bits, so that a warp runs the plain
// test as often as its busiest lane has passes (resolved where they pass,
// the warp ran it wherever any lane passed: 5-14% slower on the card).
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
brute_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin, const float* __restrict__ tmax,
                     const float4* __restrict__ table, float* __restrict__ t_out,
                     int* __restrict__ prim_out, float* __restrict__ uv_out,
                     uint8_t* __restrict__ front_out, int n, int n_tris) {
  __shared__ float4 tile[kTile * kRow4];
  Ray ray[kRays];
  Best best[kRays];
  int live_rays = 0;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = (blockIdx.x * kRays + r) * kThreads + threadIdx.x;
    ray[r] = load_ray(o, d, tmin, tmax, i, i < n);
    live_rays += i < n ? 1 : 0;
    best[r].t = INFINITY;
    best[r].u = best[r].v = best[r].det = 0.0f;
    best[r].j = -1;
  }
  // the plain test of pair (ray r, staged triangle j): the least (t, index)
  auto resolve = [&](int r, int j, const float (&row)[TB_ROWS]) {
    float t, u, v, det;
    if (brute_pair(row, ray[r].o, ray[r].d, ray[r].x, ray[r].lo, ray[r].hi, t, u, v, det) &&
        t < best[r].t) {
      best[r].t = t;
      best[r].u = u;
      best[r].v = v;
      best[r].det = det;
      best[r].j = j;
    }
  };
  int passed = 0, missed = 0;
  for (int base = 0; base < n_tris; base += kTile) {
    const int count = min(kTile, n_tris - base);
    __syncthreads();   // the previous tile is no longer read
    for (int k = threadIdx.x; k < count * kRow4; k += kThreads)
      tile[k] = table[(size_t)base * kRow4 + k];
    __syncthreads();
    for (int j0 = 0; j0 < count; j0 += 32) {
      uint32_t mask[kRays] = {};
#pragma unroll 2
      for (int jj = 0; jj < min(32, count - j0); ++jj) {
        float row[TB_ROWS];
        row_of(tile, j0 + jj, row);
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          // v's numerator only where det and u pass (a warp of coherent
          // rays mostly skips it), except while counting
          float det, un;
          brute_det_u(row, ray[r].d, ray[r].x, det, un);
          if (!kCount && !brute_screen_u(det, un)) continue;
          const float vn = brute_v(row, ray[r].d, ray[r].x);
          const bool pass = brute_screen(det, un, vn);
          mask[r] |= (uint32_t)pass << jj;
          if (kCount) {
            float t, u, v;
            passed += pass ? 1 : 0;
            missed += !pass && brute_accept(row, ray[r].o, det, un, vn, ray[r].lo, ray[r].hi,
                                            t, u, v) ? 1 : 0;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        uint32_t bits = mask[r];
        while (bits) {
          const int jj = __ffs(bits) - 1;
          bits &= bits - 1;
          float row[TB_ROWS];
          row_of(tile, j0 + jj, row);
          resolve(r, base + j0 + jj, row);
        }
      }
    }
  }
  if (kCount) add_counts((unsigned long long)live_rays * n_tris, passed, missed);
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = (blockIdx.x * kRays + r) * kThreads + threadIdx.x;
    if (i < n) store_hit(best[r], ray[r].hi, i, t_out, prim_out, uv_out, front_out);
  }
}

// The tensor-core route: K1's layout (bounce_fused_mma.cuh), 512-thread
// blocks, one batch of 32 consecutive rays a warp; the block stages the
// tile with cp.async. Each lane resolves its own ray's candidates of a
// group of 128 triangles (the quad's masks) with brute_pair and keeps the
// least (t, index).
template <bool kCount>
__global__ void __launch_bounds__(k1::kThreads)
brute_closest_kernel_mma(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmin, const float* __restrict__ tmax,
                 const float* __restrict__ table, const __nv_bfloat16* __restrict__ tile,
                 const float* __restrict__ scale, int t8, float* __restrict__ t_out,
                 int* __restrict__ prim_out, float* __restrict__ uv_out,
                 uint8_t* __restrict__ front_out, int n, int n_tris) {
  extern __shared__ __align__(16) unsigned char smem[];
  k1::stage_tile(smem, tile, scale, t8);
  const int i = blockIdx.x * k1::kThreads + threadIdx.x;
  const bool live = i < n;
  const Ray ray = load_ray(o, d, tmin, tmax, i, live);
  cl::cp_async_wait<0>();
  __syncthreads();
  if (__all_sync(k1::kFull, !live)) return;  // a warp past n, after the barrier
  const k1::Warp w = k1::warp_view(smem, t8);
  uint32_t a[2][2][4];
  float me[4];
  k1::operand(w, ray.d, ray.x, live, a, me);
  Best best;
  best.t = INFINITY;
  best.u = best.v = best.det = 0.0f;
  best.j = -1;
  int passed = 0, missed = 0;
  for (int ch0 = 0; ch0 < w.chunks; ch0 += k1::kGroup) {
    const int nc = min(k1::kGroup, w.chunks - ch0);
    uint32_t m[4], mine[4];
    k1::screen_group(w, a, me, ch0, nc, m);
    k1::own_masks(w.q, m, mine);
    const int j0 = 8 * ch0;
    if (kCount) {
      passed += k1::popc4(m);
      if (live)
        for (int j = j0; j < min(j0 + 8 * nc, n_tris); ++j) {
          const int b = 2 * ((j - j0) >> 3) + (j & 1);
          if ((k1::pick(mine, w.q ^ ((j >> 1) & 3)) >> b) & 1u) continue;
          float row[TB_ROWS], t, u, v, det;
          row_ldg(table, j, row);
          missed += brute_pair(row, ray.o, ray.d, ray.x, ray.lo, ray.hi, t, u, v, det) ? 1 : 0;
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t bits = mine[k];
      while (bits) {
        const int j = k1::tri_of(j0, w.q ^ k, __ffs(bits) - 1);
        bits &= bits - 1;
        if (j >= n_tris) continue;
        float row[TB_ROWS], t, u, v, det;
        row_ldg(table, j, row);
        if (!brute_pair(row, ray.o, ray.d, ray.x, ray.lo, ray.hi, t, u, v, det) ||
            !(t < best.t || (t == best.t && j < best.j)))
          continue;
        best.t = t;
        best.u = u;
        best.v = v;
        best.det = det;
        best.j = j;
      }
    }
  }
  if (kCount) add_counts(live ? (unsigned long long)n_tris : 0ull, passed, missed);
  if (live) store_hit(best, ray.hi, i, t_out, prim_out, uv_out, front_out);
}

template <bool kCount>
int launch(const float* o, const float* d, const float* tmin, const float* tmax,
           const float* table, const __nv_bfloat16* tile, const float* scale, int t8, float* t,
           int* prim, float* uv, uint8_t* front, int n, int n_tris, cudaStream_t stream) {
  if (tile != nullptr) {
    const cudaError_t e =
        allow_largest_tile(reinterpret_cast<const void*>(&brute_closest_kernel_mma<kCount>));
    if (e != cudaSuccess) return (int)e;
    brute_closest_kernel_mma<kCount>
        <<<(n + k1::kThreads - 1) / k1::kThreads, k1::kThreads, k1::smem_bytes(t8), stream>>>(
            o, d, tmin, tmax, table, tile, scale, t8, t, prim, uv, front, n, n_tris);
    return (int)cudaGetLastError();
  }
  const int per_block = kRays * kThreads;
  brute_closest_kernel<kCount><<<(n + per_block - 1) / per_block, kThreads, 0, stream>>>(
      o, d, tmin, tmax, reinterpret_cast<const float4*>(table), t, prim, uv, front, n, n_tris);
  return (int)cudaGetLastError();
}

}  // namespace

// `tile` ([30, t8] bf16) and `scale` ([t8] f32): the tensor-core route's
// coefficient tile of the table (accel/brute.py brute_tile), or NULL for
// the CUDA-core route.
extern "C" int rtxpt_brute_closest(const float* o, const float* d, const float* tmin,
                                   const float* tmax, const float* table, const void* tile,
                                   const float* scale, int t8, float* t, int* prim, float* uv,
                                   unsigned char* front, int n, int n_tris, void* stream) {
  const __nv_bfloat16* bt = static_cast<const __nv_bfloat16*>(tile);
  if (g_count_host)
    return launch<true>(o, d, tmin, tmax, table, bt, scale, t8, t, prim, uv, front, n, n_tris,
                        (cudaStream_t)stream);
  return launch<false>(o, d, tmin, tmax, table, bt, scale, t8, t, prim, uv, front, n, n_tris,
                       (cudaStream_t)stream);
}

// K8's screen counters (k1::g_screen's closest-hit slots: pairs, passed,
// and missed, the accepted pairs the screen rejected, which must stay 0):
// `out` (NULL or 6 host values) receives the counts since the last call,
// which zeroes them; `enable` sets whether later launches count.
// Synchronous.
extern "C" int rtxpt_brute_closest_screen_stats(int enable, unsigned long long* out) {
  g_count_host = enable;
  return rt::k1::screen_stats(enable, out);
}

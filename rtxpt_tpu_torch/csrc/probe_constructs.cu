// K12, the seven construct probes, written by hand for Hopper (sm_90a): one
// small kernel each.
//
// Replaces scripts/micro_constructs.py::kernel (inside BODY, launched there
// by pl.pallas_call at micro_constructs.py:84, one construct per process):
// the JAX package's bisection of the Mosaic constructs of its all-rows
// clustered kernel. Each construct is a function of x [16, 1024] and
// b [32, 512] (f32) to o [1, 1024]. Plain versions: rtxpt_tpu_torch/probes/
// micro_constructs.py construct_reference; wrapper: micro_constructs.run.
//
//   tile8          o[l] = 2 x[0, l % 128]
//   subl_concat    o[l] = sum_i x[i, l], i = 0..9, in i order
//   mm_concat_N    for the first N lanes: the 30-term split-bf16 product of
//                  b's rows 0..19 with x's rows 0..9 ([512, N], as K11),
//                  its maximum over the 512 columns, tiled to 1024 lanes
//   unflat         o[l] = sum_r x[0, r * 128 + l % 128], r = 0..7, in r order
//   scratch32      a [32, 1024] scratch filled with x[0] and doubled where
//                  x[0] > 0.5; o = its row 0
//   iota_sel       t_m = x[0] broadcast to [128, 1024]; the first row j
//                  whose t_m reaches the column minimum; the one-hot
//                  [27, 128] x [128, 1024] product of x[0, 0:128] broadcast
//                  to 27 rows with that selection; o = its maximum over the
//                  27 rows
//
// Each kernel keeps its construct's work: the mm_concat kernels form the
// whole [512, N] product and its maximum, iota_sel reads its broadcasts
// through a row stride the wrapper passes (0, a broadcast's stride), so that
// nothing folds at compile time, and scratch32 writes its scratch in device
// memory. Sums run in the order stated, a multiply then an add (-fmad=false),
// as the plain versions round; minimum and maximum propagate NaN.
//
// What bounds them: latency. Each reads at most 80 KB. tile8, subl_concat,
// unflat and scratch32 cost about a launch; mm_concat_N (512 x 30 dependent
// products per lane in N / 128 blocks) and iota_sel (27 x 128 one-hot terms
// per lane in 8 blocks) are one thread's chain of dependent operations on a
// card that is mostly idle. A probe keeps its construct's work, not a fast
// form of it.
#include <cuda_runtime.h>

#include "rt_error.cuh"

namespace {

constexpr int kLanes = 1024;
constexpr int kThreads = 128;
constexpr int kBCols = 512;
constexpr int kKc = 10;
constexpr int kRec = 2 * kKc;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float bf16_hi(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kThreads)
tile8_kernel(const float* __restrict__ x, float* __restrict__ o) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  o[l] = x[l % 128] * 2.0f;
}

__global__ void __launch_bounds__(kThreads)
subl_concat_kernel(const float* __restrict__ x, float* __restrict__ o) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  float s = x[l];
#pragma unroll
  for (int i = 1; i < 10; ++i) s = s + x[i * kLanes + l];
  o[l] = s;
}

// one thread per lane of the first n; block b stages rows 0..19 of b as one
// 20-float record per column
__global__ void __launch_bounds__(kThreads)
mm_concat_kernel(const float* __restrict__ x, const float* __restrict__ b,
                 float* __restrict__ o, int n) {
  __shared__ float4 tile[kBCols * kRec / 4];
  float* tl = reinterpret_cast<float*>(tile);
  for (int e = threadIdx.x; e < kRec * kBCols; e += kThreads) {
    const int k = e / kBCols, q = e % kBCols;
    tl[q * kRec + k] = b[e];
  }
  __syncthreads();
  const int l = blockIdx.x * kThreads + threadIdx.x;
  float rhi[kKc], rlo[kKc];
#pragma unroll
  for (int k = 0; k < kKc; ++k) {
    const float r = x[k * kLanes + l];
    rhi[k] = bf16_hi(r);
    rlo[k] = r - rhi[k];
  }
  float m = 0.0f;
  for (int q = 0; q < kBCols; ++q) {
    float rec[kRec];
#pragma unroll
    for (int k4 = 0; k4 < kRec / 4; ++k4) {
      const float4 w = tile[q * (kRec / 4) + k4];
      rec[4 * k4] = w.x;
      rec[4 * k4 + 1] = w.y;
      rec[4 * k4 + 2] = w.z;
      rec[4 * k4 + 3] = w.w;
    }
    float p = rec[0] * rhi[0];
#pragma unroll
    for (int k = 1; k < kKc; ++k) p = p + rec[k] * rhi[k];
#pragma unroll
    for (int k = 0; k < kKc; ++k) p = p + rec[k] * rlo[k];
#pragma unroll
    for (int k = 0; k < kKc; ++k) p = p + rec[kKc + k] * rhi[k];
    m = q == 0 ? p : nan_max(m, p);
  }
  for (int c = l; c < kLanes; c += n) o[c] = m;
}

// one thread per lane of the first 128, each writing its 8 copies
__global__ void __launch_bounds__(kThreads)
unflat_kernel(const float* __restrict__ x, float* __restrict__ o) {
  const int l = threadIdx.x;
  float s = x[l];
#pragma unroll
  for (int r = 1; r < 8; ++r) s = s + x[r * 128 + l];
#pragma unroll
  for (int r = 0; r < 8; ++r) o[r * 128 + l] = s;
}

__global__ void __launch_bounds__(kThreads)
scratch32_kernel(const float* __restrict__ x, float* scr, float* __restrict__ o) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const float x0 = x[l];
  for (int r = 0; r < 32; ++r) scr[r * kLanes + l] = 0.0f + x0;
  const bool dbl = x0 > 0.5f;
  for (int r = 0; r < 32; ++r) {
    const float v = scr[r * kLanes + l];
    scr[r * kLanes + l] = dbl ? v * 2.0f : v;
  }
  o[l] = scr[l];
}

// t_m[j, l] = x[j * t_stride + l], amat[a, j] = x[a * a_stride + j]: the
// broadcasts of x[0] and x[0, 0:128] at stride 0
__global__ void __launch_bounds__(kThreads)
iota_sel_kernel(const float* __restrict__ x, float* __restrict__ o, int t_stride,
                int a_stride) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  float t_c = x[l];
  for (int j = 1; j < 128; ++j) t_c = nan_min(t_c, x[j * t_stride + l]);
  int jrow = 128;
  for (int j = 0; j < 128; ++j)
    if (x[j * t_stride + l] <= t_c && j < jrow) jrow = j;
  float m = 0.0f;
  for (int a = 0; a < 27; ++a) {
    const float* row = x + a * a_stride;
    float p = row[0] * (jrow == 0 ? 1.0f : 0.0f);
    for (int j = 1; j < 128; ++j) p = p + row[j] * (jrow == j ? 1.0f : 0.0f);
    m = a == 0 ? p : nan_max(m, p);
  }
  o[l] = m;
}

}  // namespace

extern "C" int rtxpt_probe_tile8(const float* x, const float* b, float* o, void* stream) {
  (void)b;
  tile8_kernel<<<kLanes / kThreads, kThreads, 0, (cudaStream_t)stream>>>(x, o);
  return (int)cudaGetLastError();
}

extern "C" int rtxpt_probe_subl_concat(const float* x, const float* b, float* o,
                                       void* stream) {
  (void)b;
  subl_concat_kernel<<<kLanes / kThreads, kThreads, 0, (cudaStream_t)stream>>>(x, o);
  return (int)cudaGetLastError();
}

extern "C" int rtxpt_probe_mm_concat(const float* x, const float* b, float* o, int n,
                                     void* stream) {
  if (n <= 0 || n % kThreads != 0 || kLanes % n != 0) return (int)cudaErrorInvalidValue;
  mm_concat_kernel<<<n / kThreads, kThreads, 0, (cudaStream_t)stream>>>(x, b, o, n);
  return (int)cudaGetLastError();
}

extern "C" int rtxpt_probe_unflat(const float* x, const float* b, float* o, void* stream) {
  (void)b;
  unflat_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(x, o);
  return (int)cudaGetLastError();
}

extern "C" int rtxpt_probe_scratch32(const float* x, const float* b, float* scr, float* o,
                                     void* stream) {
  (void)b;
  scratch32_kernel<<<kLanes / kThreads, kThreads, 0, (cudaStream_t)stream>>>(x, scr, o);
  return (int)cudaGetLastError();
}

extern "C" int rtxpt_probe_iota_sel(const float* x, const float* b, float* o, int t_stride,
                                    int a_stride, void* stream) {
  (void)b;
  iota_sel_kernel<<<kLanes / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      x, o, t_stride, a_stride);
  return (int)cudaGetLastError();
}

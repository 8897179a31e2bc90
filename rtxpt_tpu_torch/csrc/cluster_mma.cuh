// The tensor-core form of the clustered tier's candidate tests, shared by K3
// (cluster_closest.cu, closest hit), K5 (cluster_shadow.cu, shadow any
// hit) and the per-row K6 and K7 (cluster_rows.cu): the cp.async ring that
// brings each slot's f32 rows into shared memory, the bf16 tile of the
// coefficient rows det, u and v read, the lane's stacked split-bf16 A row,
// the ldmatrix and mma.sync wrappers, the screen on the products and the
// exact read-back of the operand.
//
// The product form. The coefficients are bf16-exact (accel/cluster.py
// stores c_hi and c_lo = bf16(c - c_hi)) and so is r_hi = bf16(r). The f32
// residual r_lo = r - r_hi has at most 16 significant bits, so it splits
// exactly into l1 = bf16(r_lo) and l2 = r_lo - l1, both bf16. The four
// stacks A = [r_hi | l1 | l2 | r_hi] against B = [c_hi | c_hi | c_hi | c_lo]
// give every product of the plain version exactly; only the order and
// rounding of the f32 accumulation differ. The depth is ordered
// component-major, k = 4 * component + stack: det reads components 0-2
// (k-step 0), u and v 0-5 (k-steps 0-1), so a chunk of 8 triangles takes
// 5 m16n8k16 products for 16 rays. The t numerators (components 6-9) are
// not screened on: only the screened pairs need them, in exact f32.
//
// Layout. Each warp's 32 rays are two 16-row tiles of A; lane 4g + q writes
// its row to tile q / 2, row g + 8 (q % 2), so that each ray's results land
// in its own quad (the accumulator e of thread 4g + q holds ray row
// g + 8 (e / 2) of the tile and triangle 8 ch + 2q + e % 2). The stacked B
// rows are virtual: each ldmatrix row address picks its tile row, so c_hi
// is staged once and not three times.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace rt {
namespace cl {

constexpr int KQ = 48;                   // bf16 per A row (40 used)
constexpr int COEF_ROWS = 20;            // rows 0..9 c_hi, 10..19 c_lo
constexpr int TILE_COMPS = 6;            // components det, u and v read
constexpr int ZERO_ROW = 2 * TILE_COMPS; // the bf16 tile's zero row
constexpr int B_STRIDE = LANES + 8;      // bf16 per tile row
constexpr int CHUNKS = CT / 8;           // 8-triangle chunks of a cluster
constexpr int LIST = 8;                  // screened candidates a thread keeps per ray
constexpr int A_BYTES = FL * KQ * 2;
constexpr int B_BYTES = (ZERO_ROW + 1) * B_STRIDE * 2;
constexpr int LIST_BYTES = FL * 2 * LIST;

// One ring slot, in floats: the coefficient rows, the center (padded to
// 4), the micromap words, their coverages (COVER: K5), an instance's M10
// (padded to 104).
template <bool COVER>
struct Ring {
  static constexpr int CEN = COEF_ROWS * LANES;
  static constexpr int MW = CEN + 4;
  static constexpr int CV = MW + CT;
  static constexpr int XM = CV + (COVER ? CT : 0);
  static constexpr int FLOATS = XM + 104;
  static_assert(MW % 4 == 0 && CV % 4 == 0 && XM % 4 == 0 && FLOATS % 4 == 0,
                "16-byte alignment of the ring's regions");
};
static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0,
              "16-byte alignment of the shared-memory regions");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats (bf16-exact) as one bf16x2 word, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tile row of virtual row k of quantity `qn`'s stacked B (det 0, u 1,
// v 2): component k / 4, stack k % 4 (c_lo in stack 3, at tile row
// TILE_COMPS + component); the zero row where the quantity does not read
// the component (Q_ROWS of bounce_clustered.py).
__device__ __forceinline__ int tile_row(int qn, int k) {
  const int comp = k >> 2;
  if (comp >= (qn == 0 ? 3 : TILE_COMPS)) return ZERO_ROW;
  return (k & 3) == 3 ? TILE_COMPS + comp : comp;
}

// The screen on the tensor cores' det, u and v numerators: inside the edge
// margins widened to kScreen (4x), whatever t. Far wider than the
// difference between these sums and the plain version's (a few f32 ulps of
// the terms), so every candidate the plain version finds valid passes, and
// every strict any-hit occluder with it (the strict test lies inside the
// margins); a degenerate or padding triangle (|det| = 0) and a zero A row
// do not.
constexpr float kScreen = 4.0f * kMargin;

__device__ __forceinline__ bool screen(float det, float un, float vn) {
  const Quant q = signed_quant(det, un, vn, 0.0f);
  const float w = kScreen * q.absd;
  return q.absd > 0.0f && q.su >= -w && q.sv >= -w && q.su + q.sv <= q.absd + w + w;
}

// A ray's operand (hi, lo) read back from its A row: r_hi as is, and
// lo = l1 + l2, which is exact (make_operand's f32 residual).
__device__ __forceinline__ void operand_of_row(const __nv_bfloat16* row, float* hi,
                                               float* lo) {
  const uint2* w = reinterpret_cast<const uint2*>(row);
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const uint2 v = w[k];
    hi[k] = __uint_as_float(v.x << 16);
    lo[k] = __uint_as_float(v.x & 0xFFFF0000u) + __uint_as_float(v.y << 16);
  }
}

// The lane's A row (48 bf16, 6 uint4): per component [r_hi, l1, l2, r_hi]
// with l1 = bf16(r_lo), l2 = r_lo - l1, then 8 zeros.
__device__ __forceinline__ void write_a_row(uint4* arow, const float* hi,
                                            const float* lo) {
  uint32_t w[20];  // component k: [r_hi, l1] [l2, r_hi]
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const float l1 = bf16_round(lo[k]);
    w[2 * k] = pack_bf16(hi[k], l1);
    w[2 * k + 1] = pack_bf16(lo[k] - l1, hi[k]);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k)
    arow[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  arow[5] = make_uint4(0, 0, 0, 0);
}

// Convert the staged f32 rows det, u and v read (c_hi and c_lo of
// components 0-5) of ring slot `cur` to the bf16 tile `bt` (rows c_hi
// 0..5, then c_lo 0..5; row ZERO_ROW stays zero), thread `l` of NTH.
template <int NTH = FL>
__device__ __forceinline__ void convert_tile(__nv_bfloat16* bt, const float* cur,
                                             int l) {
  for (int k = l; k < 2 * TILE_COMPS * LANES / 4; k += NTH) {
    const int row = k >> 7;  // tile row: c_hi 0..5, then c_lo 0..5
    const int src = row < TILE_COMPS ? row : row - TILE_COMPS + 10;
    const float4 v = reinterpret_cast<const float4*>(cur + src * LANES)[k & 127];
    *reinterpret_cast<uint2*>(bt + row * B_STRIDE + (k & 127) * 4) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The ldmatrix row addresses of a warp's tiles and of the B tile's rows:
// the A rows of this thread's matrix slot, and each quantity's B rows (u
// and v share theirs, 128 columns apart).
struct Frag {
  uint32_t a, det, u;
};

__device__ __forceinline__ Frag frag_addrs(const __nv_bfloat16* at,
                                           const __nv_bfloat16* bt, int warp,
                                           int lane) {
  const int mslot = lane >> 3, mr = lane & 7;
  Frag f;
  f.a = smem_u32(at + (size_t)(warp * 32 + mr + 8 * (mslot & 1)) * KQ + 8 * (mslot >> 1));
  f.det = smem_u32(bt + tile_row(0, lane & 15) * B_STRIDE + 0 * CT);
  f.u = smem_u32(bt + tile_row(1, lane) * B_STRIDE + 1 * CT);
  return f;
}

// The products and the screen of one 16-ray tile `mt` of a warp: A
// fragments by ldmatrix from `a_addr`, per chunk of 8
// triangles B fragments by ldmatrix.trans and 5 mma.sync; a triangle that
// passes `screen` joins the thread's list for its ray r (accumulators
// e / 2 == r), in increasing triangle order, and cnt[r] counts them all
// (past LIST the list keeps its first LIST).
__device__ __forceinline__ void screen_tile(uint32_t a_addr, uint32_t b_det,
                                            uint32_t b_u, int mt, int q,
                                            uint8_t* list, int (&cnt)[2]) {
  const uint32_t b_v = b_u + CT * 2;
  uint32_t a[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) ldsm_x4(a[ks], a_addr + (mt * 16 * KQ + ks * 16) * 2);
  cnt[0] = cnt[1] = 0;
#pragma unroll 1
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const uint32_t off = ch * 16;  // 8 bf16 columns
    uint32_t bd[2], bu[4], bv[4];
    ldsm_x2_t(bd, b_det + off);
    ldsm_x4_t(bu, b_u + off);
    ldsm_x4_t(bv, b_v + off);
    float qd[4] = {0.0f, 0.0f, 0.0f, 0.0f}, qu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float qv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(qd, a[0], bd[0], bd[1]);
    mma_bf16(qu, a[0], bu[0], bu[1]);
    mma_bf16(qu, a[1], bu[2], bu[3]);
    mma_bf16(qv, a[0], bv[0], bv[1]);
    mma_bf16(qv, a[1], bv[2], bv[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (screen(qd[e], qu[e], qv[e])) {
        const int r = e >> 1;
        if (cnt[r] < LIST) list[r * LIST + cnt[r]] = (uint8_t)(ch * 8 + 2 * q + (e & 1));
        ++cnt[r];
      }
    }
  }
}

// Triangle c of a thread's screened candidates for one ray: its list's
// entry c, or, when the list overflowed (cnt > LIST), the thread's c-th
// triangle of all 32 it holds (thread q of a quad holds the j with
// (j >> 1) & 3 == q). `listed_count` gives how many there are.
__device__ __forceinline__ int listed_count(int cnt) { return cnt <= LIST ? cnt : CT / 4; }
__device__ __forceinline__ int listed(const uint8_t* list, int cnt, int c, int q) {
  return cnt <= LIST ? (int)list[c] : (c >> 1) * 8 + 2 * q + (c & 1);
}

// Issue the cp.async copies of slot data into one ring slot: rows 0..19 of
// cluster `cid`'s block, its center, its micromap words (OMM) and their
// coverages (OMM and COVER) or instance `iid`'s M10 (INST), thread `l` of
// NTH (at least 128). The caller commits.
template <bool INST, bool OMM, bool COVER, int NTH = FL>
__device__ __forceinline__ void stage_async(float* slot, const float* blocks,
                                            const int* micro, const float* cover,
                                            const float* xf, int cid, int iid, int l) {
  using RG = Ring<COVER>;
  const float* src = blocks + (size_t)cid * BLK_FLOATS;
  for (int k = l; k < COEF_ROWS * LANES / 4; k += NTH)
    cp_async16(slot + 4 * k, src + 4 * k);
  if (l < 3) cp_async4(slot + RG::CEN + l, src + CENTER_ROW * LANES + l * CT);
  if constexpr (OMM) {
    if (l >= 32 && l < 32 + CT / 4)
      cp_async16(slot + RG::MW + 4 * (l - 32), micro + (size_t)cid * CT + 4 * (l - 32));
    if constexpr (COVER) {
      if (l >= 96 && l < 96 + CT / 4)
        cp_async16(slot + RG::CV + 4 * (l - 96), cover + (size_t)cid * CT + 4 * (l - 96));
    }
  }
  if constexpr (INST) {
    if (l >= 64 && l < 64 + XF_FLOATS / 4)
      cp_async16(slot + RG::XM + 4 * (l - 64), xf + (size_t)iid * XF_FLOATS + 4 * (l - 64));
  }
}

}  // namespace cl
}  // namespace rt

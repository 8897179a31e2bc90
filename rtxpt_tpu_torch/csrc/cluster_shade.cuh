// K4's per-lane body (cluster_shade.cu), whose shading half K6
// (cluster_rows.cu) shares (shade_hit): surface_and_shade (bounce_fused.cuh)
// on K3's HA rows, with the attribute fetch reading those rows; writes the
// next state, the SH shadow request rows and the hit rows of lane i, and in
// the external modes the SF_* rows (`surf_out`) and the shading flag. HasOmm:
// K3's HA_UNK feeds the alpha test and SH_UA carries the alpha uniform.
// HasPrio: the priority false-hit pass-through of surface_and_shade.
// HasSplit: the split rows fs2 in and out, and the NEE contribution's
// diffuse part in SH_CDIFF (K6 runs without it). The plain version is
// rtxpt_tpu_torch/pt/bounce_clustered.py shade_reference. K4 reads its
// lane's input rows from the block's shared-memory stage (StagePlan,
// shade_staged); K6 reads its hit from its winner's cluster block.
#pragma once

#include "bounce_fused.cuh"
#include "cluster.cuh"

namespace rt {
namespace cl {

// The shading of lane i on its closest hit h (prim: the hit row's prim id,
// -1 on a miss; A(r): the hit's attribute row r, AT_* order), from the ray
// state s: K4 reads both from K3's HA rows (shade_staged), K6 from its
// winner's cluster block (cluster_rows.cu). Writes the next state, the SH
// rows, the hit rows and, in the external modes, the SF_* rows
// (`surf_out`) and the shading flag; the final environment round
// (cfg.final_env) closes the path. HasSplit: `sp` holds the lane's split
// channels, written to fs2_out ([NF2, n]); its NEE diffuse part goes to
// SH_CDIFF, which trace_paths_clustered merges after K5 (zero without the
// split).
template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit, class AttrFetch>
RT_HD void shade_hit(int i, int n, RayState s, const Hit& h, float prim,
                     const AttrFetch& attr, float* __restrict__ fs_out,
                     int* __restrict__ is_out, float* __restrict__ sh_out,
                     float* __restrict__ hit_out, float* __restrict__ surf_out,
                     const Tables& tb, const Config& cfg, Split* sp = nullptr,
                     float* __restrict__ fs2_out = nullptr) {
  const int lb_in = s.lb;
  float* so = sh_out + i;
  float* ho = hit_out + i;
  const size_t sn = (size_t)n;
  ho[0] = h.t < kBig ? h.t : 0.0f;
  ho[sn] = prim;
  ho[2 * sn] = h.u;
  ho[3 * sn] = h.v;
  ho[4 * sn] = h.det > 0.0f ? 1.0f : 0.0f;
  if (cfg.final_env) {
    final_env_state<HasSplit>(s, h.t < kBig, tb, cfg, (1 << 1) | (1 << 2), sp);
    store_state(i, n, s, fs_out, is_out);
    if constexpr (HasSplit) store_split(i, n, *sp, fs2_out);
    for (int r = 0; r < SH_ROWS; ++r) so[r * sn] = 0.0f;
    ho[5 * sn] = 0.0f;
    return;
  }
  SurfRows sf;
  const ShadowRay sr = surface_and_shade<HasTex, HasOmm, HasPrio, HasSplit>(
      s, h, attr, tb, cfg, surf_out != nullptr ? &sf : nullptr, sp);
  store_state(i, n, s, fs_out, is_out);
  if constexpr (HasSplit) store_split(i, n, *sp, fs2_out);
  so[(SH_O + 0) * sn] = sr.o.x; so[(SH_O + 1) * sn] = sr.o.y; so[(SH_O + 2) * sn] = sr.o.z;
  so[(SH_D + 0) * sn] = sr.d.x; so[(SH_D + 1) * sn] = sr.d.y; so[(SH_D + 2) * sn] = sr.d.z;
  so[SH_DIST * sn] = sr.dist;
  so[(SH_CONTRIB + 0) * sn] = sr.contrib.x;
  so[(SH_CONTRIB + 1) * sn] = sr.contrib.y;
  so[(SH_CONTRIB + 2) * sn] = sr.contrib.z;
  so[SH_DO * sn] = sr.do_nee ? 1.0f : 0.0f;
  if constexpr (HasSplit) {
    so[(SH_CDIFF + 0) * sn] = sp->cdiff.x;
    so[(SH_CDIFF + 1) * sn] = sp->cdiff.y;
    so[(SH_CDIFF + 2) * sn] = sp->cdiff.z;
  } else {
    for (int r = SH_CDIFF; r < SH_UA; ++r) so[r * sn] = 0.0f;
  }
  so[SH_UA * sn] = sr.u_alpha;         // 0 without micromaps
  if (surf_out != nullptr) {
    store_surf(i, n, sf, surf_out);
    ho[5 * sn] = sf.shaded ? (lb_in > 0 ? 2.0f : 1.0f) : 0.0f;
  } else {
    ho[5 * sn] = sr.do_nee ? 1.0f : 0.0f;
  }
}

// K4's staging plan: the input rows a variant reads, one shared-memory slot
// of kStageLanes floats each (bounce_clustered.shade_stage_rows is its
// Python mirror). Slots in order: the HA rows kHaBase (hit, the attribute
// rows every lane reads, AT_LID of the export), kHaTex (HasTex: UVs, LOD
// bias, tangent), kHaOmm (HasOmm: the UNKNOWN flag), then the NF state
// rows FS_*, the NI rows IS_* and (HasSplit) the NF2 rows F2_*. HA_INST is
// read by no variant. A launch copies only the slots its mode reads
// (copy_mask): final_env the hit rows and the state, AT_LID only with the
// export.
constexpr int kStageLanes = 128;                 // lanes of a stage (a block)
constexpr int kHaHit = 5;                        // HA_T .. HA_PRIM
constexpr int kHaBaseN = 22, kHaTexN = 11;
constexpr int kSlotLid = kHaBaseN - 1;           // the slot of AT_LID
constexpr int kHaBase[kHaBaseN] = {
    HA_T, HA_U, HA_V, HA_FRONT, HA_PRIM, HA_ATTR + AT_N0, HA_ATTR + AT_N0 + 1,
    HA_ATTR + AT_N0 + 2, HA_ATTR + AT_N1, HA_ATTR + AT_N1 + 1, HA_ATTR + AT_N1 + 2,
    HA_ATTR + AT_N2, HA_ATTR + AT_N2 + 1, HA_ATTR + AT_N2 + 2, HA_ATTR + AT_GN,
    HA_ATTR + AT_GN + 1, HA_ATTR + AT_GN + 2, HA_ATTR + AT_MID, HA_ATTR + AT_LPDF,
    HA_ATTR + AT_LAREA, HA_ATTR + AT_ISLIGHT, HA_ATTR + AT_LID};
constexpr int kHaTex[kHaTexN] = {
    HA_ATTR + AT_UV0, HA_ATTR + AT_UV0 + 1, HA_ATTR + AT_UV1, HA_ATTR + AT_UV1 + 1,
    HA_ATTR + AT_UV2, HA_ATTR + AT_UV2 + 1, HA_ATTR + AT_LODB, HA_ATTR + AT_TANG,
    HA_ATTR + AT_TANG + 1, HA_ATTR + AT_TANG + 2, HA_ATTR + AT_TSGN};

#ifdef __CUDACC__
#define RT_HDC __host__ __device__ constexpr
#else
#define RT_HDC constexpr
#endif

template <bool HasTex, bool HasOmm, bool HasSplit>
struct StagePlan {
  static constexpr int kHa = kHaBaseN + (HasTex ? kHaTexN : 0) + (HasOmm ? 1 : 0);
  static constexpr int kFs = kHa;                // first slot of the FS_* rows
  static constexpr int kIs = kFs + NF;
  static constexpr int kF2 = kIs + NI;
  static constexpr int kSlots = kF2 + (HasSplit ? NF2 : 0);
  static constexpr int kBytes = kSlots * kStageLanes * 4;   // a stage

  // The slot of HA row r (-1: not staged), kHaBase's and kHaTex's order in
  // arithmetic (the arrays are the plan's statement; static_assert below).
  // It folds to a constant where r is one.
  RT_HDC static int slot_of_ha(int r) {
    const int a = r - HA_ATTR;
    if (r >= HA_T && r <= HA_PRIM) return r;
    if (a >= AT_N0 && a <= AT_ISLIGHT) return kHaHit + a;
    if (a == AT_LID) return kSlotLid;
    if (HasTex && a >= AT_UV0 && a <= AT_LODB) return kHaBaseN + (a - AT_UV0);
    if (HasTex && a >= AT_TANG && a <= AT_TSGN) return kHaBaseN + 7 + (a - AT_TANG);
    if (HasOmm && r == HA_UNK) return kHa - 1;
    return -1;
  }

  // The global row of slot k: its array (0 ha, 1 fs, 2 is, 3 fs2) and row.
  RT_HDC static int array_of(int k) {
    return k < kFs ? 0 : (k < kIs ? 1 : (k < kF2 ? 2 : 3));
  }
  RT_HDC static int row_of(int k) {
    return k < kSlotLid ? (k < kHaHit ? k : HA_ATTR + (k - kHaHit))
         : k == kSlotLid ? HA_ATTR + AT_LID
         : k < kHaBaseN + (HasTex ? 7 : 0) ? HA_ATTR + AT_UV0 + (k - kHaBaseN)
         : k < kHaBaseN + (HasTex ? kHaTexN : 0) ? HA_ATTR + AT_TANG + (k - kHaBaseN - 7)
         : k < kFs ? HA_UNK
         : k < kIs ? k - kFs
         : k < kF2 ? k - kIs : k - kF2;
  }

  // Whether a launch copies slot k: final_env reads the hit rows and the
  // state, the other modes every slot but AT_LID without the export.
  RT_HDC static bool copies(int k, bool final_env, bool exports) {
    return k >= kHa || (final_env ? k < kHaHit : (exports || k != kSlotLid));
  }

  // slot_of_ha and row_of against the arrays, slot by slot
  static constexpr bool consistent() {
    for (int k = 0; k < kHaBaseN; ++k)
      if (row_of(k) != kHaBase[k] || slot_of_ha(kHaBase[k]) != k) return false;
    for (int k = 0; HasTex && k < kHaTexN; ++k)
      if (row_of(kHaBaseN + k) != kHaTex[k] || slot_of_ha(kHaTex[k]) != kHaBaseN + k)
        return false;
    for (int k = 0; k < kHa; ++k)
      if (slot_of_ha(row_of(k)) != k) return false;
    return true;
  }
};
static_assert(StagePlan<false, false, false>::consistent(), "K4's staging plan");
static_assert(StagePlan<true, true, true>::consistent(), "K4's staging plan");
static_assert(StagePlan<true, false, false>::consistent(), "K4's staging plan");
static_assert(StagePlan<false, true, false>::consistent(), "K4's staging plan");

// Lane `lane` of the stage `st` (kSlots x kStageLanes floats, StagePlan's
// slots), global lane i of n: K4's body on the staged rows. The outputs go
// to device memory as in shade_hit.
template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
RT_HD void shade_staged(int i, int n, int lane, const float* __restrict__ st,
                        float* __restrict__ fs_out, int* __restrict__ is_out,
                        float* __restrict__ sh_out, float* __restrict__ hit_out,
                        float* __restrict__ surf_out, float* __restrict__ fs2_out,
                        const Tables& tb, const Config& cfg) {
  using P = StagePlan<HasTex, HasOmm, HasSplit>;
  auto H = [&](int r) { return st[P::slot_of_ha(r) * kStageLanes + lane]; };
  Hit h;
  h.t = H(HA_T);
  h.u = H(HA_U);
  h.v = H(HA_V);
  h.det = H(HA_FRONT);
  h.prim = -1;                       // surface_and_shade reads it only via A
  h.unk = HasOmm && H(HA_UNK) > 0.5f;
  auto attr = [&](int r) { return H(HA_ATTR + r); };
  Split sp;
  if constexpr (HasSplit) sp = load_split(lane, kStageLanes, st + P::kF2 * kStageLanes);
  const RayState s = load_state(lane, kStageLanes, st + P::kFs * kStageLanes,
                                reinterpret_cast<const int*>(st + P::kIs * kStageLanes));
  shade_hit<HasTex, HasOmm, HasPrio, HasSplit>(i, n, s, h, H(HA_PRIM), attr, fs_out, is_out,
                                               sh_out, hit_out, surf_out, tb, cfg, &sp,
                                               fs2_out);
}

}  // namespace cl
}  // namespace rt

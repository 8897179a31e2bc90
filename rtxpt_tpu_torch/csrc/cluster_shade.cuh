// K4's per-lane body (cluster_shade.cu), whose shading half K6
// (cluster_rows.cu) shares (shade_hit): surface_and_shade (bounce_fused.cuh)
// on K3's HA rows, with the attribute fetch reading those rows; writes the
// next state, the SH shadow request rows and the hit rows of lane i, and in
// the external modes the SF_* rows (`surf_out`) and the shading flag. HasOmm:
// K3's HA_UNK feeds the alpha test and SH_UA carries the alpha uniform.
// HasPrio: the priority false-hit pass-through of surface_and_shade.
// HasSplit: the split rows fs2 in and out, and the NEE contribution's
// diffuse part in SH_CDIFF (K6 runs without it). The plain version is
// rtxpt_tpu_torch/pt/bounce_clustered.py shade_reference.
#pragma once

#include "bounce_fused.cuh"
#include "cluster.cuh"

namespace rt {
namespace cl {

// The shading of lane i on its closest hit h (prim: the hit row's prim id,
// -1 on a miss; A(r): the hit's attribute row r, AT_* order), from the ray
// state s: K4 reads both from K3's HA rows (shade_lane), K6 from its
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

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
RT_HD void shade_lane(int i, int n, const float* __restrict__ ha,
                      const float* __restrict__ fs, const int* __restrict__ is,
                      const float* __restrict__ fs2, float* __restrict__ fs_out,
                      int* __restrict__ is_out, float* __restrict__ sh_out,
                      float* __restrict__ hit_out, float* __restrict__ surf_out,
                      float* __restrict__ fs2_out, const Tables& tb,
                      const Config& cfg) {
  auto H = [&](int r) { return ha[(size_t)r * n + i]; };
  Hit h;
  h.t = H(HA_T);
  h.u = H(HA_U);
  h.v = H(HA_V);
  h.det = H(HA_FRONT);
  h.prim = -1;                       // surface_and_shade reads it only via A
  h.unk = HasOmm && H(HA_UNK) > 0.5f;
  auto attr = [&](int r) { return H(HA_ATTR + r); };
  Split sp;
  if constexpr (HasSplit) sp = load_split(i, n, fs2);
  shade_hit<HasTex, HasOmm, HasPrio, HasSplit>(i, n, load_state(i, n, fs, is), h,
                                               H(HA_PRIM), attr, fs_out, is_out, sh_out,
                                               hit_out, surf_out, tb, cfg, &sp, fs2_out);
}

}  // namespace cl
}  // namespace rt

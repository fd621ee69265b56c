// Device functions of kernel B3, the dense feasibility tables: one table
// cell from the full requirement join of its rows, with no live-pair
// index. csrc/dense_feasibility.cu launches them over whole tables; a
// scan that builds one group's table row per step (the tiled mode of
// karpenter_tpu/ops/packing.py:_tile_rows, one B3 row per group) can call
// them on its own rows.
//
// Rows are byte masks as torch.bool stores them: def/neg [K], mask
// [K, V1]. Every function is exact against its plain PyTorch version in
// ops/feasibility.py (boolean algebra, and common.cuh's bit-exact
// fits_count).
#pragma once

#include "common.cuh"

namespace kt {

// Requirements.Compatible of a pod row g against a template row p, with
// the well-known allowance (requirements.go:177-196): every key K passes
// the intersect term (overlapping values, both negated, or not defined on
// both sides) and the custom-label term (a positively constrained key is
// well known or defined template-side). well_known == nullptr is the
// strict direction (no allowance).
__device__ __forceinline__ bool dense_compatible(
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_mask,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const uint8_t* well_known, int K, int V1) {
  for (int k = 0; k < K; ++k) {
    const bool pdef = p_def[k], gdef = g_def[k];
    const bool pneg = p_neg != nullptr && p_neg[k];
    const bool gneg = g_neg[k];
    const bool wk = well_known != nullptr && well_known[k];
    if (!(!gdef || wk || pdef || gneg)) return false;
    bool overlap = false;
    const uint8_t* pm = p_mask + static_cast<size_t>(k) * V1;
    const uint8_t* gm = g_mask + static_cast<size_t>(k) * V1;
    for (int v = 0; v < V1 && !overlap; ++v) overlap = pm[v] && gm[v];
    if (!(overlap || (pneg && gneg) || !(pdef && gdef))) return false;
  }
  return true;
}

// Requirements.Intersects of type row t against the claim p ∪ g
// (merge_requirements: masks AND, defined OR). A type's requirements are
// never negated, so the double-negation exemption never applies.
__device__ __forceinline__ bool dense_type_compat(
    const uint8_t* t_def, const uint8_t* t_mask,
    const uint8_t* p_def, const uint8_t* p_mask,
    const uint8_t* g_def, const uint8_t* g_mask, int K, int V1) {
  for (int k = 0; k < K; ++k) {
    const size_t row = static_cast<size_t>(k) * V1;
    bool overlap = false;
    for (int v = 0; v < V1 && !overlap; ++v)
      overlap = t_mask[row + v] && p_mask[row + v] && g_mask[row + v];
    if (!(overlap || !(t_def[k] && (p_def[k] || g_def[k])))) return false;
  }
  return true;
}

// offering_ok of type t's offerings against the claim p ∪ g: any
// available offering whose zone and capacity-type values the merged masks
// admit (a negative id admits any value). pz/pc/gz/gc are the [V1] zone
// and capacity-type mask rows of template and group.
__device__ __forceinline__ bool dense_offering_ok(
    const uint8_t* pz, const uint8_t* pc, const uint8_t* gz, const uint8_t* gc,
    const uint8_t* o_avail, const int32_t* o_zone, const int32_t* o_ct, int O) {
  for (int o = 0; o < O; ++o) {
    if (!o_avail[o]) continue;
    const int32_t z = o_zone[o], c = o_ct[o];
    const int zi = max(z, 0), ci = max(c, 0);
    const bool z_ok = (z < 0) || (pz[zi] && gz[zi]);
    const bool c_ok = (c < 0) || (pc[ci] && gc[ci]);
    if (z_ok && c_ok) return true;
  }
  return false;
}

}  // namespace kt

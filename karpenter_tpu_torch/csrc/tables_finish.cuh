// The finish of the feasibility tables, shared by kernel B1
// (fresh_feasibility.cu), kernel B2 (existing_feasibility.cu) and the
// solver mesh's fold (mesh_fold.cu), so that the single-device tables and
// the folded ones cannot drift apart. Each takes a cell's summed int32
// failure counts (wrapping sums, exact in any order) and its other parts.
#pragma once

#include "common.cuh"

namespace kt {

// a (template, group) pair: the template tolerates the group and no live
// pair failed its compatibility test
__device__ __forceinline__ bool compat_of(bool tol, int32_t cfail) { return tol && cfail == 0; }

// a (template, group, type) cell's keys: the base and the live pairs'
// corrections sum to no failure
__device__ __forceinline__ bool keys_pass(int32_t fails) { return fails == 0; }

// a cell's type-only part: a pod fits at least once, the template admits
// the type, and an offering is available to the merged zone and
// capacity-type masks
__device__ __forceinline__ bool type_only(int32_t nf, bool tok, bool off) {
  return nf >= 1 && tok && off;
}

// a finished fresh cell
__device__ __forceinline__ bool fresh_cell(bool compat, int32_t fails, bool tonly) {
  return compat && keys_pass(fails) && tonly;
}

// an existing node's room for a group: its fits where no live pair failed
// and the node tolerates the group, else 0
__device__ __forceinline__ int32_t node_cap(int32_t nfail, bool tol, int32_t cap) {
  return nfail == 0 && tol ? cap : 0;
}

}  // namespace kt

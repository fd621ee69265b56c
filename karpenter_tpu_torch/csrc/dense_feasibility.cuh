// Device functions of kernel B3, the dense feasibility tables: one table
// cell from the full requirement join of its rows, with no live-pair
// index. csrc/dense_feasibility.cu launches them over whole tables, the
// scans' tiled mode (pack_common.cuh:tile_rows) over one group's row per
// step.
//
// Rows are bit words: def/neg stay byte masks [K] as torch.bool stores
// them, and each key's value mask [V1] is W = ceil(V1 / 32) words, built
// from the byte masks by mask_words before the cells run (bits past V1
// are 0 in every row). A key's overlap is then W word ANDs rather than a
// walk over V1 bytes. Every function is exact against its plain PyTorch
// version in ops/feasibility.py (boolean algebra, and common.cuh's
// bit-exact fits_count).
#pragma once

#include "common.cuh"

namespace kt {

// word w of a [V1] byte mask row: bit c is value slot 32 w + c
__device__ __forceinline__ uint32_t mask_word(const uint8_t* row, int V1, int w) {
  uint32_t bits = 0;
  for (int c = 0; c < 32 && w * 32 + c < V1; ++c)
    bits |= static_cast<uint32_t>(row[w * 32 + c] != 0) << c;
  return bits;
}

// mask_word through 4-byte loads, all issued at once (global or shared
// memory): ``row`` 4-byte aligned and V1 % 4 == 0 (the caller checks)
__device__ __forceinline__ uint32_t mask_word_x4(const uint8_t* row, int V1, int w) {
  const uint32_t* r = reinterpret_cast<const uint32_t*>(row) + w * 8;
  const int n = (V1 - 32 * w) >> 2;
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c < n) {
      const uint32_t x = r[c];
      bits |= (static_cast<uint32_t>((x & 0xffu) != 0) |
               static_cast<uint32_t>((x & 0xff00u) != 0) << 1 |
               static_cast<uint32_t>((x & 0xff0000u) != 0) << 2 |
               static_cast<uint32_t>((x & 0xff000000u) != 0) << 3) << (4 * c);
    }
  }
  return bits;
}

// word w of a byte mask row, by mask_word_x4 where ``x4`` says it may
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, int V1, int w, bool x4) {
  return x4 ? mask_word_x4(row, V1, w) : mask_word(row, V1, w);
}

// 16 bytes of a byte mask as 16 bits (bit i: byte i nonzero)
__device__ __forceinline__ uint32_t bits16(uint4 q) {
  auto nib = [](uint32_t x) { return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24; };
  return nib(q.x) | nib(q.y) << 4 | nib(q.z) << 8 | nib(q.w) << 12;
}

// word w of a [V1] byte mask row (mask_word), as two 16-byte loads
// where ``x16`` says it may: the row 16-byte aligned and V1 % 32 == 0
__device__ __forceinline__ uint32_t row_word16(const uint8_t* row, int V1, int w, bool x16) {
  if (!x16) return mask_word(row, V1, w);
  const uint4* p = reinterpret_cast<const uint4*>(row + 32 * static_cast<size_t>(w));
  const uint4 a = p[0], b = p[1];
  return bits16(a) | bits16(b) << 16;
}

// may rows of ``base`` [., V1] take row_word16's 16-byte loads
__device__ __forceinline__ bool rows_x16(const void* base, int V1) {
  return (V1 & 31) == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

// The W words of one [V1] byte mask row read straight from memory, for a
// caller with no room to keep them: word w is row_word(row, V1, w, x4),
// and it indexes, offsets and tests bits like a word array.
struct RowWords {
  const uint8_t* row;
  int V1;
  bool x4;
  __device__ __forceinline__ uint32_t operator[](int w) const { return row_word(row, V1, w, x4); }
};

__device__ __forceinline__ bool bit(const uint32_t* words, int v) {
  return (words[v >> 5] >> (v & 31)) & 1u;
}

__device__ __forceinline__ bool bit(const RowWords& r, int v) { return r.row[v] != 0; }

// the words of ``rows`` [., V1] byte mask rows into ``out`` [rows, W],
// word i taken by thread i0 + k * step
__device__ __forceinline__ void mask_words(const uint8_t* mask, long long rows, int V1, int W,
                                           uint32_t* out, long long i0, long long step) {
  for (long long i = i0; i < rows * W; i += step)
    out[i] = mask_word(mask + (i / W) * V1, V1, static_cast<int>(i % W));
}

// some value slot set in every row of one key: (a & b (& c)).any(-1);
// each of a, b, c a word array or RowWords
template <class A, class B>
__device__ __forceinline__ bool words_meet(const A& a, const B& b, int W) {
  for (int w = 0; w < W; ++w)
    if (a[w] & b[w]) return true;
  return false;
}

template <class A, class B, class C>
__device__ __forceinline__ bool words_meet3(const A& a, const B& b, const C& c, int W) {
  for (int w = 0; w < W; ++w)
    if (a[w] & b[w] & c[w]) return true;
  return false;
}

// Requirements.Compatible of a pod row g against a template row p, with
// the well-known allowance (requirements.go:177-196): every key K passes
// the intersect term (overlapping values, both negated, or not defined on
// both sides) and the custom-label term (a positively constrained key is
// well known or defined template-side). p_neg == nullptr and well_known
// == nullptr is the strict direction of existing nodes (a node's labels
// are never negated and get no allowance). ``meet(k)``: whether key k's
// masks of the two sides share a value slot.
template <class Meet>
__device__ __forceinline__ bool compatible_by(const uint8_t* p_def, const uint8_t* p_neg,
                                              const uint8_t* g_def, const uint8_t* g_neg,
                                              const uint8_t* well_known, int K, const Meet& meet) {
  for (int k = 0; k < K; ++k) {
    const bool pdef = p_def[k], gdef = g_def[k];
    const bool pneg = p_neg != nullptr && p_neg[k];
    const bool gneg = g_neg[k];
    const bool wk = well_known != nullptr && well_known[k];
    if (!(!gdef || wk || pdef || gneg)) return false;
    if (!(pneg && gneg) && pdef && gdef && !meet(k)) return false;
  }
  return true;
}

// compatible_by over [K, W] word rows p_w / g_w
__device__ __forceinline__ bool dense_compatible(
    const uint8_t* p_def, const uint8_t* p_neg, const uint32_t* p_w,
    const uint8_t* g_def, const uint8_t* g_neg, const uint32_t* g_w,
    const uint8_t* well_known, int K, int W) {
  return compatible_by(p_def, p_neg, g_def, g_neg, well_known, K,
                       [&](int k) { return words_meet(p_w + k * W, g_w + k * W, W); });
}

// Requirements.Intersects of type row t against the claim p ∪ g
// (merge_requirements: masks AND, defined OR). A type's requirements are
// never negated, so the double-negation exemption never applies.
// ``meet(k)``: whether key k's masks of t, p and g share a value slot.
template <class Meet>
__device__ __forceinline__ bool type_compat_by(const uint8_t* t_def, const uint8_t* p_def,
                                               const uint8_t* g_def, int K, const Meet& meet) {
  for (int k = 0; k < K; ++k) {
    if (!(t_def[k] && (p_def[k] || g_def[k]))) continue;
    if (!meet(k)) return false;
  }
  return true;
}

// type_compat_by over [K, W] word rows
__device__ __forceinline__ bool dense_type_compat(
    const uint8_t* t_def, const uint32_t* t_w, const uint8_t* p_def, const uint32_t* p_w,
    const uint8_t* g_def, const uint32_t* g_w, int K, int W) {
  return type_compat_by(t_def, p_def, g_def, K, [&](int k) {
    return words_meet3(t_w + k * W, p_w + k * W, g_w + k * W, W);
  });
}

// offering_ok of type t's O offerings against the claim p ∪ g: any
// available offering whose zone and capacity-type values the merged masks
// admit (a negative id admits any value). ``z_ok(z)`` / ``c_ok(c)``: the
// merged zone / capacity-type masks admit value slot z / c.
template <class ZOk, class COk>
__device__ __forceinline__ bool offering_ok_by(const uint8_t* o_avail, const int32_t* o_zone,
                                               const int32_t* o_ct, int O, const ZOk& z_ok,
                                               const COk& c_ok) {
  for (int o = 0; o < O; ++o) {
    if (!o_avail[o]) continue;
    const int32_t z = o_zone[o], c = o_ct[o];
    if ((z < 0 || z_ok(z)) && (c < 0 || c_ok(c))) return true;
  }
  return false;
}

// offering_ok_by over the [W] zone and capacity-type words of template
// and group (pz/pc/gz/gc)
__device__ __forceinline__ bool dense_offering_ok(
    const uint32_t* pz, const uint32_t* pc, const uint32_t* gz, const uint32_t* gc,
    const uint8_t* o_avail, const int32_t* o_zone, const int32_t* o_ct, int O) {
  return offering_ok_by(o_avail, o_zone, o_ct, O,
                        [&](int z) { return bit(pz, z) && bit(gz, z); },
                        [&](int c) { return bit(pc, c) && bit(gc, c); });
}

}  // namespace kt

// Kernel B6: the wire-compact output layout of the fused solve.
//
// Replaces karpenter_tpu/ops/solve.py:_wire_pack (an XLA program on the
// TPU): the [NMAX, T] claim/type mask bit-packs MSB-first into uint8
// (bit weights 128..1, numpy.unpackbits(bitorder="big")), c_pool, c_dzone
// and c_dct narrow to int16, and the fill matrices narrow to the fills
// dtype (int16 when the host proves the fill bound, else int32). Narrowing
// truncates two's complement, as XLA's convert does.
//
// Bound on the H100: launch latency; at the 50k x 400 cell it reads
// ~0.7 MB and writes ~0.2 MB.
//
// Design: one launch, its grid split into regions by block, so no thread
// branches per element: the mask pack, the existing-node fills, the claim
// fills and the three per-claim rows each own a range of blocks.
//  - the mask: a warp packs 128 types of one claim row, 4 a lane (one
//    4-byte load where the row allows it): a lane turns its 4 bytes into
//    a nibble, weights 8..1 in type order, and the even lane of each pair
//    takes its neighbour's nibble below its own, one output byte;
//  - the fills: 8 elements a thread, two 16-byte loads and one 16-byte
//    (int16) or two 16-byte (int32) stores where the buffers are aligned,
//    element by element for the tail;
//  - c_pool, c_dzone and c_dct: an element a thread (NMAX of each).
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kVec = 8;  // fill elements a thread

// the blocks of each region: mask, existing fills, claim fills, rows
struct Regions {
  int mask, exist, claim, rows;
};

// the nibble of 4 mask bytes, the first type at weight 8
__device__ __forceinline__ unsigned nibble4(uint32_t x) {
  return ((x & 0xffu) ? 8u : 0u) | ((x & 0xff00u) ? 4u : 0u) | ((x & 0xff0000u) ? 2u : 0u) |
         ((x & 0xff000000u) ? 1u : 0u);
}

// elements [i, i + kVec) of a fill matrix narrowed (or copied) into ``out``
template <class O>
__device__ __forceinline__ void fills8(const int32_t* __restrict__ in, O* __restrict__ out,
                                       long long i, long long n, bool vec) {
  if (vec && i + kVec <= n) {
    const int4 a = *reinterpret_cast<const int4*>(in + i);
    const int4 b = *reinterpret_cast<const int4*>(in + i + 4);
    if constexpr (sizeof(O) == 2) {
      // two's complement truncation: the low 16 bits of each element
      uint4 v;
      v.x = (static_cast<uint32_t>(a.x) & 0xffffu) | static_cast<uint32_t>(a.y) << 16;
      v.y = (static_cast<uint32_t>(a.z) & 0xffffu) | static_cast<uint32_t>(a.w) << 16;
      v.z = (static_cast<uint32_t>(b.x) & 0xffffu) | static_cast<uint32_t>(b.y) << 16;
      v.w = (static_cast<uint32_t>(b.z) & 0xffffu) | static_cast<uint32_t>(b.w) << 16;
      *reinterpret_cast<uint4*>(out + i) = v;
    } else {
      *reinterpret_cast<int4*>(out + i) = a;
      *reinterpret_cast<int4*>(out + i + 4) = b;
    }
    return;
  }
  for (long long j = i; j < n && j < i + kVec; ++j) out[j] = static_cast<O>(in[j]);
}

template <class O>
__device__ void fills_region(const int32_t* __restrict__ in, O* __restrict__ out, long long n,
                             int b, int nb, bool vec) {
  for (long long i = (static_cast<long long>(b) * kBlock + threadIdx.x) * kVec; i < n;
       i += static_cast<long long>(nb) * kBlock * kVec)
    fills8(in, out, i, n, vec);
}

__global__ void __launch_bounds__(kBlock) wire_pack(
    int NMAX, int T, int TB, long long n_exist, long long n_claim, bool fills16, bool row4,
    bool vec, Regions rg,
    const int32_t* __restrict__ c_pool, const uint8_t* __restrict__ c_tmask,
    const int32_t* __restrict__ exist_fills, const int32_t* __restrict__ claim_fills,
    const int32_t* __restrict__ c_dzone, const int32_t* __restrict__ c_dct,
    int16_t* __restrict__ pool16, uint8_t* __restrict__ packed,
    void* __restrict__ exist_out, void* __restrict__ claim_out,
    int16_t* __restrict__ dzone16, int16_t* __restrict__ dct16) {
  int b = blockIdx.x;
  if (b < rg.mask) {
    // a warp per (claim row, 128-type chunk), 4 types a lane
    const int lane = threadIdx.x & 31, chunks = (T + 127) / 128;
    const long long items = static_cast<long long>(NMAX) * chunks;
    for (long long w = static_cast<long long>(b) * (kBlock / 32) + (threadIdx.x >> 5); w < items;
         w += static_cast<long long>(rg.mask) * (kBlock / 32)) {
      const long long row = w / chunks;
      const int t = static_cast<int>(w % chunks) * 128 + 4 * lane;
      const uint8_t* r = c_tmask + row * T;
      uint32_t x = 0;
      if (row4 && t + 4 <= T) {
        x = *reinterpret_cast<const uint32_t*>(r + t);
      } else {
        for (int j = 0; j < 4 && t + j < T; ++j) x |= static_cast<uint32_t>(r[t + j]) << (8 * j);
      }
      const unsigned nib = nibble4(x);
      const unsigned lo = __shfl_down_sync(kt::kFull, nib, 1);
      const int byte = t / 8;
      if ((lane & 1) == 0 && byte < TB) packed[row * TB + byte] = static_cast<uint8_t>(nib << 4 | lo);
    }
    return;
  }
  b -= rg.mask;
  if (b < rg.exist) {
    if (fills16)
      fills_region(exist_fills, static_cast<int16_t*>(exist_out), n_exist, b, rg.exist, vec);
    else
      fills_region(exist_fills, static_cast<int32_t*>(exist_out), n_exist, b, rg.exist, vec);
    return;
  }
  b -= rg.exist;
  if (b < rg.claim) {
    if (fills16)
      fills_region(claim_fills, static_cast<int16_t*>(claim_out), n_claim, b, rg.claim, vec);
    else
      fills_region(claim_fills, static_cast<int32_t*>(claim_out), n_claim, b, rg.claim, vec);
    return;
  }
  b -= rg.claim;
  for (int j = b * kBlock + threadIdx.x; j < NMAX; j += rg.rows * kBlock) {
    pool16[j] = static_cast<int16_t>(c_pool[j]);
    dzone16[j] = static_cast<int16_t>(c_dzone[j]);
    dct16[j] = static_cast<int16_t>(c_dct[j]);
  }
}

// blocks for n work items of ``per`` a block, at least 1 where n > 0, at
// most ``cap``
int blocks_for(long long n, long long per, int cap) {
  const long long b = (n + per - 1) / per;
  return static_cast<int>(b < cap ? b : cap);
}

}  // namespace

extern "C" int kt_wire_pack(
    int NMAX, int T, int G, int N, int fills16,
    const int32_t* c_pool, const uint8_t* c_tmask, const int32_t* exist_fills,
    const int32_t* claim_fills, const int32_t* c_dzone, const int32_t* c_dct,
    int16_t* pool16, uint8_t* packed, void* exist_out, void* claim_out,
    int16_t* dzone16, int16_t* dct16, void* stream_ptr) {
  const int TB = (T + 7) / 8;
  const long long n_exist = static_cast<long long>(G) * N, n_claim = static_cast<long long>(G) * NMAX;
  const long long mask_items = static_cast<long long>(NMAX) * ((T + 127) / 128);
  Regions rg{blocks_for(mask_items, kBlock / 32, 1024), blocks_for(n_exist, kBlock * kVec, 1024),
             blocks_for(n_claim, kBlock * kVec, 1024), blocks_for(NMAX, kBlock, 64)};
  const int blocks = rg.mask + rg.exist + rg.claim + rg.rows;
  if (blocks == 0) return kt::kNothingLaunched;
  const bool row4 = T % 4 == 0 && reinterpret_cast<uintptr_t>(c_tmask) % 4 == 0;
  const bool vec = (reinterpret_cast<uintptr_t>(exist_fills) | reinterpret_cast<uintptr_t>(claim_fills) |
                    reinterpret_cast<uintptr_t>(exist_out) | reinterpret_cast<uintptr_t>(claim_out)) %
                       16 == 0;
  wire_pack<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      NMAX, T, TB, n_exist, n_claim, fills16 != 0, row4, vec, rg, c_pool, c_tmask, exist_fills,
      claim_fills, c_dzone, c_dct, pool16, packed, exist_out, claim_out, dzone16, dct16);
  return static_cast<int>(cudaGetLastError());
}

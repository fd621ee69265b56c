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
// Design: one flat grid over every output element — one thread per
// (claim row, output byte) for the mask, one per element for the casts.
#include "common.cuh"

namespace {

__global__ void wire_pack(
    int NMAX, int T, int TB, int G, int N, int fills16,
    const int32_t* __restrict__ c_pool, const uint8_t* __restrict__ c_tmask,
    const int32_t* __restrict__ exist_fills, const int32_t* __restrict__ claim_fills,
    const int32_t* __restrict__ c_dzone, const int32_t* __restrict__ c_dct,
    int16_t* __restrict__ pool16, uint8_t* __restrict__ packed,
    void* __restrict__ exist_out, void* __restrict__ claim_out,
    int16_t* __restrict__ dzone16, int16_t* __restrict__ dct16) {
  const long long n_bytes = static_cast<long long>(NMAX) * TB;
  const long long n_exist = static_cast<long long>(G) * N;
  const long long n_claim = static_cast<long long>(G) * NMAX;
  const long long total = n_bytes + n_exist + n_claim + NMAX;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < n_bytes) {
      const long long row = i / TB;
      const int byte = static_cast<int>(i % TB);
      unsigned v = 0;
      for (int j = 0; j < 8; ++j) {
        const int t = byte * 8 + j;
        if (t < T && c_tmask[row * T + t]) v |= 128u >> j;
      }
      packed[i] = static_cast<uint8_t>(v);
      continue;
    }
    long long j = i - n_bytes;
    if (j < n_exist) {
      if (fills16)
        static_cast<int16_t*>(exist_out)[j] = static_cast<int16_t>(exist_fills[j]);
      else
        static_cast<int32_t*>(exist_out)[j] = exist_fills[j];
      continue;
    }
    j -= n_exist;
    if (j < n_claim) {
      if (fills16)
        static_cast<int16_t*>(claim_out)[j] = static_cast<int16_t>(claim_fills[j]);
      else
        static_cast<int32_t*>(claim_out)[j] = claim_fills[j];
      continue;
    }
    j -= n_claim;
    pool16[j] = static_cast<int16_t>(c_pool[j]);
    dzone16[j] = static_cast<int16_t>(c_dzone[j]);
    dct16[j] = static_cast<int16_t>(c_dct[j]);
  }
}

}  // namespace

extern "C" int kt_wire_pack(
    int NMAX, int T, int G, int N, int fills16,
    const int32_t* c_pool, const uint8_t* c_tmask, const int32_t* exist_fills,
    const int32_t* claim_fills, const int32_t* c_dzone, const int32_t* c_dct,
    int16_t* pool16, uint8_t* packed, void* exist_out, void* claim_out,
    int16_t* dzone16, int16_t* dct16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int TB = (T + 7) / 8;
  const long long total = static_cast<long long>(NMAX) * TB +
                          static_cast<long long>(G) * N +
                          static_cast<long long>(G) * NMAX + NMAX;
  if (total == 0) return kt::kNothingLaunched;
  constexpr int kBlock = 256;
  const long long blocks = (total + kBlock - 1) / kBlock;
  wire_pack<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kBlock, 0, stream>>>(
      NMAX, T, TB, G, N, fills16, c_pool, c_tmask, exist_fills, claim_fills,
      c_dzone, c_dct, pool16, packed, exist_out, claim_out, dzone16, dct16);
  return static_cast<int>(cudaGetLastError());
}

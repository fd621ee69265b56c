// Kernel B8: the row-delta apply, out = arr with out[idx[i]] = rows[i].
//
// Replaces karpenter_tpu/ops/solve.py:_apply_rows_core / delta_apply_rows
// (arr.at[idx].set(rows), an XLA scatter on the TPU): the residency store
// (solver/residency.py) keeps the solve's arguments on the card between
// solves, and a churn tick rewrites only the rows its encode changed. Two
// entries, as the JAX package has two jitted twins:
//
// - kt_apply_rows (the default) is out of place: arr is left as it was (a
//   launch still holding it may read it). Bound on the H100: bytes (arr
//   read and out written once, the delta rows and their indices read once).
//   ONE launch writes out whole, so no separate copy of arr runs before
//   it. Block b owns a contiguous range of rows: it copies them from arr
//   with 16-byte moves wherever source and destination share their
//   alignment (4- or 1-byte moves otherwise, and at a ragged edge), then,
//   after a barrier, overwrites the delta rows that fall in its range. It
//   finds them by reading idx once, in chunks staged through shared memory.
// - kt_apply_rows_inplace (KTPU_DONATE_DELTA=1; JAX's donated twin,
//   ops/solve.py:404) writes the delta rows into arr's own memory and
//   nothing else: no copy of the buffer, so a 50k-pod encoding is never
//   held twice on the card. A grid-stride loop over the delta's words:
//   word w is word w % per of delta row w / per, so each thread reads the
//   index of the rows it moves, and each index crosses from memory once.
//   Bound: bytes (the delta rows read and written, their indices read).
//
// Both: a negative index counts from the end and one outside the rows is
// dropped, as XLA's scatter does. Duplicate indices carry identical rows,
// so the order of their writes does not matter. Rows move as raw bytes,
// whatever their element type; at the main path's sizes (tens of KB to
// tens of MB) the launch and the host enqueue come first.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
// delta indices staged in shared memory per pass
constexpr int kChunk = 1024;
// bytes of arr a block copies, and at most this many blocks (4 per SM)
constexpr long long kBlockBytes = 64 * 1024;
constexpr long long kMaxBlocks = 4 * 132;
// the in-place entry's grid: at most 8 blocks of kBlock threads per SM
constexpr long long kMaxInplaceBlocks = 8 * 132;

template <typename V>
__device__ void copy_as(const uint8_t* src, uint8_t* dst, long long n) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (long long i = threadIdx.x; i < n; i += kBlock) d[i] = s[i];
}

// bytes [0, n) of src into dst by the whole block: the widest move that
// both addresses allow after a head of single bytes, then a byte tail
__device__ void block_copy(const uint8_t* src, uint8_t* dst, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), b = reinterpret_cast<uintptr_t>(dst);
  const int vec = ((a ^ b) & 15) == 0 ? 16 : ((a ^ b) & 3) == 0 ? 4 : 1;
  const long long head = min(static_cast<long long>((vec - (a & (vec - 1))) & (vec - 1)), n);
  copy_as<uint8_t>(src, dst, head);
  const long long body = (n - head) / vec;
  if (vec == 16)
    copy_as<uint4>(src + head, dst + head, body);
  else if (vec == 4)
    copy_as<uint32_t>(src + head, dst + head, body);
  else
    copy_as<uint8_t>(src + head, dst + head, body);
  const long long done = head + body * vec;
  copy_as<uint8_t>(src + done, dst + done, n - done);
}

// the delta's rows of [r0, r1): ``vec`` divides row_bytes and both bases'
// alignment, so every row moves as row_bytes / vec words of V
template <typename V>
__device__ void overwrite(const int32_t* s_src, const int32_t* s_dst, int n,
                          const uint8_t* rows, uint8_t* out, long long row_bytes) {
  const long long per = row_bytes / static_cast<long long>(sizeof(V));
  auto word = [&](int k, long long w) {
    reinterpret_cast<V*>(out + s_dst[k] * row_bytes)[w] =
        reinterpret_cast<const V*>(rows + s_src[k] * row_bytes)[w];
  };
  if (per >= kBlock) {  // a row per pass, threads along it
    for (int k = 0; k < n; ++k)
      for (long long w = threadIdx.x; w < per; w += kBlock) word(k, w);
    return;
  }
  const int p = static_cast<int>(per);  // n * p < kChunk * kBlock
  for (int j = threadIdx.x; j < n * p; j += kBlock) {
    const int k = j / p;
    word(k, j - k * p);
  }
}

__global__ void __launch_bounds__(kBlock) apply_rows(const uint8_t* arr, uint8_t* out,
                                                     const int32_t* idx, const uint8_t* rows,
                                                     long long n_rows, long long row_bytes,
                                                     int n_delta, long long rows_per_block,
                                                     int vec) {
  __shared__ int32_t s_src[kChunk];  // delta rows that land in this block's range
  __shared__ int32_t s_dst[kChunk];  // ... and their destination rows
  __shared__ int s_n;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, n_rows);
  block_copy(arr + r0 * row_bytes, out + r0 * row_bytes, (r1 - r0) * row_bytes);
  for (int base = 0; base < n_delta; base += kChunk) {
    if (threadIdx.x == 0) s_n = 0;
    // orders the copy (first pass) or the last pass's writes before these
    __syncthreads();
    for (int i = base + threadIdx.x; i < n_delta && i < base + kChunk; i += kBlock) {
      long long dst = idx[i];
      if (dst < 0) dst += n_rows;
      if (dst >= r0 && dst < r1) {
        const int k = atomicAdd(&s_n, 1);
        s_src[k] = i;
        s_dst[k] = static_cast<int32_t>(dst);
      }
    }
    __syncthreads();
    const int n = s_n;
    if (vec == 16)
      overwrite<uint4>(s_src, s_dst, n, rows, out, row_bytes);
    else if (vec == 4)
      overwrite<uint32_t>(s_src, s_dst, n, rows, out, row_bytes);
    else
      overwrite<uint8_t>(s_src, s_dst, n, rows, out, row_bytes);
    __syncthreads();
  }
}

// arr[idx[k]] = rows[k] in place, ``per`` words of V a row, ``words`` =
// n_delta * per words in all
template <typename V>
__global__ void __launch_bounds__(kBlock) apply_rows_inplace(uint8_t* arr, const int32_t* idx,
                                                             const uint8_t* rows,
                                                             long long n_rows, long long per,
                                                             long long words) {
  V* dst = reinterpret_cast<V*>(arr);
  const V* src = reinterpret_cast<const V*>(rows);
  const long long step = static_cast<long long>(gridDim.x) * kBlock;
  for (long long w = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x; w < words;
       w += step) {
    const long long k = w / per;
    long long r = idx[k];
    if (r < 0) r += n_rows;
    if (r >= 0 && r < n_rows) dst[r * per + (w - k * per)] = src[w];
  }
}

}  // namespace

// out [n_rows, row_bytes] = arr with the n_delta rows of ``rows`` at idx
// (int32); arr and out are distinct buffers of the same size.
extern "C" int kt_apply_rows(long long n_rows, long long row_bytes, int n_delta,
                             const void* arr, const int32_t* idx, const void* rows,
                             void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0 || row_bytes <= 0 || n_delta < 0) return kt::kNothingLaunched;
  const long long total = n_rows * row_bytes;
  long long blocks = (total + kBlockBytes - 1) / kBlockBytes;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  const long long rows_per_block = (n_rows + blocks - 1) / blocks;
  blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out);
  const int vec = (row_bytes % 16 == 0 && bases % 16 == 0) ? 16
                  : (row_bytes % 4 == 0 && bases % 4 == 0) ? 4
                                                           : 1;
  apply_rows<<<static_cast<int>(blocks), kBlock, 0, stream>>>(
      static_cast<const uint8_t*>(arr), static_cast<uint8_t*>(out), idx,
      static_cast<const uint8_t*>(rows), n_rows, row_bytes, n_delta, rows_per_block, vec);
  return static_cast<int>(cudaGetLastError());
}

// arr [n_rows, row_bytes] with the n_delta rows of ``rows`` written at idx
// (int32), in place: only those rows of arr are touched.
extern "C" int kt_apply_rows_inplace(long long n_rows, long long row_bytes, int n_delta,
                                     void* arr, const int32_t* idx, const void* rows,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0 || row_bytes <= 0 || n_delta <= 0) return kt::kNothingLaunched;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(arr);
  const int vec = (row_bytes % 16 == 0 && bases % 16 == 0) ? 16
                  : (row_bytes % 4 == 0 && bases % 4 == 0) ? 4
                                                           : 1;
  const long long per = row_bytes / vec;
  const long long words = per * n_delta;
  long long blocks = (words + kBlock - 1) / kBlock;
  blocks = blocks < kMaxInplaceBlocks ? blocks : kMaxInplaceBlocks;
  uint8_t* a = static_cast<uint8_t*>(arr);
  const uint8_t* r = static_cast<const uint8_t*>(rows);
  const int grid = static_cast<int>(blocks);
  if (vec == 16)
    apply_rows_inplace<uint4><<<grid, kBlock, 0, stream>>>(a, idx, r, n_rows, per, words);
  else if (vec == 4)
    apply_rows_inplace<uint32_t><<<grid, kBlock, 0, stream>>>(a, idx, r, n_rows, per, words);
  else
    apply_rows_inplace<uint8_t><<<grid, kBlock, 0, stream>>>(a, idx, r, n_rows, per, words);
  return static_cast<int>(cudaGetLastError());
}

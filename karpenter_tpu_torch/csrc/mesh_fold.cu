// The solver mesh's fold: the shards' feasibility partials into the
// replicated tables, once per feasibility stage, on the lead device.
//
// Replaces the stage-boundary all-reduce of
// karpenter_tpu/parallel/mesh.py:sharded_solve_fn / sharded_scenarios_fn
// (GSPMD's segment_sum fold and the table gather that
// karpenter_tpu/ops/solve.py:_solve_with's table_sharding asks for before
// the scan), which no kernel body of the JAX package computes. The D data
// shards x M model shards of a scenario block each wrote int32 failure
// counts over their slices (fresh_feasibility.cu's and
// existing_feasibility.cu's partial modes) straight into one stacked
// buffer per input on the block's lead device; this kernel sums the D
// counts of each cell (int32, wrapping: exact in any order), and finishes
// the cell with the device functions the single-device kernels end with
// (tables_finish.cuh):
//   compat_pg [P, G]    = compat_of(p_tol, sum_d fail_c[d])
//   type_ok   [P, G, T] = fresh_cell(compat, sum_d fail_t[d, m], tonly[m])
//   n_fit     [P, G, T] = n_fit_in[m]
//   cap_ng [S, N, G]    = node_cap(sum_d nfail[d], n_tol, cap)
// where type t = m * Tm + j (T = M * Tm) reads cell j of model shard m's
// slices: fail_t [D, M, P, G, Tm], fail_c [D, P, G], tonly and n_fit_in
// [M, P, G, Tm], nfail [D, N, G]. With D = 0 the parts are final (the
// dense route's type slices of B3, their compat_pg passed as p_tol) and the
// fold only gathers them.
//
// Bound on the H100: memory, and nothing else. A fresh cell reads 4 D + 5
// bytes and writes 5 (plus 4 D + 1 a (p, g) pair, for the compat); an
// existing cell reads 4 D + 4 + S and writes 4 S. At the constrained cell
// (P 1, G 256, T 800, D 8) that is ~8.6 MB, ~2.6 us at 3.35 TB/s. No byte
// is read twice (a pair's fail_c row, reread by the threads of its row,
// is 4 D bytes of the 8.6 MB and stays in L1/L2), so shared memory and
// the TMA have nothing to stage: the design is a streaming reduction that
// keeps as many bytes in flight as it can.
//
// Design: one launch in regions by block, as wire_pack.cu and
// relax_fill.cu: the first blocks take the fresh cells, the rest the
// existing cells. A thread takes V consecutive cells: 4 consecutive types
// of one (p, g) row (inside one model shard), or 4 consecutive (node,
// group) cells. It reads each partial as one 16-byte int4 and issues the
// loads of a chunk of kChunk partials before its first add (a dependent
// add waits on nothing but its own load); it reads the pair's fail_c once
// for its 4 cells, the 4 type-only bytes and the 4 gates as one word,
// writes type_ok as one 4-byte word and n_fit / cap_ng as one int4. Where
// Tm (or N * G, for the node region) is not a multiple of 4, or a buffer
// is not aligned to its vector, the region runs the same kernel a cell a
// thread (V = 1, a template parameter chosen at launch).
#include <cstdint>

#include "tables_finish.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 8;  // partials loaded before the first add

// V consecutive int32 cells
template <int V>
struct Cells {
  int32_t v[V];
};

template <int V>
__device__ __forceinline__ Cells<V> load_cells(const int32_t* p) {
  Cells<V> c;
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    c.v[0] = q.x, c.v[1] = q.y, c.v[2] = q.z, c.v[3] = q.w;
  } else {
    c.v[0] = __ldg(p);
  }
  return c;
}

template <int V>
__device__ __forceinline__ void store_cells(int32_t* p, const Cells<V>& c) {
  if constexpr (V == 4)
    *reinterpret_cast<int4*>(p) = make_int4(c.v[0], c.v[1], c.v[2], c.v[3]);
  else
    *p = c.v[0];
}

// V consecutive bool bytes as one word, byte c the cell c
template <int V>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (V == 4)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  else
    return __ldg(p);
}

template <int V>
__device__ __forceinline__ void store_bytes(uint8_t* p, uint32_t w) {
  if constexpr (V == 4)
    *reinterpret_cast<uint32_t*>(p) = w;
  else
    *p = static_cast<uint8_t>(w);
}

__device__ __forceinline__ bool byte_of(uint32_t w, int c) { return (w >> (8 * c)) & 0xff; }

// The wrapping sums of the D partials at p + d * stride (V cells each) and,
// with ``q``, of the D scalars at q + d * qstride: every load of a chunk
// issued before its first add.
template <int V>
__device__ __forceinline__ Cells<V> fold_partials(const int32_t* __restrict__ p, long long stride,
                                                  int D, const int32_t* __restrict__ q = nullptr,
                                                  long long qstride = 0, int32_t* qsum = nullptr) {
  Cells<V> acc{};
  int32_t qacc = 0;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    Cells<V> part[kChunk];
    int32_t qpart[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (d0 + k < D) {
        part[k] = load_cells<V>(p + (d0 + k) * stride);
        if (q != nullptr) qpart[k] = __ldg(q + (d0 + k) * qstride);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (d0 + k < D) {
#pragma unroll
        for (int c = 0; c < V; ++c) acc.v[c] = kt::wrap_add(acc.v[c], part[k].v[c]);
        if (q != nullptr) qacc = kt::wrap_add(qacc, qpart[k]);
      }
    }
  }
  if (qsum != nullptr) *qsum = qacc;
  return acc;
}

template <int VF, int VE>
__global__ void __launch_bounds__(kBlock) fold(
    int D, int M, long long PG, int Tm, long long NG, int S, int fresh_blocks,
    const int32_t* __restrict__ fail_t, const int32_t* __restrict__ fail_c,
    const uint8_t* __restrict__ tonly, const int32_t* __restrict__ n_fit_in,
    const int32_t* __restrict__ nfail, const uint8_t* __restrict__ p_tol,
    const int32_t* __restrict__ cap, const uint8_t* __restrict__ n_tol,
    uint8_t* __restrict__ compat_pg, uint8_t* __restrict__ type_ok,
    int32_t* __restrict__ n_fit, int32_t* __restrict__ cap_ng) {
  if (static_cast<int>(blockIdx.x) < fresh_blocks) {
    const int T = M * Tm;
    const int row = T / VF;  // threads of a (p, g) row
    const long long q = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
    if (q >= PG * row) return;
    const long long pg = q / row;
    const int t = static_cast<int>(q - pg * row) * VF;
    const int m = t / Tm;
    // the cells' offset in a [M, P, G, Tm] slice stack; data shards are
    // M * P * G * Tm apart
    const long long at = (static_cast<long long>(m) * PG + pg) * Tm + (t - m * Tm);
    int32_t cfail = 0;
    const Cells<VF> fails =
        fold_partials<VF>(fail_t + at, static_cast<long long>(M) * PG * Tm, D, fail_c + pg, PG,
                          &cfail);
    const bool compat = kt::compat_of(p_tol[pg], cfail);
    if (t == 0) compat_pg[pg] = compat;
    const uint32_t only = load_bytes<VF>(tonly + at);
    uint32_t ok = 0;
#pragma unroll
    for (int c = 0; c < VF; ++c)
      ok |= static_cast<uint32_t>(kt::fresh_cell(compat, fails.v[c], byte_of(only, c))) << (8 * c);
    const long long out = pg * T + t;
    store_bytes<VF>(type_ok + out, ok);
    store_cells<VF>(n_fit + out, load_cells<VF>(n_fit_in + at));
    return;
  }
  const long long i =
      (static_cast<long long>(blockIdx.x - fresh_blocks) * kBlock + threadIdx.x) * VE;
  if (i >= NG) return;
  const Cells<VE> fails = fold_partials<VE>(nfail + i, NG, D);
  const Cells<VE> room = load_cells<VE>(cap + i);
  for (int s = 0; s < S; ++s) {
    const uint32_t tol = load_bytes<VE>(n_tol + s * NG + i);
    Cells<VE> gated;
#pragma unroll
    for (int c = 0; c < VE; ++c) gated.v[c] = kt::node_cap(fails.v[c], byte_of(tol, c), room.v[c]);
    store_cells<VE>(cap_ng + s * NG + i, gated);
  }
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

template <int VF, int VE>
void launch(int blocks, cudaStream_t stream, int D, int M, long long PG, int Tm, long long NG,
            int S, int fresh_blocks, const int32_t* fail_t, const int32_t* fail_c,
            const uint8_t* tonly, const int32_t* n_fit_in, const int32_t* nfail,
            const uint8_t* p_tol, const int32_t* cap, const uint8_t* n_tol, uint8_t* compat_pg,
            uint8_t* type_ok, int32_t* n_fit, int32_t* cap_ng) {
  fold<VF, VE><<<blocks, kBlock, 0, stream>>>(D, M, PG, Tm, NG, S, fresh_blocks, fail_t, fail_c,
                                              tonly, n_fit_in, nfail, p_tol, cap, n_tol,
                                              compat_pg, type_ok, n_fit, cap_ng);
}

}  // namespace

// D data shards x M model shards, every input one device buffer: fail_t
// [D, M, P, G, Tm] int32, fail_c [D, P, G] int32, tonly [M, P, G, Tm]
// bool, n_fit_in [M, P, G, Tm] int32, nfail [D, N, G] int32 (N may be 0,
// then nfail, cap, n_tol and cap_ng are not read), p_tol [P, G], cap [N, G],
// n_tol [S, N, G]; outputs compat_pg [P, G], type_ok [P, G, M * Tm], n_fit
// [P, G, M * Tm], cap_ng [S, N, G].
extern "C" int kt_mesh_fold(
    int D, int M, int P, int G, int Tm, int N, int S,
    const int32_t* fail_t, const int32_t* fail_c, const uint8_t* tonly,
    const int32_t* n_fit_in, const int32_t* nfail,
    const uint8_t* p_tol, const int32_t* cap, const uint8_t* n_tol,
    uint8_t* compat_pg, uint8_t* type_ok, int32_t* n_fit, int32_t* cap_ng,
    void* stream_ptr) {
  if (M < 1 || D < 0 || P < 0 || G < 0 || Tm < 0 || N < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long PG = static_cast<long long>(P) * G, NG = static_cast<long long>(N) * G;
  // 4 cells a thread where every buffer of the region holds its vectors
  const bool vf = Tm % 4 == 0 && aligned(fail_t, 16) && aligned(n_fit_in, 16) &&
                  aligned(tonly, 4) && aligned(type_ok, 4) && aligned(n_fit, 16);
  const bool ve = NG % 4 == 0 && aligned(nfail, 16) && aligned(cap, 16) && aligned(n_tol, 4) &&
                  aligned(cap_ng, 16);
  const long long fresh = PG * M * Tm / (vf ? 4 : 1);
  const long long exist = S > 0 ? NG / (ve ? 4 : 1) : 0;
  const long long fresh_blocks = (fresh + kBlock - 1) / kBlock;
  const long long blocks = fresh_blocks + (exist + kBlock - 1) / kBlock;
  if (blocks == 0) return kt::kNothingLaunched;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  using Launch = decltype(&launch<1, 1>);
  const Launch run =
      vf ? (ve ? &launch<4, 4> : &launch<4, 1>) : (ve ? &launch<1, 4> : &launch<1, 1>);
  run(static_cast<int>(blocks), stream, D, M, PG, Tm, NG, S, static_cast<int>(fresh_blocks),
      fail_t, fail_c, tonly, n_fit_in, nfail, p_tol, cap, n_tol, compat_pg, type_ok, n_fit,
      cap_ng);
  return static_cast<int>(cudaGetLastError());
}

// Fused GGM-expand + select-add scan over the int8 byte view, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/fused_scan.py _fused_add_kernel (with
// _expand_tile, _interleave and kernels/ggm_expand.py _chacha_rows; the
// pallas_call in _fused_scan_add_jit). From per-chunk GGM subtree roots it
// expands the last `clog` tree levels to the leaves, turns each leaf into
// its Z_256 additive share and adds share * row into the answer, so the
// [Q, R] shares of the materialized path (eval_bytes_batch + the int8
// GEMM) never exist in device memory. The result equals that path bit for
// bit: out[q, l] = sum over leaves j of int8(share_q(j)) * int8(db[j, l]),
// summed in int32 with wraparound.
//
// Per leaf, as the reference: conv = word 0 of the leaf seed's ChaCha
// block at counter 1; share = ((conv & 0xFF) + t * (cw_final & 0xFF)) &
// 0xFF, negated mod 256 for party 1; read as int8 (s - 256 where s >= 128).
//
// Bound: operations. Every internal node costs one ChaCha12 block (576 ARX
// ops) and every leaf one more for its conversion word: Q * (2R - C) blocks
// for a batch, against one DB stream per batch. The int multiply-adds of
// the select-add (Q * R * L) come on top and are not counted, so the bound
// is a lower one.
//
// Design: fused_scan_xor.cu's, with + in place of ^. One thread per
// (query, chunk root) walks its subtree depth first, with the right
// children of the current path on a clog-deep stack and ChaCha's state in
// registers. Unlike the XOR scan every leaf contributes (a leaf with t = 0
// still carries conv), so every leaf loads its row; queries are the
// fastest thread index, so the lanes of a warp that serve one chunk read
// the same row together and the DB streams from HBM about once per batch.
// L int32 accumulators per thread are reduced by shuffle-add across lanes
// of the same query, across warps in shared memory, then with one
// atomicAdd per (q, l) into the zeroed output; addition mod 2^32 makes the
// result independent of the order.
//
// Widths: L in {4, 8, 16, 32} with the DB aligned for load_row<L/4> takes
// the exact instance (<L, true>). Any other L (a multiple of 4), or a DB
// only 4-byte aligned, takes a column-group instance (<G, false>, G = 16,
// 48 or 64 bytes): G accumulators, the first nb = min(G, L - col0) live,
// rows read one 4-byte word at a time; grid.z covers L > 64 in groups of
// 64 bytes, each group expanding the subtrees again. At L = 36 (32-byte
// records with a checksum word) that is one group of 48. Its partials meet
// in one shared [32, G] array by shared atomicAdd, since a [warps, 32, G]
// array as the exact instance keeps would pass 48 KB at G = 48.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClog = 24;

// acc += int8(share(seed, t)) * int8(row) over the row's L bytes; the
// accumulators are unsigned so that their wraparound is defined.
// The exact instance reads the whole row (L = G bytes) in vector loads; a
// column group reads its nb bytes (a multiple of 4) from byte col0 on, one
// word at a time, in a row of `cols` bytes.
template <int G, bool kExact>
__device__ __forceinline__ void add_leaf(uint32_t (&acc)[G],
                                         const uint32_t* __restrict__ db,
                                         long long row, const uint32_t (&seed)[4],
                                         uint32_t t, uint32_t cwf, int party,
                                         int rounds, int cols, int col0, int nb) {
  uint32_t o[16];
  repro::chacha_block(o, seed, 1u, rounds);
  uint32_t share = ((o[0] & 0xFFu) + t * cwf) & 0xFFu;
  if (party) share = (256u - share) & 0xFFu;
  const int s = static_cast<int>(share) - (share >= 128u ? 256 : 0);
  uint32_t r[G / 4];
  if constexpr (kExact) {
    repro::load_row<G / 4>(db + row * (G / 4), r);
  } else {
    const uint32_t* p = db + row * (cols / 4) + col0 / 4;
#pragma unroll
    for (int w = 0; w < G / 4; ++w) r[w] = 4 * w < nb ? __ldg(p + w) : 0u;
  }
#pragma unroll
  for (int w = 0; w < G / 4; ++w)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[4 * w + b] += static_cast<uint32_t>(
          s * static_cast<int>(static_cast<int8_t>(r[w] >> (8 * b))));
}

template <int G, bool kExact>
__global__ void __launch_bounds__(kThreads)
fused_scan_add_kernel(const uint32_t* __restrict__ db,       // [R, L/4] (int8 bytes)
                      const uint32_t* __restrict__ roots,    // [Q, C, 4]
                      const uint32_t* __restrict__ t_roots,  // [Q, C]
                      const uint32_t* __restrict__ cw_seed,  // [Q, clog, 4]
                      const uint32_t* __restrict__ cw_t,     // [Q, clog, 2]
                      const uint32_t* __restrict__ cw_final, // [Q]
                      uint32_t* __restrict__ out,            // [Q, L] int32 bits
                      long long chunks, int queries, int group, int clog,
                      int rounds, int party, int cols) {
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int q = blockIdx.y * group + static_cast<int>(gid % group);
  const long long c = gid / group;
  const int col0 = kExact ? 0 : static_cast<int>(blockIdx.z) * G;
  const int nb = kExact ? G : min(G, cols - col0);
  uint32_t acc[G];
#pragma unroll
  for (int l = 0; l < G; ++l) acc[l] = 0u;

  if (q < queries && c < chunks) {
    const long long qc = static_cast<long long>(q) * chunks + c;
    const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(roots) + qc);
    uint32_t s[4] = {r0.x, r0.y, r0.z, r0.w};
    uint32_t t = __ldg(t_roots + qc);
    const uint32_t cwf = __ldg(cw_final + q) & 0xFFu;
    const uint32_t* cws = cw_seed + static_cast<long long>(q) * clog * 4;
    const uint32_t* cwt = cw_t + static_cast<long long>(q) * clog * 2;
    const long long base = c << clog;
    if (clog == 0) {
      add_leaf<G, kExact>(acc, db, base, s, t, cwf, party, rounds, cols, col0,
                          nb);  // roots are leaves
    } else {
      uint32_t stk_s[kMaxClog][4];
      uint32_t stk_t[kMaxClog];
      const long long pairs = 1LL << (clog - 1);
      int lvl = 0;
      for (long long k = 0; k < pairs; ++k) {
        if (k) {                                  // resume at the last right turn
          const int l = clog - 2 - (__ffsll(k) - 1);
#pragma unroll
          for (int w = 0; w < 4; ++w) s[w] = stk_s[l][w];
          t = stk_t[l];
          lvl = l + 1;
        }
        uint32_t o[16];
        for (; lvl < clog - 1; ++lvl) {           // descend to the pre-leaf level
          repro::chacha_block(o, s, 0u, rounds);
          const uint32_t m = 0u - t;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const uint32_t cw = m & __ldg(cws + lvl * 4 + w);
            stk_s[lvl][w] = o[4 + w] ^ cw;
            s[w] = o[w] ^ cw;
          }
          stk_t[lvl] = (o[9] & 1u) ^ (t & __ldg(cwt + lvl * 2 + 1));
          t = (o[8] & 1u) ^ (t & __ldg(cwt + lvl * 2));
        }
        repro::chacha_block(o, s, 0u, rounds);   // children are leaves 2k, 2k+1
        const int last = clog - 1;
        const uint32_t m = 0u - t;
        uint32_t sl[4], sr[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t cw = m & __ldg(cws + last * 4 + w);
          sl[w] = o[w] ^ cw;
          sr[w] = o[4 + w] ^ cw;
        }
        const uint32_t tl = (o[8] & 1u) ^ (t & __ldg(cwt + last * 2));
        const uint32_t tr = (o[9] & 1u) ^ (t & __ldg(cwt + last * 2 + 1));
        add_leaf<G, kExact>(acc, db, base + 2 * k, sl, tl, cwf, party, rounds,
                            cols, col0, nb);
        add_leaf<G, kExact>(acc, db, base + 2 * k + 1, sr, tr, cwf, party, rounds,
                            cols, col0, nb);
      }
    }
  }

  // lanes l and l ^ off serve the same query when off >= group
#pragma unroll
  for (int l = 0; l < G; ++l)
    for (int off = 16; off >= group; off >>= 1)
      acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (kExact) {
    __shared__ uint32_t part[kWarps][32 * G];
    if (lane < group) {
#pragma unroll
      for (int l = 0; l < G; ++l) part[warp][lane * G + l] = acc[l];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < group * G; i += kThreads) {
      const int qq = blockIdx.y * group + i / G;
      if (qq >= queries) continue;
      uint32_t v = 0u;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) v += part[k][i];
      if (v) atomicAdd(out + static_cast<long long>(qq) * G + i % G, v);
    }
  } else {
    __shared__ uint32_t part[32 * G];
    for (int i = threadIdx.x; i < group * G; i += kThreads) part[i] = 0u;
    __syncthreads();
    if (lane < group) {
#pragma unroll
      for (int l = 0; l < G; ++l)
        if (l < nb && acc[l]) atomicAdd(part + lane * G + l, acc[l]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < group * G; i += kThreads) {
      const int qq = blockIdx.y * group + i / G;
      const uint32_t v = part[i];
      if (qq < queries && i % G < nb && v)
        atomicAdd(out + static_cast<long long>(qq) * cols + col0 + i % G, v);
    }
  }
}

template <int G, bool kExact>
void launch(const uint32_t* db, const uint32_t* roots, const uint32_t* t_roots,
            const uint32_t* cw_seed, const uint32_t* cw_t,
            const uint32_t* cw_final, uint32_t* out, long long chunks, int queries,
            int clog, int rounds, int party, int cols, cudaStream_t stream) {
  int group = 1;                    // queries per warp slice: a power of two <= 32
  while (group < queries && group < 32) group <<= 1;
  const long long threads = chunks * group;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((queries + group - 1) / group),
                  static_cast<unsigned>(kExact ? 1 : (cols + G - 1) / G));
  fused_scan_add_kernel<G, kExact><<<grid, kThreads, 0, stream>>>(
      db, roots, t_roots, cw_seed, cw_t, cw_final, out, chunks, queries, group,
      clog, rounds, party, cols);
}

}  // namespace

// db [rows, cols] int8 row-major (cols % 4 == 0, 4-byte aligned; the exact
// instance needs load_row's alignment); roots [queries, chunks, 4] (16-byte
// aligned), t_roots [queries, chunks], cw_seed [queries, clog, 4], cw_t
// [queries, clog, 2], cw_final [queries] u32; out [queries, cols] int32
// zeroed by the caller; rows == chunks << clog; party 0 or 1. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported shape).
extern "C" int repro_fused_scan_add(const void* db, const uint32_t* roots,
                                    const uint32_t* t_roots, const uint32_t* cw_seed,
                                    const uint32_t* cw_t, const uint32_t* cw_final,
                                    int* out, long long rows, int cols,
                                    int queries, long long chunks, int clog,
                                    int rounds, int party, void* stream) {
  if (cols <= 0 || cols % 4 || queries <= 0 || chunks <= 0 || clog < 0 ||
      clog > kMaxClog || (chunks << clog) != rows || rounds <= 0 || rounds % 2 ||
      (party != 0 && party != 1) || !repro::aligned(db, 4) ||
      !repro::aligned(roots, 16))
    return cudaErrorInvalidValue;
  const auto* d = static_cast<const uint32_t*>(db);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_EXACT(L_)                                                       \
  case L_:                                                                    \
    if (repro::aligned(d, repro::row_align<L_ / 4>())) {                      \
      launch<L_, true>(d, roots, t_roots, cw_seed, cw_t, cw_final, o, chunks, \
                       queries, clog, rounds, party, cols, s);                \
      return cudaGetLastError();                                              \
    }                                                                         \
    break;
  switch (cols) {
    REPRO_EXACT(4) REPRO_EXACT(8) REPRO_EXACT(16) REPRO_EXACT(32)
    default: break;
  }
#undef REPRO_EXACT
  if (cols <= 16)
    launch<16, false>(d, roots, t_roots, cw_seed, cw_t, cw_final, o, chunks,
                      queries, clog, rounds, party, cols, s);
  else if (cols <= 48)
    launch<48, false>(d, roots, t_roots, cw_seed, cw_t, cw_final, o, chunks,
                      queries, clog, rounds, party, cols, s);
  else
    launch<64, false>(d, roots, t_roots, cw_seed, cw_t, cw_final, o, chunks,
                      queries, clog, rounds, party, cols, s);
  return cudaGetLastError();
}

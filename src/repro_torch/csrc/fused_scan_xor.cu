// Fused GGM-expand + select-XOR scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_scan.py _fused_xor_kernel (with
// _expand_tile, _interleave and kernels/ggm_expand.py _chacha_rows; the
// pallas_call in _fused_scan_xor_jit). From per-chunk GGM subtree roots it
// expands the last `clog` tree levels to leaf control bits t(j) and XORs
// the DB rows with t(j) != 0, so the selection vector never exists in
// device memory.
//
// Bound: operations. A subtree of 2^clog leaves has 2^clog - 1 internal
// nodes, each one ChaCha12 block (576 ARX ops): each query costs about 576
// integer ops per 32-byte row, 18 per DB byte, and the batch shares one DB
// stream. The card issues about 10 int32 ops per byte of HBM bandwidth, so
// the integer issue rate, not the bytes, bounds the kernel.
//
// Design: one thread per (query, chunk root). The thread expands its
// 2^clog leaves depth first, keeping the right children of the current
// path on a clog-deep stack (4 seed words + t each) and ChaCha's state in
// registers; each internal node costs exactly one block, as in the
// breadth-first reference. Children follow _interleave's order (left child
// of leaf pair k is leaf 2k) and correction words apply masked by the
// parent's t (fused_scan.py:84-88): child ^= (0 - t) & cw,
// t_child = (blk[8 or 9] & 1) ^ (t & cw_t). A leaf with t != 0 XORs its
// DB row, (c << clog) + j, into W registers. Queries are the fastest thread
// index, so the lanes of a warp that serve one chunk for different queries
// load the same row together and the DB streams from HBM about once per
// batch. Partials are reduced by shuffle-XOR across lanes of the same
// query, across warps in shared memory, then one atomicXor per (q, w).
//
// Widths: W in {1, 2, 4, 8, 16, 32} with the DB aligned for load_row<W>
// takes the exact instance (<W, true>: W accumulators, vector loads; at W =
// 32, 128-byte records, eight 16-byte loads per set leaf, which an
// allocation's 128-byte rows always allow). Any other W, or a DB only 4-byte
// aligned (a row slice), takes a column-group instance (<G, false>, G = 8,
// 16 or 32 >= W where it can): the thread keeps G accumulators, of which the
// first nw = min(G, W - col0) are live, and reads its row's nw words one
// 4-byte load each; grid.z covers W > 32 in groups of 32, each group
// expanding the subtrees again. At W = 9 (36-byte records with a checksum
// column) that is one group of 16 accumulators, as at W = 16. <32, true>
// and <32, false> both take 78 registers on sm_90a (3 blocks per SM), so at
// 2^23 rows and clog 11 the 512 blocks of a batch of 32 run in two waves;
// the vector loads alone took 128-byte rows from 10.67 to 8.93 ms on an
// H100 80GB HBM3 at 700 W (PERF.md).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClog = 24;

// acc ^= the row's words [col0, col0 + nw) when the leaf's t is set; the
// exact instance reads the whole row (nw = W = G) in vector loads.
template <int G, bool kExact>
__device__ __forceinline__ void fold_leaf(uint32_t (&acc)[G],
                                          const uint32_t* __restrict__ db,
                                          long long row, uint32_t t, int words,
                                          int col0, int nw) {
  if (t) {
    const uint32_t m = 0u - t;
    if constexpr (kExact) {
      uint32_t r[G];
      repro::load_row<G>(db + row * G, r);
#pragma unroll
      for (int w = 0; w < G; ++w) acc[w] ^= r[w] & m;
    } else {
      const uint32_t* p = db + row * words + col0;
#pragma unroll
      for (int w = 0; w < G; ++w)
        if (w < nw) acc[w] ^= __ldg(p + w) & m;
    }
  }
}

template <int G, bool kExact>
__global__ void __launch_bounds__(kThreads)
fused_scan_xor_kernel(const uint32_t* __restrict__ db,
                      const uint32_t* __restrict__ roots,    // [Q, C, 4]
                      const uint32_t* __restrict__ t_roots,  // [Q, C]
                      const uint32_t* __restrict__ cw_seed,  // [Q, clog, 4]
                      const uint32_t* __restrict__ cw_t,     // [Q, clog, 2]
                      uint32_t* __restrict__ out,            // [Q, W]
                      long long chunks, int queries, int group, int clog,
                      int rounds, int words) {
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int q = blockIdx.y * group + static_cast<int>(gid % group);
  const long long c = gid / group;
  const int col0 = kExact ? 0 : static_cast<int>(blockIdx.z) * G;
  const int nw = kExact ? G : min(G, words - col0);
  uint32_t acc[G];
#pragma unroll
  for (int w = 0; w < G; ++w) acc[w] = 0u;

  if (q < queries && c < chunks) {
    const long long qc = static_cast<long long>(q) * chunks + c;
    const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(roots) + qc);
    uint32_t s[4] = {r0.x, r0.y, r0.z, r0.w};
    uint32_t t = __ldg(t_roots + qc);
    const uint32_t* cws = cw_seed + static_cast<long long>(q) * clog * 4;
    const uint32_t* cwt = cw_t + static_cast<long long>(q) * clog * 2;
    const long long base = c << clog;
    if (clog == 0) {
      fold_leaf<G, kExact>(acc, db, base, t, words, col0, nw);            // the roots are the leaves
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
        const uint32_t tl = (o[8] & 1u) ^ (t & __ldg(cwt + (clog - 1) * 2));
        const uint32_t tr = (o[9] & 1u) ^ (t & __ldg(cwt + (clog - 1) * 2 + 1));
        fold_leaf<G, kExact>(acc, db, base + 2 * k, tl, words, col0, nw);
        fold_leaf<G, kExact>(acc, db, base + 2 * k + 1, tr, words, col0, nw);
      }
    }
  }

  // lanes l and l ^ off serve the same query when off >= group
#pragma unroll
  for (int w = 0; w < G; ++w)
    for (int off = 16; off >= group; off >>= 1)
      acc[w] ^= __shfl_xor_sync(0xffffffffu, acc[w], off);

  __shared__ uint32_t part[kWarps][32 * G];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < group) {
#pragma unroll
    for (int w = 0; w < G; ++w) part[warp][lane * G + w] = acc[w];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * G; i += kThreads) {
    const int qq = blockIdx.y * group + i / G;
    if (qq >= queries || i % G >= nw) continue;
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v ^= part[k][i];
    if (v) atomicXor(out + static_cast<long long>(qq) * words + col0 + i % G, v);
  }
}

template <int G, bool kExact>
void launch(const uint32_t* db, const uint32_t* roots, const uint32_t* t_roots,
            const uint32_t* cw_seed, const uint32_t* cw_t, uint32_t* out,
            long long chunks, int queries, int clog, int rounds, int words,
            cudaStream_t stream) {
  int group = 1;                    // queries per warp slice: a power of two <= 32
  while (group < queries && group < 32) group <<= 1;
  const long long threads = chunks * group;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((queries + group - 1) / group),
                  static_cast<unsigned>(kExact ? 1 : (words + G - 1) / G));
  fused_scan_xor_kernel<G, kExact><<<grid, kThreads, 0, stream>>>(
      db, roots, t_roots, cw_seed, cw_t, out, chunks, queries, group, clog, rounds,
      words);
}

}  // namespace

// db [rows, words] u32 row-major (4-byte aligned; the exact instance needs
// load_row's alignment); roots [queries, chunks, 4] (16-byte aligned),
// t_roots [queries, chunks], cw_seed [queries, clog, 4], cw_t [queries, clog, 2]
// u32; out [queries, words] u32 zeroed by the caller; rows == chunks << clog.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported shape).
extern "C" int repro_fused_scan_xor(const uint32_t* db, const uint32_t* roots,
                                    const uint32_t* t_roots, const uint32_t* cw_seed,
                                    const uint32_t* cw_t, uint32_t* out,
                                    long long rows, int words, int queries,
                                    long long chunks, int clog, int rounds,
                                    void* stream) {
  if (words <= 0 || queries <= 0 || chunks <= 0 || clog < 0 || clog > kMaxClog ||
      (chunks << clog) != rows || rounds <= 0 || rounds % 2 ||
      !repro::aligned(db, 4) || !repro::aligned(roots, 16))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_EXACT(W_)                                                       \
  case W_:                                                                    \
    if (repro::aligned(db, repro::row_align<W_>())) {                         \
      launch<W_, true>(db, roots, t_roots, cw_seed, cw_t, out, chunks,        \
                       queries, clog, rounds, words, s);                      \
      return cudaGetLastError();                                              \
    }                                                                         \
    break;
  switch (words) {
    REPRO_EXACT(1) REPRO_EXACT(2) REPRO_EXACT(4) REPRO_EXACT(8) REPRO_EXACT(16)
    REPRO_EXACT(32)
    default: break;
  }
#undef REPRO_EXACT
  if (words <= 8)
    launch<8, false>(db, roots, t_roots, cw_seed, cw_t, out, chunks, queries,
                     clog, rounds, words, s);
  else if (words <= 16)
    launch<16, false>(db, roots, t_roots, cw_seed, cw_t, out, chunks, queries,
                      clog, rounds, words, s);
  else
    launch<32, false>(db, roots, t_roots, cw_seed, cw_t, out, chunks, queries,
                      clog, rounds, words, s);
  return cudaGetLastError();
}

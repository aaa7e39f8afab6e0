// Fused GGM-expand + select-XOR scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_scan.py _fused_xor_kernel (with
// _expand_tile, _interleave and kernels/ggm_expand.py _chacha_rows; the
// pallas_call in _fused_scan_xor_jit). From per-chunk GGM subtree roots it
// expands the last `clog` tree levels to leaf control bits t(j) and XORs
// the DB rows with t(j) != 0, so the selection vector never exists in
// device memory.
//
// Bound: operations at narrow rows, bytes at wide ones. A subtree of
// 2^clog leaves has 2^clog - 1 internal nodes, each one ChaCha12 block
// (576 ARX ops): each query costs about 576 integer ops per row, 18 per DB
// byte at 32-byte rows, and the batch shares one DB stream. The card issues
// about 10 int32 ops per byte of HBM bandwidth, so up to 128-byte rows the
// integer issue rate bounds the kernel; at 5,120 bytes and more the DB
// stream does (plus Q * R * W select ops, one LOP3 per query and word).
//
// Rows of 1 to 32 words (fused_scan_xor_kernel). One thread per (query,
// chunk root). The thread expands its 2^clog leaves depth first, keeping
// the right children of the current path on a clog-deep stack (4 seed words
// + t each) and ChaCha's state in registers; each internal node costs
// exactly one block, as in the breadth-first reference. Children follow
// _interleave's order (left child of leaf pair k is leaf 2k) and correction
// words apply masked by the parent's t (fused_scan.py:84-88): child ^= (0 -
// t) & cw, t_child = (blk[8 or 9] & 1) ^ (t & cw_t). A leaf with t != 0
// XORs its DB row, (c << clog) + j, into W registers. Queries are the
// fastest thread index, so the lanes of a warp that serve one chunk for
// different queries load the same row together and the DB streams from HBM
// about once per batch. Partials are reduced by shuffle-XOR across lanes of
// the same query, across warps in shared memory, then one atomicXor per (q,
// w). W in {1, 2, 4, 8, 16, 32} with the DB aligned for load_row<W> takes
// the exact instance (<W, true>: W accumulators, vector loads; at W = 32,
// 128-byte records, eight 16-byte loads per set leaf, which an allocation's
// 128-byte rows always allow). Any other W up to 32, or a DB only 4-byte
// aligned (a row slice), takes a column-group instance (<G, false>, G = 8,
// 16 or 32 >= W): the thread keeps G accumulators, of which the first W are
// live, and reads its row's W words one 4-byte load each. At W = 9 (36-byte
// records with a checksum column) that is one group of 16 accumulators, as
// at W = 16. <32, true> and <32, false> both take 78 registers on sm_90a (3
// blocks per SM), so at 2^23 rows and clog 11 the 512 blocks of a batch of
// 32 run in two waves; the vector loads alone took 128-byte rows from 10.67
// to 8.93 ms on an H100 80GB HBM3 at 700 W (PERF.md).
//
// Rows wider than 32 words (fused_scan_xor_wide_kernel<QB, kVec>). One
// thread per (query, chunk) would walk 2^clog leaves in series, read rows
// kilobytes apart and, past 32 words, expand every subtree again for each
// column group. Here a block owns a run of rows and every word of them, and
// expands each leaf once per launch:
//   * Rows. Each chunk's subtree is split `split` levels below its root into
//     subtrees of 2^d leaves (d = clog - split <= 12); a block takes `span`
//     consecutive subtrees, at most kWideRows rows. The host picks split so
//     that there are kSpread subtrees or more per resident block slot of
//     the card (occupancy x SMs) and span so that the blocks fill those
//     slots once.
//   * Expansion. For each (query, subtree) pair the block descends from the
//     chunk root to the subtree root (split ChaCha blocks a pair, repeated
//     for the pairs of one chunk: split 2^split / 2^clog of the leaves'
//     blocks), then its threads expand breadth first together, one node
//     per thread and level through a node buffer in shared memory, until
//     the level holds a node per thread; each thread then walks its one or
//     two frontier nodes depth first to the leaves (breadth first all the
//     way would need Q * 2^(d-1) seeds in shared memory: 256 KB at Q = 32,
//     d = 10). Children and corrections as above. A leaf's control bit goes
//     into its bit word in shared memory by atomicOr (bit q for query q of
//     the block's group of kGroup = 32), so the bits never reach device
//     memory.
//   * Scan. Threads own word columns across the row: 16 bytes (V = 4 words)
//     where W % 4 == 0 and the base is 16-byte aligned (kVec), a word
//     otherwise. A pass covers cu units of every row of the run, the units
//     split evenly over the passes, neighbouring threads on neighbouring
//     units, so each warp load is one 512-byte piece of one row (narrow
//     rows put rpb rows side by side). Loads run a group of kUnroll rows
//     ahead of the fold, unpredicated. Per row a thread reads the leaf's
//     bit word (a broadcast) and folds acc[q][w] ^= v[w] & (0 - bit q) for
//     its QB <= 8 queries, the mask a shift into the sign and back. A group
//     of more than 8 queries takes sub = ceil(min(Q, 32) / 8) threads per
//     unit, one per 8 queries, which read the same 16 bytes at about the
//     same time (from HBM once, then from L1); batches past 32 queries run
//     in groups of 32, the blocks of one row run adjacent in the grid.
//     __launch_bounds__(256, 2) holds every instance to 128 registers, two
//     blocks of 256 threads per SM: under the default bound ptxas gave the
//     8-query instances more registers and one block per SM, which ran
//     slower, and kept fewer loads in flight.
//   * Reduction. After each pass a thread XORs its partials into the zeroed
//     output, one atomicXor per nonzero (query, word): at most row runs x Q
//     x W a launch (repro_fused_scan_xor_wide_geometry). kVec partials pass
//     through a per-warp transpose in shared memory first, so that the 32
//     atomics of one instruction hit 32 consecutive words.
#include "common.cuh"

#include <algorithm>

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

// ---------------------------------------------------------------------------
// Rows wider than 32 words: see the header.

constexpr int kWideThreads = 256;   // most threads per block
constexpr int kWideRowsLog = 12;
constexpr int kWideRows = 1 << kWideRowsLog;  // most rows (bit words) a block scans
constexpr int kGroup = 32;          // queries per block: one bit word per leaf
constexpr int kMaxQB = 8;           // queries one thread folds (its accumulators)
constexpr int kSpread = 8;          // subtrees per resident block slot, at least

// The geometry the host picks for a launch (the kernel's only argument
// besides the pointers).
struct WideArgs {
  long long chunks;      // C
  long long subtrees;    // C << split
  int queries, words, clog, rounds;
  int split;             // levels from a chunk root down to a subtree root
  int span;              // subtrees per block
  int groups;            // query groups of kGroup
  int sub;               // query blocks (QB) of a group, one thread each
  int ts;                // threads per query block (a multiple of 32)
  int cu, rpb, npass;    // column units per pass, rows side by side, passes
};

// (s, t) at tree level `lvl` of the clog levels -> its left or right child.
__device__ __forceinline__ void child(uint32_t (&s)[4], uint32_t& t,
                                      const uint32_t* __restrict__ cws,
                                      const uint32_t* __restrict__ cwt,
                                      int lvl, bool right, int rounds) {
  uint32_t o[16];
  repro::chacha_block(o, s, 0u, rounds);
  const uint32_t m = 0u - t;
#pragma unroll
  for (int w = 0; w < 4; ++w)
    s[w] = (right ? o[4 + w] : o[w]) ^ (m & __ldg(cws + lvl * 4 + w));
  t = ((right ? o[9] : o[8]) & 1u) ^ (t & __ldg(cwt + lvl * 2 + right));
}

// Sets bit `qbit` of bits[leaf0 + j] for every leaf j of the `depth` levels
// below node (s, t) at tree level `lvl` whose control bit is 1, walking
// depth first with the right children of the current path on a stack.
__device__ __forceinline__ void walk_bits(uint32_t (&s)[4], uint32_t t,
                                          const uint32_t* __restrict__ cws,
                                          const uint32_t* __restrict__ cwt,
                                          int lvl, int depth, int rounds,
                                          uint32_t* bits, int leaf0,
                                          uint32_t qbit) {
  if (depth == 0) {
    if (t) atomicOr(bits + leaf0, qbit);
    return;
  }
  uint32_t stk_s[kWideRowsLog][4];
  uint32_t stk_t[kWideRowsLog];
  const int pairs = 1 << (depth - 1);
  int l = 0;
  for (int k = 0; k < pairs; ++k) {
    if (k) {                                  // resume at the last right turn
      const int r = depth - 2 - (__ffs(k) - 1);
#pragma unroll
      for (int w = 0; w < 4; ++w) s[w] = stk_s[r][w];
      t = stk_t[r];
      l = r + 1;
    }
    uint32_t o[16];
    for (; l < depth - 1; ++l) {              // descend to the pre-leaf level
      repro::chacha_block(o, s, 0u, rounds);
      const uint32_t m = 0u - t;
      const int a = lvl + l;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t cw = m & __ldg(cws + a * 4 + w);
        stk_s[l][w] = o[4 + w] ^ cw;
        s[w] = o[w] ^ cw;
      }
      stk_t[l] = (o[9] & 1u) ^ (t & __ldg(cwt + a * 2 + 1));
      t = (o[8] & 1u) ^ (t & __ldg(cwt + a * 2));
    }
    repro::chacha_block(o, s, 0u, rounds);   // children are leaves 2k, 2k+1
    const int a = lvl + depth - 1;
    if ((o[8] & 1u) ^ (t & __ldg(cwt + a * 2))) atomicOr(bits + leaf0 + 2 * k, qbit);
    if ((o[9] & 1u) ^ (t & __ldg(cwt + a * 2 + 1)))
      atomicOr(bits + leaf0 + 2 * k + 1, qbit);
  }
}

template <int QB, bool kVec>
__global__ void __launch_bounds__(kWideThreads, 2)
fused_scan_xor_wide_kernel(const uint32_t* __restrict__ db,
                           const uint32_t* __restrict__ roots,    // [Q, C, 4]
                           const uint32_t* __restrict__ t_roots,  // [Q, C]
                           const uint32_t* __restrict__ cw_seed,  // [Q, clog, 4]
                           const uint32_t* __restrict__ cw_t,     // [Q, clog, 2]
                           uint32_t* __restrict__ out,            // [Q, W]
                           const WideArgs a) {
  constexpr int V = kVec ? 4 : 1;
  __shared__ uint32_t bits[kWideRows];
  __shared__ uint4 node_s[2 * kWideThreads];
  __shared__ uint32_t node_t[2 * kWideThreads];
  __shared__ uint4 stage[kVec ? kWideThreads : 1];

  const int T = blockDim.x, tid = threadIdx.x;
  const int g = static_cast<int>(blockIdx.x % a.groups);
  const long long sub0 = static_cast<long long>(blockIdx.x / a.groups) * a.span;
  const int nspan = static_cast<int>(min(static_cast<long long>(a.span),
                                         a.subtrees - sub0));
  const int d = a.clog - a.split;
  const int nrows = nspan << d;
  const int q0 = g * kGroup;
  const int nq = min(kGroup, a.queries - q0);
  const int n0 = nq * nspan;                  // (query, subtree) pairs
  for (int i = tid; i < nrows; i += T) bits[i] = 0u;

  // pair n = ql * nspan + sl: the root of subtree sub0 + sl for query q0 + ql
  auto subtree_root = [&](int n, uint32_t (&s)[4], uint32_t& t) {
    const int ql = n / nspan;
    const long long sub = sub0 + n % nspan;
    const long long c = sub >> a.split;
    const long long qc = static_cast<long long>(q0 + ql) * a.chunks + c;
    const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(roots) + qc);
    s[0] = r0.x; s[1] = r0.y; s[2] = r0.z; s[3] = r0.w;
    t = __ldg(t_roots + qc);
    const uint32_t* cws = cw_seed + static_cast<long long>(q0 + ql) * a.clog * 4;
    const uint32_t* cwt = cw_t + static_cast<long long>(q0 + ql) * a.clog * 2;
    for (int i = 0; i < a.split; ++i)
      child(s, t, cws, cwt, i, (sub >> (a.split - 1 - i)) & 1, a.rounds);
  };
  // node n of breadth-first level l: query ql, leaves from pos << (d - l)
  auto walk_node = [&](int n, int l, uint32_t (&s)[4], uint32_t t) {
    const int ql = (n >> l) / nspan;
    const int pos = n - ql * (nspan << l);
    walk_bits(s, t, cw_seed + static_cast<long long>(q0 + ql) * a.clog * 4,
              cw_t + static_cast<long long>(q0 + ql) * a.clog * 2, a.split + l,
              d - l, a.rounds, bits, pos << (d - l), 1u << ql);
  };
  __syncthreads();

  if (n0 >= T) {                              // a pair per thread at least
    for (int n = tid; n < n0; n += T) {
      uint32_t s[4], t;
      subtree_root(n, s, t);
      walk_node(n, 0, s, t);
    }
  } else {
    if (tid < n0) {
      uint32_t s[4], t;
      subtree_root(tid, s, t);
      node_s[tid] = make_uint4(s[0], s[1], s[2], s[3]);
      node_t[tid] = t;
    }
    int l = 0, count = n0;
    __syncthreads();
    while (count < T && l < d) {              // breadth first, together
      const bool live = tid < count;
      uint4 ns = make_uint4(0u, 0u, 0u, 0u);
      uint32_t t = 0u;
      if (live) {
        ns = node_s[tid];
        t = node_t[tid];
      }
      __syncthreads();
      if (live) {
        const int ql = (tid >> l) / nspan;
        const uint32_t* cws = cw_seed + static_cast<long long>(q0 + ql) * a.clog * 4;
        const uint32_t* cwt = cw_t + static_cast<long long>(q0 + ql) * a.clog * 2;
        const int lvl = a.split + l;
        const uint32_t s[4] = {ns.x, ns.y, ns.z, ns.w};
        uint32_t o[16];
        repro::chacha_block(o, s, 0u, a.rounds);
        const uint32_t m = 0u - t;
        uint32_t cw[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) cw[w] = m & __ldg(cws + lvl * 4 + w);
        node_s[2 * tid] = make_uint4(o[0] ^ cw[0], o[1] ^ cw[1], o[2] ^ cw[2],
                                     o[3] ^ cw[3]);
        node_s[2 * tid + 1] = make_uint4(o[4] ^ cw[0], o[5] ^ cw[1],
                                         o[6] ^ cw[2], o[7] ^ cw[3]);
        node_t[2 * tid] = (o[8] & 1u) ^ (t & __ldg(cwt + lvl * 2));
        node_t[2 * tid + 1] = (o[9] & 1u) ^ (t & __ldg(cwt + lvl * 2 + 1));
      }
      __syncthreads();
      count <<= 1;
      ++l;
    }
    for (int n = tid; n < count; n += T) {    // then depth first, alone
      const uint4 ns = node_s[n];
      uint32_t s[4] = {ns.x, ns.y, ns.z, ns.w};
      walk_node(n, l, s, node_t[n]);
    }
  }
  __syncthreads();

  // the scan: thread (h, rl, cl) folds queries q0 + h QB + [0, QB) of rows
  // rl, rl + rpb, ... at unit p cu + cl
  constexpr int kUnroll = QB <= 4 ? 8 : 4;   // rows loaded ahead of the fold
  const int units = a.words / V;
  const int h = tid / a.ts, rl = tid % a.ts / a.cu, cl = tid % a.ts % a.cu;
  const int qoff = h * QB;
  const long long row0 = (sub0 << d) * a.words;
  const int warp = tid / 32, lane = tid % 32;
  for (int p = 0; p < a.npass; ++p) {
    const int u = p * a.cu + cl;
    uint32_t acc[QB][V];
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int w = 0; w < V; ++w) acc[q][w] = 0u;
    if (rl < a.rpb && u < units) {
      // rows j = rl, rl + rpb, ... < nrows: groups of kUnroll rows, each
      // loaded while the one before it is folded, then the rows left over
      const long long stride = static_cast<long long>(a.rpb) * a.words;
      const uint32_t* row = db + row0 + rl * static_cast<long long>(a.words) +
                            static_cast<long long>(u) * V;
      const int group = kUnroll * a.rpb;
      uint32_t nv[kUnroll][V];
      const auto load = [&](const uint32_t* at) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if constexpr (kVec) {
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(at + k * stride));
            nv[k][0] = x.x; nv[k][1] = x.y; nv[k][2] = x.z; nv[k][3] = x.w;
          } else {
            nv[k][0] = __ldg(at + k * stride);
          }
        }
      };
      const auto fold = [&](const uint32_t (&x)[V], uint32_t b) {
#pragma unroll
        for (int q = 0; q < QB; ++q) {
          // 0 - bit q of b, as a shift into the sign and back
          const uint32_t m = static_cast<uint32_t>(
              static_cast<int32_t>(b << (31 - q)) >> 31);
#pragma unroll
          for (int w = 0; w < V; ++w) acc[q][w] ^= x[w] & m;
        }
      };
      const int full = nrows - (kUnroll - 1) * a.rpb;   // j < full: a whole group
      int j = rl;
      if (j < full) load(row);
      for (; j < full; j += group) {
        uint32_t v[kUnroll][V], b[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
          for (int w = 0; w < V; ++w) v[k][w] = nv[k][w];
          b[k] = bits[j + k * a.rpb] >> qoff;
        }
        row += kUnroll * stride;
        if (j + group < full) load(row);
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) fold(v[k], b[k]);
      }
      for (; j < nrows; j += a.rpb, row += stride) {
        uint32_t x[V];
        if constexpr (kVec) {
          const uint4 y = __ldg(reinterpret_cast<const uint4*>(row));
          x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
        } else {
          x[0] = __ldg(row);
        }
        fold(x, bits[j] >> qoff);
      }
    }
    // the flush's addresses hang on these two values, so that ptxas cannot
    // compute them before the scan (it did, and spilled them)
    int pass_col = p * a.cu;
    uint32_t* orow = out + static_cast<long long>(q0 + qoff) * a.words;
    asm volatile("" : "+r"(pass_col), "+l"(orow));
    // partials into the zeroed output, one atomicXor per nonzero word
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (qoff + q >= nq) break;
      uint32_t* o = orow + static_cast<long long>(q) * a.words;
      if constexpr (kVec) {
        // thread tid's words are 4 (p cu + tid % cu) + 0..3; through the
        // warp's 128 staged words lane l sends word e = 32 i + l of them
        __syncwarp();
        stage[tid] = make_uint4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
        __syncwarp();
        const uint32_t* st = reinterpret_cast<const uint32_t*>(stage + warp * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 32 * i + lane;
          const uint32_t x = st[e];
          const int src = (warp * 32 + e / 4) % a.ts;
          if (x) atomicXor(o + (pass_col + src % a.cu) * 4 + e % 4, x);
        }
      } else {
        if (acc[q][0]) atomicXor(o + pass_col + cl, acc[q][0]);
      }
    }
  }
}

// A launch of the wide instance: its geometry, block size and grid.
struct WideLaunch {
  WideArgs a;
  int threads;
  long long blocks;
};

// Picks the block shape and the rows per block of the <QB, kVec> instance
// for W > 32 words: one block per resident slot of the card (the instance's
// occupancy x SMs), split evenly over the row runs of each query group.
template <int QB, bool kVec>
cudaError_t wide_launch(WideLaunch& w, long long chunks, int queries, int clog,
                        int rounds, int words) {
  WideArgs& a = w.a;
  a = WideArgs{};
  a.chunks = chunks;
  a.queries = queries;
  a.words = words;
  a.clog = clog;
  a.rounds = rounds;
  const int units = words / (kVec ? 4 : 1);
  a.groups = (queries + kGroup - 1) / kGroup;
  a.sub = (std::min(queries, kGroup) + QB - 1) / QB;
  const int ts_max = kWideThreads / a.sub / 32 * 32;
  a.npass = (units + ts_max - 1) / ts_max;
  a.cu = (units + a.npass - 1) / a.npass;
  a.rpb = ts_max / a.cu;
  a.ts = (a.rpb * a.cu + 31) / 32 * 32;
  w.threads = a.sub * a.ts;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_scan_xor_wide_kernel<QB, kVec>, w.threads, 0);
  if (err != cudaSuccess) return err;
  const long long want = std::max(1LL, static_cast<long long>(sms) *
                                           std::max(per_sm, 1) / a.groups);
  a.split = std::max(0, clog - kWideRowsLog);
  while (a.split < clog && (chunks << a.split) < kSpread * want) ++a.split;
  a.subtrees = chunks << a.split;
  a.span = static_cast<int>(std::min<long long>(
      (a.subtrees + want - 1) / want, kWideRows >> (clog - a.split)));
  w.blocks = (a.subtrees + a.span - 1) / a.span * a.groups;
  return w.blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

#define REPRO_WIDE_PARAMS                                                    \
  const uint32_t *db, const uint32_t *roots, const uint32_t *t_roots,        \
      const uint32_t *cw_seed, const uint32_t *cw_t, uint32_t *out,          \
      long long chunks, int queries, int clog, int rounds, int words,        \
      bool launch, cudaStream_t stream, WideLaunch &w
#define REPRO_WIDE_ARGS                                                      \
  db, roots, t_roots, cw_seed, cw_t, out, chunks, queries, clog, rounds,     \
      words, launch, stream, w

// The <QB, kVec> instance's launch, launched on `stream` when `launch`.
template <int QB, bool kVec>
cudaError_t wide_qb(REPRO_WIDE_PARAMS) {
  const cudaError_t err =
      wide_launch<QB, kVec>(w, chunks, queries, clog, rounds, words);
  if (err != cudaSuccess || !launch) return err;
  fused_scan_xor_wide_kernel<QB, kVec>
      <<<static_cast<unsigned>(w.blocks), w.threads, 0, stream>>>(
          db, roots, t_roots, cw_seed, cw_t, out, w.a);
  return cudaGetLastError();
}

// The query block: the least of 1, 2, 4, 8 that holds the batch, else 8
// (up to four threads per column unit for a group of 32 queries).
template <bool kVec>
cudaError_t wide_vec(REPRO_WIDE_PARAMS) {
  if (queries <= 1) return wide_qb<1, kVec>(REPRO_WIDE_ARGS);
  if (queries <= 2) return wide_qb<2, kVec>(REPRO_WIDE_ARGS);
  if (queries <= 4) return wide_qb<4, kVec>(REPRO_WIDE_ARGS);
  return wide_qb<kMaxQB, kVec>(REPRO_WIDE_ARGS);
}

// The wide instance for this batch and DB (vec: 16-byte loads).
cudaError_t wide(bool vec, REPRO_WIDE_PARAMS) {
  return vec ? wide_vec<true>(REPRO_WIDE_ARGS) : wide_vec<false>(REPRO_WIDE_ARGS);
}

#undef REPRO_WIDE_PARAMS
#undef REPRO_WIDE_ARGS

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
  if (words > 32) {
    WideLaunch w;
    return wide(words % 4 == 0 && repro::aligned(db, 16), db, roots, t_roots,
                cw_seed, cw_t, out, chunks, queries, clog, rounds, words, true,
                s, w);
  }
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

// The grid the wide instance (words > 32) takes for a batch, without a
// launch: blocks (row runs x query groups), threads per block, subtree
// split and subtrees per block into geometry[0..3], for reports (the global
// atomicXors of a launch are at most row runs x queries x words).
// vec: the DB is 16-byte aligned. Returns a CUDA error code.
extern "C" int repro_fused_scan_xor_wide_geometry(int words, int queries,
                                                  long long chunks, int clog,
                                                  int vec,
                                                  long long* geometry) {
  if (words <= 32 || queries <= 0 || chunks <= 0 || clog < 0 ||
      clog > kMaxClog)
    return cudaErrorInvalidValue;
  WideLaunch w;
  const cudaError_t err = wide(vec && words % 4 == 0, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, chunks, queries, clog,
                               12, words, false, nullptr, w);
  if (err != cudaSuccess) return err;
  geometry[0] = w.blocks;
  geometry[1] = w.threads;
  geometry[2] = w.a.split;
  geometry[3] = w.a.span;
  return cudaSuccess;
}

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
// Widths up to 64 bytes: L in {4, 8, 16, 32} with the DB aligned for
// load_row<L/4> takes the exact instance (<L, true>). Any other L up to 64
// (a multiple of 4), or a DB only 4-byte aligned, takes a one-group
// instance (<G, false>, G = 16, 48 or 64 bytes): G accumulators, the first
// L live, rows read one 4-byte word at a time. At L = 36 (32-byte records
// with a checksum word) that is G = 48. Its partials meet in one shared
// [32, G] array by shared atomicAdd, since a [warps, 32, G] array as the
// exact instance keeps would pass 48 KB at G = 48.
//
// Wider rows take the split instance (fused_scan_add_split_kernel), which
// expands each leaf once whatever the width. P neighbouring lanes (the least
// power of two with 32 P >= L: 4 at 68-128 bytes, 8 up to 256, at most 32)
// share one (query, chunk), lane p owning the columns [32 p, 32 p + 32).
// Lane p descends the first log2 P levels of the chunk's subtree towards
// child p (every lane computes those blocks: log2 P per lane against
// 2^clog / P leaves, 0.8 % at clog = 10, P = 4), then walks its own
// sub-subtree depth first. Per step each lane turns its two leaves into
// shares, the P lanes trade them by a width-P shuffle, and each lane adds
// all 2P leaves' rows at its own columns, four leaves per __dp4a. So every
// leaf's ChaCha blocks are computed once up to 32 * 32 = 1024 bytes; a
// wider row is summed in passes of 1024 bytes, each walking the subtrees
// again. Two choices hold it near the ChaCha bound: 32 accumulators per
// lane (64 took 173-228 registers, one block per SM; 32 take at most 128,
// two blocks), and the select-add by byte transpose + __dp4a (8 PRMT + 4
// IDP4A per 16 byte-products, where extract + IMAD takes 32 ALU and FMA
// ops). Rows are read in 16-byte loads where L % 16 == 0 and the DB is
// 16-byte aligned (<true>), a word at a time otherwise (<false>). A warp
// holds 32 / P queries of one chunk, so its lanes still read the same rows
// together. Where clog < log2 P, a lane past the chunk's 2^clog leaves owns
// none and sends share 0. Partials are reduced as the one-group instance's,
// by (query, column group).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClog = 24;
constexpr int kSplitBytes = 32;    // columns one lane of the split kernel sums
constexpr int kMaxLanesLog = 5;    // at most 32 lanes share a (query, chunk)

// acc += int8(share(seed, t)) * int8(row) over the row's L bytes; the
// accumulators are unsigned so that their wraparound is defined.
// The exact instance reads the whole row (L = G bytes) in vector loads; a
// one-group instance reads its nb bytes (a multiple of 4) from byte col0
// (0) on, one word at a time, in a row of `cols` bytes.
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
  // col0 is 0 (the grid has one z slice, and cols <= G); it stays a runtime
  // value because folding it to the constant gave the G = 48 instance 14
  // more registers and cost it 7 % at 36 bytes on an H100
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

// The leaf's Z_256 share as a byte (0..255, read as int8 by the caller).
__device__ __forceinline__ uint32_t leaf_share(const uint32_t (&seed)[4],
                                               uint32_t t, uint32_t cwf,
                                               int party, int rounds) {
  uint32_t o[16];
  repro::chacha_block(o, seed, 1u, rounds);
  uint32_t share = ((o[0] & 0xFFu) + t * cwf) & 0xFFu;
  if (party) share = (256u - share) & 0xFFu;
  return share;
}

// Walks the `depth` (>= 1) levels below the node (s, t) depth first, with
// the right children of the current path on a stack; cws [depth, 4] and
// cwt [depth, 2] are those levels' correction words. Calls
// leaves(k, sl, tl, sr, tr) for the k-th pair of sibling leaves (2k, 2k+1).
// fused_scan_add_kernel keeps its own copy of this loop and of leaf_share:
// a version routed through these (with its column offset folded to 0)
// spilled in the G = 64 instance and ran G = 48 3 % slower on an H100.
template <class Leaves>
__device__ __forceinline__ void walk(uint32_t (&s)[4], uint32_t t,
                                     const uint32_t* __restrict__ cws,
                                     const uint32_t* __restrict__ cwt,
                                     int depth, int rounds, Leaves&& leaves) {
  uint32_t stk_s[kMaxClog][4];
  uint32_t stk_t[kMaxClog];
  const long long pairs = 1LL << (depth - 1);
  int lvl = 0;
  for (long long k = 0; k < pairs; ++k) {
    if (k) {                                  // resume at the last right turn
      const int l = depth - 2 - (__ffsll(k) - 1);
#pragma unroll
      for (int w = 0; w < 4; ++w) s[w] = stk_s[l][w];
      t = stk_t[l];
      lvl = l + 1;
    }
    uint32_t o[16];
    for (; lvl < depth - 1; ++lvl) {          // descend to the pre-leaf level
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
    const int last = depth - 1;
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
    leaves(k, sl, tl, sr, tr);
  }
}

// acc[l] += sum over j < 4 of int8(sh[j]) * int8(rows[j][l]) for the lane's
// kSplitBytes columns of four rows (its first nb live): per 4-byte word of
// the four rows, a byte transpose by 8 PRMTs puts each column's four bytes
// in one word, and one __dp4a against the four packed shares adds them.
template <bool kVec>
__device__ __forceinline__ void add_rows4(uint32_t (&acc)[kSplitBytes],
                                          const uint32_t* const (&rows)[4],
                                          const uint32_t (&sh)[4], int nb) {
#pragma unroll
  for (int i = 0; i < kSplitBytes / 16; ++i) {     // 16-byte pieces
    uint32_t w[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (kVec) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (16 * i < nb) v = __ldg(reinterpret_cast<const uint4*>(rows[j]) + i);
        w[j][0] = v.x; w[j][1] = v.y; w[j][2] = v.z; w[j][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w[j][c] = 4 * (4 * i + c) < nb ? __ldg(rows[j] + 4 * i + c) : 0u;
      }
    }
    const int pack = static_cast<int>(sh[0] | (sh[1] << 8) | (sh[2] << 16) |
                                      (sh[3] << 24));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t a01 = __byte_perm(w[0][c], w[1][c], 0x5140);
      const uint32_t b01 = __byte_perm(w[0][c], w[1][c], 0x7362);
      const uint32_t a23 = __byte_perm(w[2][c], w[3][c], 0x5140);
      const uint32_t b23 = __byte_perm(w[2][c], w[3][c], 0x7362);
      const uint32_t col[4] = {__byte_perm(a01, a23, 0x5410),
                               __byte_perm(a01, a23, 0x7632),
                               __byte_perm(b01, b23, 0x5410),
                               __byte_perm(b01, b23, 0x7632)};
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[16 * i + 4 * c + b] = static_cast<uint32_t>(__dp4a(
            static_cast<int>(col[b]), pack, static_cast<int>(acc[16 * i + 4 * c + b])));
    }
  }
}

// One step of the split kernel: this lane's shares sh0, sh1 of its k-th
// leaf pair (per = 2; per = 1: its one leaf, sh1 unused) traded with the
// `lanes` lanes of its (query, chunk) in `seg`; adds the step's n leaves'
// rows at the lane's columns. Entry e is leaf e % per of lane e / per, row
// base + ((e / per) << sub) + 2k + e % per; entries are padded to a
// multiple of 4 with share 0.
template <bool kVec>
__device__ __forceinline__ void add_step(uint32_t (&acc)[kSplitBytes],
                                         const uint32_t* cols0, long long stride,
                                         long long base, long long k, int sub,
                                         int per, int n, unsigned seg,
                                         int lanes, uint32_t sh0, uint32_t sh1,
                                         int nb) {
  for (int e0 = 0; e0 < n; e0 += 4) {
    uint32_t sh[4];
    const uint32_t* rows[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j;
      const int src = e >> (per - 1), leaf = e & (per - 1);
      sh[j] = __shfl_sync(seg, leaf ? sh1 : sh0, src, lanes);
      long long row =
          base + (static_cast<long long>(src) << sub) + 2 * k + leaf;
      if (e >= n) {
        sh[j] = 0u;
        row = base;
      }
      rows[j] = cols0 + row * stride;
    }
    add_rows4<kVec>(acc, rows, sh, nb);
  }
}

// L > 64: P = 1 << lanes_log lanes per (query, chunk), lane p summing the
// columns [32 p, 32 p + 32) of every leaf's row (of each 32 P-byte pass).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_scan_add_split_kernel(const uint32_t* __restrict__ db,
                            const uint32_t* __restrict__ roots,
                            const uint32_t* __restrict__ t_roots,
                            const uint32_t* __restrict__ cw_seed,
                            const uint32_t* __restrict__ cw_t,
                            const uint32_t* __restrict__ cw_final,
                            uint32_t* __restrict__ out, long long chunks,
                            int queries, int group, int lanes_log, int clog,
                            int rounds, int party, int cols) {
  const int P = 1 << lanes_log;
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int p = static_cast<int>(gid & (P - 1));
  const long long slot = gid >> lanes_log;
  const int q = blockIdx.y * group + static_cast<int>(slot % group);
  const long long c = slot / group;
  const int lane = threadIdx.x % 32;
  // the P lanes of this (query, chunk): all live or all idle together
  const unsigned seg = P == 32 ? 0xffffffffu
                               : ((1u << P) - 1u) << (lane & ~(P - 1));
  const bool live = q < queries && c < chunks;
  const int m = min(lanes_log, clog);   // levels lane p descends alone
  const int sub = clog - m;             // levels of its own sub-subtree
  const int per = sub ? 2 : 1;          // leaves per lane and step
  const int n = per << m;               // leaves per step of the P lanes
  __shared__ uint32_t part[32 * kSplitBytes];

  for (int pass = 0; pass < cols; pass += kSplitBytes * P) {
    const int col0 = pass + kSplitBytes * p;
    const int nb = max(0, min(kSplitBytes, cols - col0));
    uint32_t acc[kSplitBytes];
#pragma unroll
    for (int l = 0; l < kSplitBytes; ++l) acc[l] = 0u;

    if (live) {
      const long long qc = static_cast<long long>(q) * chunks + c;
      const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(roots) + qc);
      uint32_t s[4] = {r0.x, r0.y, r0.z, r0.w};
      uint32_t t = __ldg(t_roots + qc);
      const uint32_t cwf = __ldg(cw_final + q) & 0xFFu;
      const uint32_t* cws = cw_seed + static_cast<long long>(q) * clog * 4;
      const uint32_t* cwt = cw_t + static_cast<long long>(q) * clog * 2;
      const long long base = c << clog;
      const uint32_t* cols0 = db + col0 / 4;     // the lane's group in row 0
      const long long stride = cols / 4;
      for (int i = 0; i < m; ++i) {              // the path to child p
        uint32_t o[16];
        repro::chacha_block(o, s, 0u, rounds);
        const int b = (p >> (m - 1 - i)) & 1;
        const uint32_t msk = 0u - t;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          s[w] = (b ? o[4 + w] : o[w]) ^ (msk & __ldg(cws + i * 4 + w));
        t = ((b ? o[9] : o[8]) & 1u) ^ (t & __ldg(cwt + i * 2 + b));
      }
      if (sub == 0) {
        // clog <= log2 P: one leaf per lane, none past the chunk's 2^clog
        add_step<kVec>(acc, cols0, stride, base, 0, 0, 1, n, seg, P,
                       p < (1 << m) ? leaf_share(s, t, cwf, party, rounds) : 0u,
                       0u, nb);
      } else {
        walk(s, t, cws + m * 4, cwt + m * 2, sub, rounds,
             [&](long long k, const uint32_t (&sl)[4], uint32_t tl,
                 const uint32_t (&sr)[4], uint32_t tr) {
               add_step<kVec>(acc, cols0, stride, base, k, sub, 2, n, seg, P,
                              leaf_share(sl, tl, cwf, party, rounds),
                              leaf_share(sr, tr, cwf, party, rounds), nb);
             });
      }
    }

    // lanes l and l ^ off hold the same (query, column group) when
    // off >= P * group
#pragma unroll
    for (int l = 0; l < kSplitBytes; ++l)
      for (int off = 16; off >= P * group; off >>= 1)
        acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], off);

    const int held = P * group * kSplitBytes;    // part[lane][l], lane < P * group
    for (int i = threadIdx.x; i < held; i += kThreads) part[i] = 0u;
    __syncthreads();
    if (lane < P * group) {
#pragma unroll
      for (int l = 0; l < kSplitBytes; ++l)
        if (l < nb && acc[l]) atomicAdd(part + lane * kSplitBytes + l, acc[l]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < held; i += kThreads) {
      const int ln = i / kSplitBytes;
      const int qq = blockIdx.y * group + (ln >> lanes_log);
      const int col = pass + kSplitBytes * (ln & (P - 1)) + i % kSplitBytes;
      const uint32_t v = part[i];
      if (qq < queries && col < cols && v)
        atomicAdd(out + static_cast<long long>(qq) * cols + col, v);
    }
    __syncthreads();                             // part is reused next pass
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
                  static_cast<unsigned>((queries + group - 1) / group));
  fused_scan_add_kernel<G, kExact><<<grid, kThreads, 0, stream>>>(
      db, roots, t_roots, cw_seed, cw_t, cw_final, out, chunks, queries, group,
      clog, rounds, party, cols);
}

template <bool kVec>
void launch_split(const uint32_t* db, const uint32_t* roots,
                  const uint32_t* t_roots, const uint32_t* cw_seed,
                  const uint32_t* cw_t, const uint32_t* cw_final, uint32_t* out,
                  long long chunks, int queries, int clog, int rounds, int party,
                  int cols, cudaStream_t stream) {
  int lanes_log = 1;                // the least P = 2^lanes_log with 32 P >= L
  while ((kSplitBytes << lanes_log) < cols && lanes_log < kMaxLanesLog)
    ++lanes_log;
  const int lanes = 1 << lanes_log;
  int group = 1;                    // queries per warp slice: group * P <= 32
  while (group < queries && group * lanes < 32) group <<= 1;
  const long long threads = chunks * group * lanes;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((queries + group - 1) / group));
  fused_scan_add_split_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      db, roots, t_roots, cw_seed, cw_t, cw_final, out, chunks, queries, group,
      lanes_log, clog, rounds, party, cols);
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
  else if (cols <= 64)
    launch<64, false>(d, roots, t_roots, cw_seed, cw_t, cw_final, o, chunks,
                      queries, clog, rounds, party, cols, s);
  else if (cols % 16 == 0 && repro::aligned(d, 16))
    launch_split<true>(d, roots, t_roots, cw_seed, cw_t, cw_final, o, chunks,
                       queries, clog, rounds, party, cols, s);
  else
    launch_split<false>(d, roots, t_roots, cw_seed, cw_t, cw_final, o, chunks,
                        queries, clog, rounds, party, cols, s);
  return cudaGetLastError();
}

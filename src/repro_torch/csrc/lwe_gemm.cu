// Wrapping int32 GEMM of the single-server LWE scheme, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pir_matmul.py _matmul_kernel as reached
// through lwe_matmul (pir_matmul.py:103; its pallas_call at :147, entry
// ops.lwe_gemm). Computes out[m, p] = sum over k of a[m, k] * b[k, p] for
// row-major int32 operands a [M, K] and b [K, P], modulo 2^32: the Z_q
// contraction of lwe-simple-1 with q = 2^32, bit for bit.
//
// The port calls it at three shapes:
//   answer  ct [Q, N] x bytes32 [N, L]   M = Q <= 32, K = N, P = L = 32, or
//           36 with the checksum column (the served path; N = 2^22 at
//           PIR_128M_LWE)
//   hint    D^T [L, N] x A [N, n]        M = L = 32 or 36, K = N, P = n = 1024
//   client  A [N, n] x S^T [n, Q]        M = N, K = n = 1024, P = Q
//
// Bound (fixed before the first timing; peaks: NVIDIA H100 SXM data sheet,
// 3.35 TB/s HBM3, 132 SMs at 1.98 GHz, and 64 32-bit IMADs per clock per SM
// from the CUDA guide's throughput table for compute capability 9.0).
// Hopper's tensor cores have no int32 MMA, so this is CUDA-core IMAD work.
//   answer, Q = 1:  (Q*K*4 + K*P*4 + Q*P*4) B = 553,648,256 B -> 0.1653 ms
//                   over HBM; 1.3e8 IMADs take 0.008 ms: bytes-bound.
//   answer, Q = 32: 1,073,745,920 B -> 0.3205 ms; Q*K*P = 4.29e9 IMADs over
//                   132 * 64 * 1.98e9 /s -> 0.2570 ms: bytes-bound, close.
//                   At P = 36: 1,140,855,296 B -> 0.3406 ms.
//   hint and client at Q = 32: 1.37e11 IMADs each -> 8.2 ms: operations;
//                   the hint at M = 36 9.244 ms.
//
// Design. The Pallas program keeps each [TQ, TL] output block in VMEM
// across a sequential R grid axis. Here blocks run in parallel, so K is
// split: grid.y blocks stride over K in tiles of 64, and grid.x covers
// (M tile, 32-column tile) pairs, the column tile fastest, so the blocks
// that read the same slab of a run together and find it in L2. A block stages
// each tile in shared memory, double-buffered: the [BM, 64] slab of a as
// 16-byte loads and the [64, 32] slab of b as 4-byte loads (one 128-byte
// row segment per warp instruction), both coalesced; the next tile's loads
// are issued into registers before the current tile is used, so every
// thread keeps its loads in flight while it computes. In the compute step
// lane l of every warp owns column p0 + l, and warp w takes k = 4w .. 4w+3
// and 32 + 4w .. 32 + 4w + 3 of the tile: it reads b[k][l] and, for each of
// the block's BM rows, a[m][k .. k+3] as one 16-byte shared load that all
// lanes read (a broadcast), and takes 4 IMADs into acc[m]. The 8 warps'
// [BM, 32] partials fold in shared memory, and one atomicAdd per (m, p)
// adds the block's sum into the zeroed output (a plain store when K is not
// split). Accumulators are unsigned, so the wraparound is defined, and
// addition mod 2^32 does not depend on order, so the atomics' order cannot
// change a bit.
//
// Tiles (lwe_gemm_kernel<BM>): BM is the smallest power of two >= M, up to
// 32, so an answer of Q queries reads the DB once; P in 32-column tiles.
// The checksum width (36 = 32 + 4) fits two more tiles, so no second tile
// of 4 live lines costs a whole tile:
//   lwe_gemm_tall_kernel<40>       33 <= M <= 40 (the hint at M = 36): one
//       M tile, so b (A, 16 GiB) streams from HBM once; the IMAD loop skips
//       rows at or past M with a block-uniform branch. Past 40, 32-row tiles.
//   lwe_gemm_wide_kernel<BM, RW>   33 <= P <= 40, whatever M (the answer at
//       P = 36; a client's A.S^T for a batch of 33 to 40 queries, in 32-row
//       M tiles): one block holds all P columns, so a's slab is staged
//       once; the RW = 4 or 8 remainder columns (P - 32 live) are staged
//       beside b's first 32, and lane l sums column 32 + l % RW over its
//       group's share of the block's rows and of its warp's 8 k (kRows
//       accumulators, 4 or 8 at BM = 32), skewed so the groups read
//       different banks; a shuffle folds the groups that split k. Past 40,
//       32-column tiles.
// Both stage through cp.async instead of registers: with register staging
// they took more than 128 registers (one block per SM on sm_90a), or
// spilled under a 128-register bound. The client product at up to 32 or
// past 40 queries keeps lwe_gemm_kernel<32>.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 64;                    // k per tile
constexpr int kVecK = kTileK / 4;             // 16-byte vectors per a row
constexpr int kWarpK = kTileK / kWarps;       // k per warp in the remainder

// `kBytes` (16 or 4) from global to shared memory without passing through
// registers (cp.async), or zeros where `full` is false (no global read).
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 4 : 0));
}

// Waits for this thread's copy_async calls.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BM>
struct Tile {
  // a slab: BM rows x kTileK values; b slab: kTileK rows x 32 columns
  static constexpr int kAVecs = BM * kVecK;
  static constexpr int kAPerThread = (kAVecs + kThreads - 1) / kThreads;
  static constexpr int kBPerThread = kTileK * 32 / kThreads;
  uint4 a[kAPerThread];
  uint32_t b[kBPerThread];

  // Issue the global loads of tile `t` (zeros past M, K or P).
  __device__ __forceinline__ void load(const uint32_t* __restrict__ ga,
                                       const uint32_t* __restrict__ gb,
                                       long long m0, long long m_rows,
                                       long long k_len, int p0, int p_cols,
                                       long long t) {
    const long long k0 = t * kTileK;
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int m = v / kVecK, kv = v % kVecK;
      const long long k = k0 + 4 * kv;
      a[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kAVecs && m0 + m < m_rows && k < k_len)
        a[i] = __ldg(reinterpret_cast<const uint4*>(ga + (m0 + m) * k_len + k));
    }
    const int col = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < kBPerThread; ++i) {
      const long long k = k0 + threadIdx.x / 32 + i * kWarps;
      b[i] = (k < k_len && p0 + col < p_cols)
                 ? __ldg(gb + k * p_cols + p0 + col) : 0u;
    }
  }

  __device__ __forceinline__ void store(uint4 (*sa)[kVecK],
                                        uint32_t (*sb)[32]) const {
#pragma unroll
    for (int i = 0; i < kAPerThread; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < kAVecs) sa[v / kVecK][v % kVecK] = a[i];
    }
#pragma unroll
    for (int i = 0; i < kBPerThread; ++i)
      sb[threadIdx.x / 32 + i * kWarps][threadIdx.x % 32] = b[i];
  }
};

// Tile<BM>'s tile `t` straight into shared memory by copy_async, holding
// no registers while it lands, and b's RW remainder columns 32 .. 32 + RW
// into sr [kTileK, RW] (zeros past M, K or P).
template <int BM, int RW>
__device__ __forceinline__ void copy_tile(
    const uint32_t* __restrict__ ga, const uint32_t* __restrict__ gb,
    long long m0, long long m_rows, long long k_len, int p0, int p_cols,
    long long t, uint4 (*sa)[kVecK], uint32_t (*sb)[32], uint32_t* sr) {
  using T = Tile<BM>;
  const long long k0 = t * kTileK;
#pragma unroll
  for (int i = 0; i < T::kAPerThread; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int m = v / kVecK, kv = v % kVecK;
    const long long k = k0 + 4 * kv;
    const bool full = m0 + m < m_rows && k < k_len;
    if (v < T::kAVecs)
      copy_async<16>(&sa[m][kv], full ? ga + (m0 + m) * k_len + k : ga, full);
  }
  const int col = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < T::kBPerThread; ++i) {
    const int row = threadIdx.x / 32 + i * kWarps;
    const long long k = k0 + row;
    const bool full = k < k_len && p0 + col < p_cols;
    copy_async<4>(&sb[row][col], full ? gb + k * p_cols + p0 + col : gb, full);
  }
#pragma unroll
  for (int i = 0; i < kTileK * RW / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const long long k = k0 + e / RW;
    const int c = 32 + e % RW;
    const bool full = k < k_len && c < p_cols;
    copy_async<4>(sr + e, full ? gb + k * p_cols + c : gb, full);
  }
}

// One block's share of out[m0 .. m0 + BM, p0 .. p0 + 32 + RW): its k tiles
// t = blockIdx.y, blockIdx.y + gridDim.y, ...
template <int BM, int RW>
__device__ __forceinline__ void gemm_block(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           uint32_t* __restrict__ out,
                                           long long m_rows, long long k_len,
                                           int p_cols, int p_tiles) {
  static_assert(RW == 0 || BM <= 32, "the remainder columns take BM <= 32");
  // the tall and wide tiles stage through copy_async (no registers held
  // while a tile lands), the 32 x 32 ones through registers
  constexpr bool kAsync = BM > 32 || RW > 0;
  // the staging buffers, and afterwards the warps' partials, in one block
  // of shared memory (32 KiB at BM = 32, 40 KiB at BM = 40 or RW = 8)
  constexpr int kABytes = 2 * BM * kVecK * 16;
  constexpr int kBBytes = 2 * kTileK * 32 * 4;
  constexpr int kStageBytes = kABytes + kBBytes + 2 * kTileK * RW * 4;
  constexpr int kPartBytes = kWarps * BM * (32 + RW) * 4;
  __shared__ __align__(16) unsigned char smem[kStageBytes > kPartBytes
                                                  ? kStageBytes : kPartBytes];
  auto sa = reinterpret_cast<uint4 (*)[BM][kVecK]>(smem);
  auto sb = reinterpret_cast<uint32_t (*)[kTileK][32]>(smem + kABytes);
  auto sr = reinterpret_cast<uint32_t (*)[kTileK * (RW > 0 ? RW : 1)]>(
      smem + kABytes + kBBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = (blockIdx.x % p_tiles) * 32;
  const long long m0 = static_cast<long long>(blockIdx.x / p_tiles) * BM;
  const int nm = static_cast<int>(m_rows - m0 < BM ? m_rows - m0 : BM);
  const long long n_tiles = (k_len + kTileK - 1) / kTileK;

  uint32_t acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0u;
  // the remainder: lane l sums column 32 + l % RW; the 32 / RW lanes of a
  // column (groups g = l / RW) split the block's rows kGM ways (kRows each)
  // and the warp's kWarpK k kGK ways (kPer each), so a lane keeps kRows
  // accumulators, not BM
  constexpr int kRW = RW > 0 ? RW : 32;
  constexpr int kG = 32 / kRW;
  constexpr int kGM = kG < BM ? kG : BM;
  constexpr int kGK = kG / kGM;
  constexpr int kRows = RW > 0 ? BM / kGM : 1;
  constexpr int kPer = kWarpK / kGK;
  const int rc = lane % kRW, gm = lane / kRW % kGM, gk = lane / kRW / kGM;
  uint32_t acc_r[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc_r[j] = 0u;

  Tile<BM> regs;
  long long t = blockIdx.y;
  int buf = 0;
  if (t < n_tiles) {
    if constexpr (kAsync) {
      copy_tile<BM, RW>(a, b, m0, m_rows, k_len, p0, p_cols, t, sa[0], sb[0],
                        sr[0]);
      copy_async_wait();
    } else {
      regs.load(a, b, m0, m_rows, k_len, p0, p_cols, t);
      regs.store(sa[0], sb[0]);
    }
  }
  __syncthreads();
  for (; t < n_tiles; t += gridDim.y) {
    const long long next = t + gridDim.y;
    if (next < n_tiles) {
      if constexpr (kAsync)
        copy_tile<BM, RW>(a, b, m0, m_rows, k_len, p0, p_cols, next,
                          sa[buf ^ 1], sb[buf ^ 1], sr[buf ^ 1]);
      else
        regs.load(a, b, m0, m_rows, k_len, p0, p_cols, next);
    }
#pragma unroll
    for (int h = 0; h < kTileK / (4 * kWarps); ++h) {
      const int kv = h * kWarps + warp;          // this warp's 4 k of the tile
      const uint32_t b0 = sb[buf][4 * kv][lane], b1 = sb[buf][4 * kv + 1][lane];
      const uint32_t b2 = sb[buf][4 * kv + 2][lane], b3 = sb[buf][4 * kv + 3][lane];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if (m < 32 || m < nm) {                  // BM = 40: rows past M skipped
          const uint4 av = sa[buf][m][kv];
          acc[m] += av.x * b0 + av.y * b1 + av.z * b2 + av.w * b3;
        }
      }
    }
    if constexpr (RW > 0) {
      const uint32_t* a32 = reinterpret_cast<const uint32_t*>(sa[buf]);
      const int kb = kWarpK * warp + kPer * gk;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        // the row groups start at different k, so their a reads fall in
        // different banks (rows are kTileK = 2 x 32 words apart)
        const int k = kb + (i + gm) % kPer;
        const uint32_t rb = sr[buf][k * RW + rc];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          acc_r[j] += a32[(gm + kGM * j) * kTileK + k] * rb;
      }
    }
    if constexpr (kAsync)
      copy_async_wait();
    else if (next < n_tiles)
      regs.store(sa[buf ^ 1], sb[buf ^ 1]);
    __syncthreads();
    buf ^= 1;
  }

  // fold the warps' partials; the staging buffers are free after the sync
  auto part = reinterpret_cast<uint32_t (*)[BM][32]>(smem);
  auto part_r = reinterpret_cast<uint32_t (*)[BM][RW > 0 ? RW : 1]>(
      smem + kWarps * BM * 32 * 4);
#pragma unroll
  for (int m = 0; m < BM; ++m) part[warp][m][lane] = acc[m];
  if constexpr (RW > 0) {
    // lanes that differ only in gk hold the same (rows, column): fold them
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      uint32_t v = acc_r[j];
#pragma unroll
      for (int off = 16; off >= RW * kGM; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (gk == 0) part_r[warp][gm + kGM * j][rc] = v;
    }
  }
  __syncthreads();
  constexpr int kCols = 32 + RW;
  const bool split = gridDim.y > 1;
  for (int i = threadIdx.x; i < nm * kCols; i += kThreads) {
    const int m = i / kCols, c = i % kCols;
    if (p0 + c >= p_cols) continue;
    uint32_t v = 0u;
    if (RW == 0 || c < 32) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part[w][m][c];
    } else {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part_r[w][m][c - 32];
    }
    uint32_t* dst = out + (m0 + m) * p_cols + p0 + c;
    if (!split) *dst = v;
    else if (v) atomicAdd(dst, v);
  }
}

// BM <= 32 rows x 32 columns per block; grid.x covers (M tile, column
// tile).
template <int BM>
__global__ void __launch_bounds__(kThreads)
lwe_gemm_kernel(const uint32_t* __restrict__ a,  // [M, K]
                const uint32_t* __restrict__ b,  // [K, P]
                uint32_t* __restrict__ out,      // [M, P], zeroed if K is split
                long long m_rows, long long k_len, int p_cols, int p_tiles) {
  gemm_block<BM, 0>(a, b, out, m_rows, k_len, p_cols, p_tiles);
}

// 32 < M <= BM = 40 rows x 32 columns per block, so b streams once; grid.x
// covers (M tile, column tile). Two blocks per SM: without the bound ptxas
// spilled it.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
lwe_gemm_tall_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out,
                     long long m_rows, long long k_len, int p_cols,
                     int p_tiles) {
  gemm_block<BM, 0>(a, b, out, m_rows, k_len, p_cols, p_tiles);
}

// BM <= 32 rows x all 32 < P <= 32 + RW columns per block, so a streams
// once; grid.x covers M.
template <int BM, int RW>
__global__ void __launch_bounds__(kThreads)
lwe_gemm_wide_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out,
                     long long m_rows, long long k_len, int p_cols) {
  gemm_block<BM, RW>(a, b, out, m_rows, k_len, p_cols, 1);
}

template <int BM, int RW>
int launch(const uint32_t* a, const uint32_t* b, uint32_t* out, long long m,
           long long k, int p, int n_sm, cudaStream_t stream) {
  const long long p_tiles = RW ? 1 : (p + 31) / 32;
  const long long tiles = (m + BM - 1) / BM * p_tiles;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  // split K until the card holds about 8 blocks per SM, in whole tiles
  const long long want = static_cast<long long>(n_sm) * (2048 / kThreads);
  long long splits = (want + tiles - 1) / tiles;
  const long long k_tiles = (k + kTileK - 1) / kTileK;
  if (splits > k_tiles) splits = k_tiles;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits));
  if constexpr (RW > 0)
    lwe_gemm_wide_kernel<BM, RW><<<grid, kThreads, 0, stream>>>(a, b, out, m,
                                                                k, p);
  else if constexpr (BM > 32)
    lwe_gemm_tall_kernel<BM><<<grid, kThreads, 0, stream>>>(
        a, b, out, m, k, p, static_cast<int>(p_tiles));
  else
    lwe_gemm_kernel<BM><<<grid, kThreads, 0, stream>>>(
        a, b, out, m, k, p, static_cast<int>(p_tiles));
  return cudaGetLastError();
}

// BM: the least power of two >= m up to 32; 40 for 32 < m <= 40 (one M
// tile, so b streams once); 32-row tiles past 40.
template <int RW>
int launch_rows(const uint32_t* a, const uint32_t* b, uint32_t* out,
                long long m, long long k, int p, int n_sm, cudaStream_t st) {
  if (m <= 1) return launch<1, RW>(a, b, out, m, k, p, n_sm, st);
  if (m <= 2) return launch<2, RW>(a, b, out, m, k, p, n_sm, st);
  if (m <= 4) return launch<4, RW>(a, b, out, m, k, p, n_sm, st);
  if (m <= 8) return launch<8, RW>(a, b, out, m, k, p, n_sm, st);
  if (m <= 16) return launch<16, RW>(a, b, out, m, k, p, n_sm, st);
  if (m <= 32 || RW > 0) return launch<32, RW>(a, b, out, m, k, p, n_sm, st);
  if (m <= 40) return launch<40, 0>(a, b, out, m, k, p, n_sm, st);
  return launch<32, 0>(a, b, out, m, k, p, n_sm, st);
}

}  // namespace

// a [m, k] and b [k, p] int32 row-major, a 16-byte aligned and k % 4 == 0;
// out [m, p] int32, zeroed by the caller. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_lwe_gemm(const void* a, const void* b, int* out,
                              long long m, long long k, long long p, int n_sm,
                              void* stream) {
  if (m <= 0 || k <= 0 || k % 4 || p <= 0 || p > 0x7FFFFFFFLL || n_sm <= 0)
    return cudaErrorInvalidValue;
  const auto* ua = static_cast<const uint32_t*>(a);
  const auto* ub = static_cast<const uint32_t*>(b);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pc = static_cast<int>(p);
  // 33 to 40 columns in one block: 4 or 8 remainder columns beside the 32
  if (p > 32 && p <= 36) return launch_rows<4>(ua, ub, o, m, k, pc, n_sm, st);
  if (p > 36 && p <= 40) return launch_rows<8>(ua, ub, o, m, k, pc, n_sm, st);
  return launch_rows<0>(ua, ub, o, m, k, pc, n_sm, st);
}

// Wrapping int32 GEMM of the single-server LWE scheme, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pir_matmul.py _matmul_kernel as reached
// through lwe_matmul (pir_matmul.py:103; its pallas_call at :147, entry
// ops.lwe_gemm). Computes out[m, p] = sum over k of a[m, k] * b[k, p] for
// row-major int32 operands a [M, K] and b [K, P], modulo 2^32: the Z_q
// contraction of lwe-simple-1 with q = 2^32, bit for bit.
//
// The port calls it at three shapes:
//   answer  ct [Q, N] x bytes32 [N, L]   M = Q <= 32, K = N, P = L = 32
//           (the served path; N = 2^22 at PIR_128M_LWE)
//   hint    D^T [L, N] x A [N, n]        M = 32, K = N, P = n = 1024
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
//   hint and client at Q = 32: 1.37e11 IMADs each -> 8.2 ms: operations.
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
// change a bit. BM is the smallest power of two >= M, capped at 32, so an
// answer of Q queries reads the DB once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 64;                    // k per tile
constexpr int kVecK = kTileK / 4;             // 16-byte vectors per a row

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

template <int BM>
__global__ void __launch_bounds__(kThreads)
lwe_gemm_kernel(const uint32_t* __restrict__ a,  // [M, K]
                const uint32_t* __restrict__ b,  // [K, P]
                uint32_t* __restrict__ out,      // [M, P], zeroed if K is split
                long long m_rows, long long k_len, int p_cols, int p_tiles) {
  // the two staging buffers, and afterwards the warps' partials, in one
  // block of shared memory (32 KiB at BM = 32)
  constexpr int kABytes = 2 * BM * kVecK * 16;
  constexpr int kStageBytes = kABytes + 2 * kTileK * 32 * 4;
  constexpr int kPartBytes = kWarps * BM * 32 * 4;
  __shared__ __align__(16) unsigned char smem[kStageBytes > kPartBytes
                                                  ? kStageBytes : kPartBytes];
  auto sa = reinterpret_cast<uint4 (*)[BM][kVecK]>(smem);
  auto sb = reinterpret_cast<uint32_t (*)[kTileK][32]>(smem + kABytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = (blockIdx.x % p_tiles) * 32;
  const long long m0 = static_cast<long long>(blockIdx.x / p_tiles) * BM;
  const int nm = static_cast<int>(m_rows - m0 < BM ? m_rows - m0 : BM);
  const long long n_tiles = (k_len + kTileK - 1) / kTileK;

  uint32_t acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0u;

  Tile<BM> regs;
  long long t = blockIdx.y;
  int buf = 0;
  if (t < n_tiles) {
    regs.load(a, b, m0, m_rows, k_len, p0, p_cols, t);
    regs.store(sa[0], sb[0]);
  }
  __syncthreads();
  for (; t < n_tiles; t += gridDim.y) {
    const long long next = t + gridDim.y;
    if (next < n_tiles) regs.load(a, b, m0, m_rows, k_len, p0, p_cols, next);
#pragma unroll
    for (int h = 0; h < kTileK / (4 * kWarps); ++h) {
      const int kv = h * kWarps + warp;          // this warp's 4 k of the tile
      const uint32_t b0 = sb[buf][4 * kv][lane], b1 = sb[buf][4 * kv + 1][lane];
      const uint32_t b2 = sb[buf][4 * kv + 2][lane], b3 = sb[buf][4 * kv + 3][lane];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const uint4 av = sa[buf][m][kv];
        acc[m] += av.x * b0 + av.y * b1 + av.z * b2 + av.w * b3;
      }
    }
    if (next < n_tiles) regs.store(sa[buf ^ 1], sb[buf ^ 1]);
    __syncthreads();
    buf ^= 1;
  }

  // fold the warps' partials; the staging buffers are free after the sync
  auto part = reinterpret_cast<uint32_t (*)[BM][32]>(smem);
#pragma unroll
  for (int m = 0; m < BM; ++m) part[warp][m][lane] = acc[m];
  __syncthreads();
  const bool split = gridDim.y > 1;
  for (int i = threadIdx.x; i < nm * 32; i += kThreads) {
    const int m = i / 32, c = i % 32;
    if (p0 + c >= p_cols) continue;
    uint32_t v = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += part[w][m][c];
    uint32_t* dst = out + (m0 + m) * p_cols + p0 + c;
    if (!split) *dst = v;
    else if (v) atomicAdd(dst, v);
  }
}

template <int BM>
int launch(const uint32_t* a, const uint32_t* b, uint32_t* out, long long m,
           long long k, int p, int n_sm, cudaStream_t stream) {
  const long long p_tiles = (p + 31) / 32;
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
  lwe_gemm_kernel<BM><<<grid, kThreads, 0, stream>>>(
      a, b, out, m, k, p, static_cast<int>(p_tiles));
  return cudaGetLastError();
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
  if (m <= 1) return launch<1>(ua, ub, o, m, k, pc, n_sm, st);
  if (m <= 2) return launch<2>(ua, ub, o, m, k, pc, n_sm, st);
  if (m <= 4) return launch<4>(ua, ub, o, m, k, pc, n_sm, st);
  if (m <= 8) return launch<8>(ua, ub, o, m, k, pc, n_sm, st);
  if (m <= 16) return launch<16>(ua, ub, o, m, k, pc, n_sm, st);
  return launch<32>(ua, ub, o, m, k, pc, n_sm, st);
}

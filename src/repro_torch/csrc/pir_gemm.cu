// Batched additive-PIR int8 GEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pir_matmul.py _matmul_kernel as reached
// through pir_matmul (its pallas_call in _pir_matmul_jit). Computes
// out[q, l] = sum over rows j of shares[q, j] * db[j, l], both int8, summed
// in int32 with wraparound (only the value mod 256 matters to the client,
// and 2^8 divides 2^32).
//
// Bound: bytes. Every DB byte and every share byte is read once and the
// work per DB byte is Q/4 dp4a instructions, far below the card's integer
// rate at the batch sizes served (Q <= 32), so the kernel can go no faster
// than (R*L + Q*R + 4*Q*L) bytes over the HBM rate.
//
// Design: split-K. The Pallas kernel carries each [TQ, TL] output block
// across a sequential R grid axis; here blocks run in parallel over slabs
// of rows (grid stride) and fold each slab to a [Q, L] partial in
// registers. A thread takes 4 consecutive rows at a time and 4*CW of their
// byte columns: it loads the 4 rows' words in one 8-byte (CW = 2) or
// 4-byte load each, transposes each 4x4 byte block with __byte_perm so a
// word holds one column's 4 rows, and takes one __dp4a per (query, column)
// against the 4 shares of those rows, which arrive as one 4-byte load per
// query. Lanes that hold the same columns are combined by a warp shuffle,
// warps in shared memory, and blocks by one atomicAdd per (q, l) into the
// zeroed output. Addition mod 2^32 is associative and commutative, so the
// order of the atomics cannot change a bit of the result. A block covers QB
// queries (QB <= 8 keeps the accumulators in registers); grid.y covers
// larger batches, each reading the DB once more.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// c[b] = bytes b of a0..a3, i.e. one column of a 4-row x 4-byte block.
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(a0, a1, 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const uint32_t lo23 = __byte_perm(a2, a3, 0x5140);
  const uint32_t hi01 = __byte_perm(a0, a1, 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const uint32_t hi23 = __byte_perm(a2, a3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// L bytes per record; CW words of each row per thread; TPR threads per
// 4-row group; QB queries per block.
template <int L, int QB>
__global__ void __launch_bounds__(kThreads)
pir_gemm_kernel(const uint32_t* __restrict__ shares,  // [Q, R/4] (4 int8 each)
                const uint32_t* __restrict__ db,      // [R, L/4]
                uint32_t* __restrict__ out,           // [Q, L] int32 bits
                long long quads, int queries) {
  constexpr int kWordsPerRow = L / 4;
  constexpr int CW = kWordsPerRow >= 2 ? 2 : 1;
  constexpr int TPR = kWordsPerRow / CW;
  constexpr int COLS = 4 * CW;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, queries - q0);
  uint32_t acc[QB][COLS];  // int32 bits; unsigned so that wraparound is defined
#pragma unroll
  for (int q = 0; q < QB; ++q)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[q][c] = 0u;

  const long long items = quads * TPR;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int part = static_cast<int>(first % TPR);  // fixed: stride % TPR == 0
  for (long long i = first; i < items; i += stride) {
    const long long quad = i / TPR;
    uint32_t a[4][CW];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t* p = db + (4 * quad + k) * kWordsPerRow + part * CW;
      if constexpr (CW == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        a[k][0] = v.x; a[k][1] = v.y;
      } else {
        a[k][0] = __ldg(p);
      }
    }
    uint32_t col[COLS];
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      uint32_t c4[4];
      transpose4(a[0][w], a[1][w], a[2][w], a[3][w], c4);
#pragma unroll
      for (int b = 0; b < 4; ++b) col[4 * w + b] = c4[b];
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q < nq) {
        const int s4 = static_cast<int>(
            __ldg(shares + static_cast<long long>(q0 + q) * quads + quad));
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[q][c] = static_cast<uint32_t>(
              __dp4a(s4, static_cast<int>(col[c]), static_cast<int>(acc[q][c])));
      }
    }
  }

  // lanes l and l ^ off hold the same columns when off >= TPR
#pragma unroll
  for (int q = 0; q < QB; ++q)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int off = 16; off >= TPR; off >>= 1)
        acc[q][c] += __shfl_xor_sync(0xffffffffu, acc[q][c], off);

  __shared__ uint32_t part_sum[kWarps][QB * L];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < TPR) {
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int c = 0; c < COLS; ++c) part_sum[warp][q * L + lane * COLS + c] = acc[q][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * L; i += kThreads) {
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += part_sum[k][i];
    if (v) atomicAdd(out + static_cast<long long>(q0) * L + i, v);
  }
}

template <int L, int QB>
void launch(const uint32_t* shares, const uint32_t* db, uint32_t* out,
            long long rows, int queries, int n_sm, cudaStream_t stream) {
  constexpr int kWordsPerRow = L / 4;
  constexpr int TPR = kWordsPerRow >= 2 ? kWordsPerRow / 2 : 1;
  const long long quads = rows / 4;
  const long long want = (quads * TPR + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(n_sm) * (2048 / kThreads);
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>((queries + QB - 1) / QB));
  pir_gemm_kernel<L, QB><<<grid, kThreads, 0, stream>>>(shares, db, out, quads,
                                                        queries);
}

template <int L>
void launch_l(const uint32_t* shares, const uint32_t* db, uint32_t* out,
              long long rows, int queries, int n_sm, cudaStream_t stream) {
  if (queries <= 1) launch<L, 1>(shares, db, out, rows, queries, n_sm, stream);
  else if (queries <= 2) launch<L, 2>(shares, db, out, rows, queries, n_sm, stream);
  else if (queries <= 4) launch<L, 4>(shares, db, out, rows, queries, n_sm, stream);
  else launch<L, 8>(shares, db, out, rows, queries, n_sm, stream);
}

}  // namespace

// shares [queries, rows] int8, db [rows, cols] int8 row-major (both 16-byte
// aligned, rows % 4 == 0), out [queries, cols] int32 zeroed by the caller.
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_pir_gemm(const void* shares, const void* db, int* out,
                              long long rows, int cols, int queries, int n_sm,
                              void* stream) {
  if (rows <= 0 || rows % 4 || queries <= 0 || n_sm <= 0)
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const uint32_t*>(shares);
  const auto* d = static_cast<const uint32_t*>(db);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 4: launch_l<4>(s, d, o, rows, queries, n_sm, st); break;
    case 8: launch_l<8>(s, d, o, rows, queries, n_sm, st); break;
    case 16: launch_l<16>(s, d, o, rows, queries, n_sm, st); break;
    case 32: launch_l<32>(s, d, o, rows, queries, n_sm, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

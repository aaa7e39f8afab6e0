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
//
// Widths: L in {4, 8, 16, 32} with the DB 8-byte aligned (4 at L = 4) takes
// that instance. Any other L (a multiple of 4), or a DB only 4-byte
// aligned, takes pir_gemm_any_kernel<QB>: rows of 36 bytes are 4- but not
// 8-byte aligned after the first, and 9 words do not split into 2-word
// slices over a power-of-two number of threads. There a thread owns one
// word column (CW = 1, 4-byte loads) of 4-row quads; a block of 256
// threads covers cols = min(L/4, 256) word columns of 256 / cols quads per
// step (grid.z covers L > 1024), neighbouring threads read neighbouring
// words, and the partials meet in shared memory (atomicAdd) and then in
// the output. The __dp4a over a 4-row x 4-byte block is the same.
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

// Any width L = 4 * words, 4-byte aligned: see the header.
template <int QB>
__global__ void __launch_bounds__(kThreads)
pir_gemm_any_kernel(const uint32_t* __restrict__ shares,  // [Q, R/4]
                    const uint32_t* __restrict__ db,      // [R, words]
                    uint32_t* __restrict__ out,           // [Q, 4 * words]
                    long long quads, int words, int queries) {
  const int col0 = blockIdx.z * kThreads;                 // first word column
  const int cols = min(words - col0, kThreads);
  const int qpb = kThreads / cols;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, queries - q0);
  __shared__ uint32_t part[QB * 4 * kThreads];
  for (int i = threadIdx.x; i < QB * 4 * cols; i += kThreads) part[i] = 0u;
  __syncthreads();

  if (threadIdx.x < qpb * cols) {
    const int c = threadIdx.x % cols;
    uint32_t acc[QB][4];
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[q][b] = 0u;
    const long long step = static_cast<long long>(gridDim.x) * qpb;
    for (long long quad = static_cast<long long>(blockIdx.x) * qpb +
                          threadIdx.x / cols;
         quad < quads; quad += step) {
      const uint32_t* p = db + 4 * quad * words + col0 + c;
      uint32_t col[4];
      transpose4(__ldg(p), __ldg(p + words), __ldg(p + 2 * words),
                 __ldg(p + 3 * words), col);
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        if (q < nq) {
          const int s4 = static_cast<int>(
              __ldg(shares + static_cast<long long>(q0 + q) * quads + quad));
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[q][b] = static_cast<uint32_t>(
                __dp4a(s4, static_cast<int>(col[b]), static_cast<int>(acc[q][b])));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (q < nq && acc[q][b]) atomicAdd(part + q * 4 * cols + 4 * c + b, acc[q][b]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * 4 * cols; i += kThreads) {
    const uint32_t v = part[i];
    if (v)
      atomicAdd(out + static_cast<long long>(q0 + i / (4 * cols)) * 4 * words +
                    4 * col0 + i % (4 * cols), v);
  }
}

template <int QB>
void launch_any(const uint32_t* shares, const uint32_t* db, uint32_t* out,
                long long rows, int words, int queries, int n_sm,
                cudaStream_t stream) {
  const long long quads = rows / 4;
  const int qpb = kThreads / (words < kThreads ? words : kThreads);
  const long long want = (quads + qpb - 1) / qpb;
  const long long cap = static_cast<long long>(n_sm) * (2048 / kThreads);
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>((queries + QB - 1) / QB),
                  static_cast<unsigned>((words + kThreads - 1) / kThreads));
  pir_gemm_any_kernel<QB><<<grid, kThreads, 0, stream>>>(shares, db, out, quads,
                                                          words, queries);
}

void launch_any_q(const uint32_t* shares, const uint32_t* db, uint32_t* out,
                  long long rows, int words, int queries, int n_sm,
                  cudaStream_t stream) {
  if (queries <= 1) launch_any<1>(shares, db, out, rows, words, queries, n_sm, stream);
  else if (queries <= 2) launch_any<2>(shares, db, out, rows, words, queries, n_sm, stream);
  else if (queries <= 4) launch_any<4>(shares, db, out, rows, words, queries, n_sm, stream);
  else launch_any<8>(shares, db, out, rows, words, queries, n_sm, stream);
}

// The fixed-width instance for L when the DB is aligned for its loads
// (2-word loads from L = 8 on).
template <int L>
bool launch_fast(const uint32_t* shares, const uint32_t* db, uint32_t* out,
                 long long rows, int queries, int n_sm, cudaStream_t stream) {
  if (!repro::aligned(db, L >= 8 ? 8 : 4)) return false;
  launch_l<L>(shares, db, out, rows, queries, n_sm, stream);
  return true;
}

}  // namespace

// shares [queries, rows] int8, db [rows, cols] int8 row-major (both 4-byte
// aligned, rows % 4 == 0, cols % 4 == 0), out [queries, cols] int32 zeroed
// by the caller. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_pir_gemm(const void* shares, const void* db, int* out,
                              long long rows, int cols, int queries, int n_sm,
                              void* stream) {
  if (rows <= 0 || rows % 4 || cols <= 0 || cols % 4 || queries <= 0 ||
      n_sm <= 0 || !repro::aligned(shares, 4) || !repro::aligned(db, 4))
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const uint32_t*>(shares);
  const auto* d = static_cast<const uint32_t*>(db);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool fast = false;
  switch (cols) {
    case 4: fast = launch_fast<4>(s, d, o, rows, queries, n_sm, st); break;
    case 8: fast = launch_fast<8>(s, d, o, rows, queries, n_sm, st); break;
    case 16: fast = launch_fast<16>(s, d, o, rows, queries, n_sm, st); break;
    case 32: fast = launch_fast<32>(s, d, o, rows, queries, n_sm, st); break;
    default: break;
  }
  if (!fast) launch_any_q(s, d, o, rows, cols / 4, queries, n_sm, st);
  return cudaGetLastError();
}

// dpXOR select-XOR scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dpxor.py _dpxor_kernel (pallas_call in
// _dpxor_t_jit). Computes out[q, :] = XOR of db[j, :] over rows j with
// bits[q, j] != 0, as out[q] ^= db[j] & (0 - bits[q, j]).
//
// Bound: bytes. Every DB word and every selection word is read once and the
// work per word is one LOP3, so the kernel can go no faster than
// (R*W*4 + Q*R*4) bytes over the HBM rate.
//
// Design: the DB is row-major [R, W] (a 32-byte record is contiguous) and
// is read exactly once. Two paths:
//   * W in {1, 2, 4, 8, 16} with the DB aligned for its vector width
//     (dpxor_kernel<W, QB>): each thread walks its rows with a grid
//     stride, loads a whole row in 16-byte loads, and folds it into W
//     registers for each of up to QB queries (grid.y covers larger
//     batches). The per-thread partials are combined by a warp
//     shuffle-XOR, then across the block's warps in shared memory, then
//     with one atomicXor per (q, w) into the zeroed output.
//   * any other W, or a DB only 4-byte aligned (dpxor_any_kernel<QB>):
//     the record is not a whole number of vectors (36-byte records with a
//     checksum column, W = 9) or its rows are not vector-aligned (a row
//     slice). Thread t of a block owns one word column c of rows t / cols,
//     + rpb, ... (cols = min(W, 256) columns per block, rpb = 256 / cols
//     rows per block step, grid.z covers W > 256), so neighbouring threads
//     read neighbouring words and a warp's 4-byte loads are one coalesced
//     segment; four rows are loaded before any is used, to keep loads in
//     flight. A thread holds one word per query; partials meet in shared
//     memory (atomicXor) and then in the output.
// XOR is associative and commutative, so the result is exact in any order.
// Row offsets are 64-bit (PIR_8G has 2^31 words).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int W, int QB>
__global__ void __launch_bounds__(kThreads)
dpxor_kernel(const uint32_t* __restrict__ db, const uint32_t* __restrict__ bits,
             uint32_t* __restrict__ out, long long rows, int queries) {
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, queries - q0);
  uint32_t acc[QB][W];
#pragma unroll
  for (int q = 0; q < QB; ++q)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[q][w] = 0u;

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       j < rows; j += stride) {
    uint32_t row[W];
    repro::load_row<W>(db + j * W, row);
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q < nq) {
        const uint32_t m = 0u - __ldg(bits + static_cast<long long>(q0 + q) * rows + j);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[q][w] ^= row[w] & m;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < QB; ++q)
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q][w] ^= __shfl_xor_sync(0xffffffffu, acc[q][w], off);

  __shared__ uint32_t part[kWarps][QB * W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int w = 0; w < W; ++w) part[warp][q * W + w] = acc[q][w];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * W; i += kThreads) {
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v ^= part[k][i];
    if (v) atomicXor(out + static_cast<long long>(q0) * W + i, v);
  }
}

template <int W, int QB>
void launch(const uint32_t* db, const uint32_t* bits, uint32_t* out,
            long long rows, int queries, int n_sm, cudaStream_t stream) {
  const long long want = (rows + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(n_sm) * (2048 / kThreads);
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>((queries + QB - 1) / QB));
  dpxor_kernel<W, QB><<<grid, kThreads, 0, stream>>>(db, bits, out, rows, queries);
}

template <int W>
void launch_w(const uint32_t* db, const uint32_t* bits, uint32_t* out,
              long long rows, int queries, int n_sm, cudaStream_t stream) {
  if (queries <= 1) launch<W, 1>(db, bits, out, rows, queries, n_sm, stream);
  else if (queries <= 2) launch<W, 2>(db, bits, out, rows, queries, n_sm, stream);
  else if (queries <= 4) launch<W, 4>(db, bits, out, rows, queries, n_sm, stream);
  else launch<W, 8>(db, bits, out, rows, queries, n_sm, stream);
}

// Any width, 4-byte aligned: see the header. kUnroll rows per step are
// loaded before they are folded.
constexpr int kUnroll = 4;

template <int QB>
__global__ void __launch_bounds__(kThreads)
dpxor_any_kernel(const uint32_t* __restrict__ db,
                 const uint32_t* __restrict__ bits, uint32_t* __restrict__ out,
                 long long rows, int words, int queries) {
  const int col0 = blockIdx.z * kThreads;
  const int cols = min(words - col0, kThreads);
  const int rpb = kThreads / cols;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, queries - q0);
  __shared__ uint32_t part[QB * kThreads];
  for (int i = threadIdx.x; i < QB * cols; i += kThreads) part[i] = 0u;
  __syncthreads();

  if (threadIdx.x < rpb * cols) {
    const int c = threadIdx.x % cols;
    uint32_t acc[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) acc[q] = 0u;
    const long long step = static_cast<long long>(gridDim.x) * rpb;
    const uint32_t* col = db + col0 + c;
    for (long long j = static_cast<long long>(blockIdx.x) * rpb +
                       threadIdx.x / cols;
         j < rows; j += kUnroll * step) {
      uint32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = j + u * step;
        v[u] = r < rows ? __ldg(col + r * words) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = j + u * step;
        if (r < rows) {
#pragma unroll
          for (int q = 0; q < QB; ++q)
            if (q < nq)
              acc[q] ^= v[u] & (0u - __ldg(bits + static_cast<long long>(q0 + q) * rows + r));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < QB; ++q)
      if (q < nq && acc[q]) atomicXor(part + q * cols + c, acc[q]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * cols; i += kThreads) {
    const uint32_t v = part[i];
    if (v)
      atomicXor(out + static_cast<long long>(q0 + i / cols) * words + col0 + i % cols, v);
  }
}

template <int QB>
void launch_any(const uint32_t* db, const uint32_t* bits, uint32_t* out,
                long long rows, int words, int queries, int n_sm,
                cudaStream_t stream) {
  const int rpb = kThreads / (words < kThreads ? words : kThreads);
  const long long want = (rows + rpb - 1) / rpb;
  const long long cap = static_cast<long long>(n_sm) * (2048 / kThreads);
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>((queries + QB - 1) / QB),
                  static_cast<unsigned>((words + kThreads - 1) / kThreads));
  dpxor_any_kernel<QB><<<grid, kThreads, 0, stream>>>(db, bits, out, rows, words,
                                                       queries);
}

void launch_any_q(const uint32_t* db, const uint32_t* bits, uint32_t* out,
                  long long rows, int words, int queries, int n_sm,
                  cudaStream_t stream) {
  if (queries <= 1) launch_any<1>(db, bits, out, rows, words, queries, n_sm, stream);
  else if (queries <= 2) launch_any<2>(db, bits, out, rows, words, queries, n_sm, stream);
  else if (queries <= 4) launch_any<4>(db, bits, out, rows, words, queries, n_sm, stream);
  else launch_any<8>(db, bits, out, rows, words, queries, n_sm, stream);
}

// The vector path for W when the DB is aligned for it.
template <int W>
bool launch_fast(const uint32_t* db, const uint32_t* bits, uint32_t* out,
                 long long rows, int queries, int n_sm, cudaStream_t stream) {
  if (!repro::aligned(db, repro::row_align<W>())) return false;
  launch_w<W>(db, bits, out, rows, queries, n_sm, stream);
  return true;
}

}  // namespace

// db [rows, words] u32 row-major (4-byte aligned; the vector path needs its
// load width), bits [queries, rows] u32 (4-byte aligned), out [queries,
// words] u32 zeroed by the caller. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_dpxor(const uint32_t* db, const uint32_t* bits, uint32_t* out,
                           long long rows, int words, int queries, int n_sm,
                           void* stream) {
  if (rows <= 0 || words <= 0 || queries <= 0 || n_sm <= 0 ||
      !repro::aligned(db, 4) || !repro::aligned(bits, 4))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool fast = false;
  switch (words) {
    case 1: fast = launch_fast<1>(db, bits, out, rows, queries, n_sm, s); break;
    case 2: fast = launch_fast<2>(db, bits, out, rows, queries, n_sm, s); break;
    case 4: fast = launch_fast<4>(db, bits, out, rows, queries, n_sm, s); break;
    case 8: fast = launch_fast<8>(db, bits, out, rows, queries, n_sm, s); break;
    case 16: fast = launch_fast<16>(db, bits, out, rows, queries, n_sm, s); break;
    default: break;
  }
  if (!fast) launch_any_q(db, bits, out, rows, words, queries, n_sm, s);
  return cudaGetLastError();
}

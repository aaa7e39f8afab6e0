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
// is read exactly once: each thread walks its rows with a grid stride, loads
// a whole row in 16-byte loads, and folds it into W registers for each of
// up to QB queries (grid.y covers larger batches). The per-thread partials
// are combined by a warp shuffle-XOR, then across the block's warps in
// shared memory, then with one atomicXor per (q, w) into the zeroed output.
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

}  // namespace

// db [rows, words] u32 row-major (16-byte aligned), bits [queries, rows] u32,
// out [queries, words] u32 zeroed by the caller. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_dpxor(const uint32_t* db, const uint32_t* bits, uint32_t* out,
                           long long rows, int words, int queries, int n_sm,
                           void* stream) {
  if (rows <= 0 || queries <= 0 || n_sm <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: launch_w<1>(db, bits, out, rows, queries, n_sm, s); break;
    case 2: launch_w<2>(db, bits, out, rows, queries, n_sm, s); break;
    case 4: launch_w<4>(db, bits, out, rows, queries, n_sm, s); break;
    case 8: launch_w<8>(db, bits, out, rows, queries, n_sm, s); break;
    case 16: launch_w<16>(db, bits, out, rows, queries, n_sm, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

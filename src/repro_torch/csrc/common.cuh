// Shared pieces of the port's CUDA kernels: the ChaCha block as a device
// function and the C error-string export each library carries.
//
// chacha_block is the device-function form of the reference's
// kernels/ggm_expand.py _chacha_rows (and crypto/chacha.py chacha_block):
// the 128-bit seed fills both key rows, the counter/nonce row is
// [counter, 0x5049522D, 0x494D5049, 0x52212121], and the output is the
// permuted state plus the input state, word for word as in the reference.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);  // one SHF
}

#define REPRO_QR(a, b, c, d)      \
  a += b; d = rotl32(d ^ a, 16);  \
  c += d; b = rotl32(b ^ c, 12);  \
  a += b; d = rotl32(d ^ a, 8);   \
  c += d; b = rotl32(b ^ c, 7);

// out[16] = ChaCha_rounds(key || key, counter) + input state.
__device__ __forceinline__ void chacha_block(uint32_t out[16],
                                             const uint32_t key[4],
                                             uint32_t counter, int rounds) {
  const uint32_t in[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                           key[0], key[1], key[2], key[3],
                           key[0], key[1], key[2], key[3],
                           counter, 0x5049522Du, 0x494D5049u, 0x52212121u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = in[i];
  for (int r = 0; r < rounds; r += 2) {
    REPRO_QR(x[0], x[4], x[8], x[12]);   // column round
    REPRO_QR(x[1], x[5], x[9], x[13]);
    REPRO_QR(x[2], x[6], x[10], x[14]);
    REPRO_QR(x[3], x[7], x[11], x[15]);
    REPRO_QR(x[0], x[5], x[10], x[15]);  // diagonal round
    REPRO_QR(x[1], x[6], x[11], x[12]);
    REPRO_QR(x[2], x[7], x[8], x[13]);
    REPRO_QR(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = x[i] + in[i];
}

#undef REPRO_QR

// The alignment load_row<W> needs of the DB base: its load width, which
// also divides the row stride, so every row is as aligned as the base.
template <int W>
constexpr int row_align() {
  return W % 4 == 0 ? 16 : W % 2 == 0 ? 8 : 4;
}

// Whether a pointer is `bytes`-aligned. The host dispatchers take a
// width's vector path only for an operand aligned for it, and the
// word-by-word path otherwise (a row slice of a 36-byte-record DB is only
// 4-byte aligned).
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// One DB row of W u32 words into registers, in the widest aligned loads
// (the caller guarantees row_align<W>() alignment of the DB base).
template <int W>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p,
                                         uint32_t (&r)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r[4 * i] = v.x; r[4 * i + 1] = v.y; r[4 * i + 2] = v.z; r[4 * i + 3] = v.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      r[2 * i] = v.x; r[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = __ldg(p + i);
  }
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

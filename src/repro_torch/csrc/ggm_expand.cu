// One corrected GGM level for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ggm_expand.py _ggm_expand_kernel (the
// pallas_call in _ggm_expand_level_jit, through ops.ggm_expand and
// ops.ggm_eval_leaves). For each of n parent nodes, one ChaCha block of its
// seed (counter 0) gives both children and their control bits, corrected
// by the level's words masked by the parent's t:
//   left  = out[0:4] ^ ((0 - t) & cw_seed)
//   right = out[4:8] ^ ((0 - t) & cw_seed)
//   t_l = (out[8] & 1) ^ (t & cw_t[0]),  t_r = (out[9] & 1) ^ (t & cw_t[1]).
//
// Bound: bytes, with operations a close second. Per node 20 B are read
// (seed and t) and 40 B written (two children and two t bits). At n = 2^24,
// the widest level of one PIR_1G key, that is 60 * 2^24 = 1,006,632,960 B,
// 0.3005 ms at 3.35 TB/s; the 2^24 ChaCha12 blocks of 576 ARX ops each take
// 0.2889 ms at 132 SMs x 128 int32 lane-ops x 1.98 GHz.
//
// Design: one thread per parent node, ChaCha's state in registers (the
// shared repro::chacha_block). The seed comes in one 16-byte load, the
// children go out as two 16-byte stores and the two t bits as one 8-byte
// store, straight into the caller's leaf-major order (children of node i
// are rows 2i and 2i+1), so neighbouring threads write neighbouring 32-byte
// pairs. The Pallas kernel writes a word-transposed [8, n] that ops then
// interleaves; here no second pass exists. Indices are 64-bit: 2n * 4 words
// reach 2^27 at n = 2^24.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
ggm_expand_kernel(const uint4* __restrict__ seeds,     // [n] x 4 words
                  const uint32_t* __restrict__ t,      // [n]
                  const uint32_t* __restrict__ cw_seed,  // [4]
                  const uint32_t* __restrict__ cw_t,     // [2]
                  uint4* __restrict__ children,        // [2n] x 4 words
                  uint2* __restrict__ t_out,           // [n] x (t_l, t_r)
                  long long n, int rounds) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 s = __ldg(seeds + i);
  const uint32_t ti = __ldg(t + i);
  const uint32_t key[4] = {s.x, s.y, s.z, s.w};
  uint32_t out[16];
  repro::chacha_block(out, key, 0u, rounds);
  const uint32_t mask = 0u - ti;
  const uint32_t c0 = mask & __ldg(cw_seed), c1 = mask & __ldg(cw_seed + 1),
                 c2 = mask & __ldg(cw_seed + 2), c3 = mask & __ldg(cw_seed + 3);
  children[2 * i] = make_uint4(out[0] ^ c0, out[1] ^ c1, out[2] ^ c2, out[3] ^ c3);
  children[2 * i + 1] = make_uint4(out[4] ^ c0, out[5] ^ c1, out[6] ^ c2, out[7] ^ c3);
  t_out[i] = make_uint2((out[8] & 1u) ^ (ti & __ldg(cw_t)),
                        (out[9] & 1u) ^ (ti & __ldg(cw_t + 1)));
}

}  // namespace

// seeds [n, 4] u32 (16-byte aligned), t [n] u32, cw_seed [4], cw_t [2] u32 on
// the device; children [2n, 4] u32 (16-byte aligned) and t_out [2n] u32
// (8-byte aligned) written in leaf-major order. `block` threads per block
// (1..1024). Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported argument).
extern "C" int repro_ggm_expand(const uint32_t* seeds, const uint32_t* t,
                                const uint32_t* cw_seed, const uint32_t* cw_t,
                                uint32_t* children, uint32_t* t_out,
                                long long n, int block, int rounds,
                                void* stream) {
  if (n <= 0 || block <= 0 || block > kMaxThreads || rounds <= 0 || rounds % 2)
    return cudaErrorInvalidValue;
  const long long grid = (n + block - 1) / block;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  ggm_expand_kernel<<<static_cast<unsigned>(grid), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(seeds), t, cw_seed, cw_t,
      reinterpret_cast<uint4*>(children), reinterpret_cast<uint2*>(t_out), n,
      rounds);
  return cudaGetLastError();
}

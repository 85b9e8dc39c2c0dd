// Pieces shared by the attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): masking constants and the dropout bits.
//
// Dropout bits: Philox4x32-10 (Salmon et al., "Parallel random numbers: as
// easy as 1, 2, 3", SC'11), keyed on GLOBAL coordinates, never on tiles:
//   key     = (seed[b, h] as uint32, 0)
//   counter = (row0 + query row, (col0 + key column) / 4, 0, 0)
// where (row0, col0), arguments of both entry points, are the global
// coordinates of the call's element (0, 0): 0 for a whole sequence, the
// block's first query row and key for one block of a longer sequence (the
// ring of parallel/sequence.py), so that block draws the whole call's bits
// there. col0 must be a multiple of 4 (a Philox call covers 4 keys).
// One call gives the bits of 4 adjacent key columns (word j for column
// 4 * (col / 4) + j), and a key is kept where bits < threshold, with
// threshold = round((1 - p) * 2^32) as on the TPU. Every kernel, whatever its
// tiles, and every split of batch or heads, regenerates the same mask; the
// plain PyTorch version (ops/kernels/flash_attention.py) computes the same
// bits, so kernel and plain version compare element for element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vimo {

constexpr float kMaskValue = -1e9f;  // ops/attention.py _MASK_VALUE

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t k0) {
  uint32_t c2 = 0u, c3 = 0u, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Keep bits of a tile of `rows` query rows from r0 by 64 key columns from c0
// (c0 a multiple of 4): word 2 * r + j / 32, bit j % 32 is column c0 + j of
// row r0 + r. Each word is 8 Philox calls by one thread, UNROLL of them
// interleaved (fewer hold fewer registers).
template <int UNROLL = 8>
__device__ __forceinline__ void fill_keep_bits(uint32_t* bits, int rows, int r0, int c0,
                                               uint32_t seed, uint32_t threshold,
                                               int tid, int nthreads) {
  for (int w = tid; w < rows * 2; w += nthreads) {
    const int r = w >> 1;
    const uint32_t group0 = (uint32_t)((c0 >> 2) + (w & 1) * 8);
    uint32_t word = 0u;
#pragma unroll 1
    for (int g0 = 0; g0 < 8; g0 += UNROLL) {
#pragma unroll
      for (int gi = 0; gi < UNROLL; ++gi) {
        const int g = g0 + gi;
        const uint4 x = philox4x32_10((uint32_t)(r0 + r), group0 + g, seed);
        word |= ((uint32_t)(x.x < threshold) << (4 * g)) |
                ((uint32_t)(x.y < threshold) << (4 * g + 1)) |
                ((uint32_t)(x.z < threshold) << (4 * g + 2)) |
                ((uint32_t)(x.w < threshold) << (4 * g + 3));
      }
    }
    bits[w] = word;
  }
}

}  // namespace vimo

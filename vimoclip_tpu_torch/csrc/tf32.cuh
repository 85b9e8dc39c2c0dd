// Hopper (sm_90a) building blocks of the float32 attention kernels
// (flash_attention_fwd.cu: fwd_tf32_kernel; flash_attention_bwd.cu:
// dkv_tf32_kernel, dq_tf32_kernel, dq_tf32_wide_kernel): three-pass TF32
// products on the tensor cores.
//
// Three passes. Each float32 operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (cvt.rna.tf32.f32: round to nearest, ties away, to
// 10 mantissa bits; the low 13 bits cleared), and A.B is computed as
// A_lo.B_hi + A_hi.B_lo + A_hi.B_hi, each term a TF32 product accumulated in
// float32. The dropped lo.lo term and lo's own rounding leave about 2^-21 of
// each product's magnitude: near float32's own ordering noise, and far
// inside the kernels' 1e-4 limits against their plain float32 versions
// (tests/test_torch_tf32_split.py emulates the passes and pins the budget).
//
// Tiles. A float32 "chunk" is 64 rows x 64 columns (16 KB), stored as two
// 64 x 32 halves (8 KB each) in the layout TMA's 128-byte swizzle writes:
// a row of a half is 128 bytes, and its 16-byte unit u is stored at unit
// u ^ (row % 8). A K-major wgmma operand (rows contracted over columns)
// reads it directly: a TF32 k-step is 8 columns = 32 bytes, so k-step kk
// sits in half kk / 4, 32 bytes further per step, 8-row groups 1024 bytes
// apart, the same byte arithmetic as a bf16 k-step of 16 columns.
//
// Two product routes (wgmma takes TF32 operands from shared memory only
// K-major; the transpose bits exist for 16-bit types only):
// - wgmma m64n64k8 with both operands K-major from shared memory (SS): the
//   score products S = Qs.K^T, S^T = K.Qs^T, dP = dO.V^T and dP^T = V.dO^T
//   read the raw q/k/v/dO chunks TMA wrote, each split in place into hi and
//   into a lo copy beside it;
// - mma.sync m16n8k8 (per warp, 16 rows) where B would have to be
//   MN-major (O += P.V, dV += P^T.dO, dK += dS^T.Q, K2's dQ share and K3's
//   dQ, dS.K):
//   A comes from registers (the accumulator of the score product, split in
//   registers), B is gathered from the raw chunk by ld.shared and split in
//   registers. Transposed hi/lo copies for wgmma would need 32 KB per chunk
//   more than the shared memory holds beside the ring at head dim 128.
//   The accumulator of a 64 x 64 product holds, per thread, columns
//   {2 t4, 2 t4 + 1} of each 8-column group, where mma's A fragment wants
//   {t4, t4 + 4}: the contraction order is permuted instead (A slot t4 takes
//   k 2 t4, slot t4 + 4 takes k 2 t4 + 1, and B's rows follow), which changes
//   no sum but its order. The mma.sync accumulator of an n-tile j holds the
//   same elements as wgmma's d[4j .. 4j + 3], so both routes share one
//   accumulator layout.

#pragma once

#include "hopper.cuh"

namespace vimo {

constexpr int kFHalf = 64 * 32;       // floats of one 64 x 32 half (8 KB)
constexpr int kFChunk = 2 * kFHalf;   // floats of one 64 x 64 chunk (16 KB)
constexpr uint32_t kFChunkBytes = kFChunk * sizeof(float);

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;
}

// x = hi + lo + (a remainder below 2^-21 |x|), both TF32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// a chunk times `mul` split in place into hi, lo into `lo` (same layout);
// elementwise, so the swizzle does not matter
__device__ __forceinline__ void split_chunk(float* t, float* lo, float mul, int tid) {
  for (int i = tid; i < kFChunk / 4; i += kConsumers) {
    float4 x = reinterpret_cast<float4*>(t)[i];
    uint32_t h[4], l[4];
    split_tf32(x.x * mul, h[0], l[0]);
    split_tf32(x.y * mul, h[1], l[1]);
    split_tf32(x.z * mul, h[2], l[2]);
    split_tf32(x.w * mul, h[3], l[3]);
    reinterpret_cast<uint4*>(t)[i] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// a slot's two chunks split in place (the second times `mul_b`), their lo
// beside them, then published to wgmma: the proxy fence and the consumers'
// barrier
__device__ __forceinline__ void split_pair(float* slot, float* lo, float mul_b, int tid) {
  split_chunk(slot, lo, 1.f, tid);
  split_chunk(slot + kFChunk, lo + kFChunk, mul_b, tid);
  fence_proxy_async();
  consumer_sync();
}

// K-major descriptor of TF32 k-step kk (8 columns) of a chunk
__device__ __forceinline__ uint64_t tf32_desc(const float* chunk, int kk) {
  return sw128_desc(chunk + (kk >> 2) * kFHalf + (kk & 3) * 8, 16, 1024);
}

// D (64 x 64, float32) {+}= A . B^T, A and B K-major TF32 chunks in shared
// memory; accumulate unless `zero`
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"((uint32_t)zero));
}

// D {+}= A . B^T over one chunk pair (8 k-steps), three passes: A (hi in
// place, lo beside it), B likewise; every product issued before any wait
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[32], const float* a_hi, const float* a_lo,
                                             const float* b_hi, const float* b_lo, bool zero) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_tf32_n64(d, tf32_desc(a_lo, kk), tf32_desc(b_hi, kk), zero && kk == 0);
    wgmma_tf32_n64(d, tf32_desc(a_hi, kk), tf32_desc(b_lo, kk), false);
    wgmma_tf32_n64(d, tf32_desc(a_hi, kk), tf32_desc(b_hi, kk), false);
  }
}

// not volatile: the compiler interleaves independent products, so that a
// warp keeps several in flight instead of waiting on each one's result
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// k-step c of a 64 x 64 accumulator-layout operand as mma's A fragment, hi
// and lo (slot t4: k 8c + 2 t4; slot t4 + 4: k 8c + 2 t4 + 1)
__device__ __forceinline__ void a_fragment(const float (&a)[32], int c, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(a[4 * c + 0], hi[0], lo[0]);
  split_tf32(a[4 * c + 2], hi[1], lo[1]);
  split_tf32(a[4 * c + 1], hi[2], lo[2]);
  split_tf32(a[4 * c + 3], hi[3], lo[3]);
}

// a thread's offsets into a raw chunk for mma's B fragment: rows 2 t4 (and
// 2 t4 + 1) of an 8-row k-step, column g of 8-column group m (0-3) of a
// 32-column half. Element (r, col) of a chunk sits at (col / 32) kFHalf +
// 32 r + 4 (((col / 4) % 8) ^ (r % 8)) + col % 4, so row 8c + 2 t4 + i,
// column 8 nt + g sits at (nt / 4) kFHalf + 256 c + row<i>[nt % 4].
struct BOffsets {
  int row0[4], row1[4];
};

__device__ __forceinline__ BOffsets b_offsets(int lane) {
  const int g = lane >> 2, t4 = lane & 3, gh = g >> 2;
  BOffsets o;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    o.row0[m] = 64 * t4 + (((2 * m + gh) ^ (2 * t4)) << 2) + (g & 3);
    o.row1[m] = 64 * t4 + 32 + (((2 * m + gh) ^ (2 * t4 + 1)) << 2) + (g & 3);
  }
  return o;
}

// acc (the warp's 16 rows x 64 columns, accumulator layout) += A . B over
// k-step c: A's fragment (hi, lo), B rows 8c + 2 t4 and 8c + 2 t4 + 1 of a
// raw chunk in shared memory, columns 8 nt + g, split in registers. Four
// n-tiles at a time: their loads first, then each pass over the four, so
// four independent products are in flight. N-tiles from `n_nt` on (columns
// past the head dim) are left out.
__device__ __forceinline__ void mma_tf32x3_step(float (&acc)[32], const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4], const float* b, int c,
                                                int n_nt, const BOffsets& o) {
#pragma unroll
  for (int n0 = 0; n0 < 8; n0 += 4) {
    if (n0 >= n_nt) break;
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* col = b + ((n0 + i) >> 2) * kFHalf + 256 * c;
      split_tf32(col[o.row0[i]], bh[i][0], bl[i][0]);
      split_tf32(col[o.row1[i]], bh[i][1], bl[i][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mma_tf32(acc[4 * (n0 + i)], acc[4 * (n0 + i) + 1], acc[4 * (n0 + i) + 2],
               acc[4 * (n0 + i) + 3], al, bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mma_tf32(acc[4 * (n0 + i)], acc[4 * (n0 + i) + 1], acc[4 * (n0 + i) + 2],
               acc[4 * (n0 + i) + 3], ah, bl[i][0], bl[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mma_tf32(acc[4 * (n0 + i)], acc[4 * (n0 + i) + 1], acc[4 * (n0 + i) + 2],
               acc[4 * (n0 + i) + 3], ah, bh[i][0], bh[i][1]);
  }
}

// acc += A . B over one chunk: A the 64 x 64 accumulator-layout operand
// `a` (its k the chunk's rows), B a raw chunk
__device__ __forceinline__ void mma_tf32x3_chunk(float (&acc)[32], const float (&a)[32],
                                                 const float* b, int n_nt, const BOffsets& o) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t ah[4], al[4];
    a_fragment(a, c, ah, al);
    mma_tf32x3_step(acc, ah, al, b, c, n_nt, o);
  }
}

// n-tiles of a 64-column chunk from column `col` that hold head-dim columns
__device__ __forceinline__ int live_ntiles(int d, int col) {
  return min(8, max(0, (d - col + 7) >> 3));
}

// a 64-column chunk (two 32-column boxes) of rows row0.. of head (h, b)
__device__ __forceinline__ void tma_chunk(float* dst, const CUtensorMap* map, uint64_t* bar,
                                          int col, int row0, int h, int b) {
  tma_load(dst, map, bar, col, row0, h, b);
  tma_load(dst + kFHalf, map, bar, col + 32, row0, h, b);
}

// rows r0 + (row of the accumulator) of a (T, D) float32 output, columns
// col0 + (column), times `mul`; columns from `d` on and rows from `t` on
// are left out
__device__ __forceinline__ void store_rows_f32(float* out, long long st, int r0, int t, int col0,
                                               int d, const float (&acc)[32], float mul,
                                               int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + warp * 16 + g + 8 * (e >> 1);
      const int c = col0 + 8 * j + 2 * t4 + (e & 1);
      if (row < t && c < d) out[(long long)row * st + c] = acc[4 * j + e] * mul;
    }
  }
}

}  // namespace vimo

// Hopper (sm_90a) building blocks of the bf16 attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): mbarriers, TMA loads and
// stores, 128- and 32-byte-swizzle shared-memory descriptors, wgmma wrappers,
// the register A operand, the elementwise helpers and the host-side tensor
// maps (bf16 or float32; the float32 kernels' TF32 blocks are in tf32.cuh).
//
// Tiles are 64 rows x 64 bf16 columns (128 bytes a row, 8 KB) in the layout
// TMA's 128-byte swizzle writes (16-byte chunk c of row r stored at chunk
// c ^ (r % 8), from a 1024-byte aligned base); a head dim above 64 takes two
// such chunks (DP = 64 * NC). Accumulator layout of wgmma m64nNk16
// (float32), for thread `tid` of the warpgroup (warp w = tid / 32,
// g = lane / 4, t4 = lane % 4):
//   d[4j + e] = D[16w + g + 8 (e / 2)][8j + 2 t4 + (e % 2)],  j < N / 8
// and the register A operand of a 64 x 16 slice is the same as mma.sync's
// m16n8k16 A fragment per warp, so accumulator columns 16c .. 16c + 15 are
// the A operand of k-step c after packing pairs to bf16.

#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vimo {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                     // query rows or keys per tile
constexpr int kChunk = kTile * 64;            // elements of one swizzled chunk
constexpr int kStages = 2;                    // ring depth of the swept tiles
constexpr int kConsumers = 128;               // one warpgroup
constexpr int kHopThreads = kConsumers + 32;  // and one producer warp

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// announce `bytes` of TMA traffic on the barrier, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// box (64 columns from c0, 64 rows from row0) of head (h, b) of a (B, H, T, D)
// tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int row0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(row0), "r"(h), "r"(b)
      : "memory");
}

// `bytes` contiguous bytes from device memory into shared memory (both
// 16-byte aligned), completion on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// box of a (B, H, T, D) tensor map from shared memory into device memory at
// (c0, row0, h, b); the tensor's bounds clip it. Tracked by the issuing
// thread's bulk groups (bulk_commit, bulk_wait_read)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int row0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(row0), "r"(h),
        "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the thread's committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the consumer warpgroup's own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// bar.sync on named barrier `id` for `threads` threads (warpgroup-local: 128)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at named barrier `id` without waiting: the other side's bar.sync
// returns once `threads` threads arrived, with this side's earlier shared-
// memory writes visible to it
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the warpgroup's registers per thread lowered or raised to N (a multiple of
// 8): a producer warpgroup hands its registers to the consumers
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// keeps the compiler from reading or moving accumulators across an
// asynchronous wgmma (its issue and its wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for register A operands, which an in-flight wgmma still reads
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// shared-memory matrix descriptor, 128-byte swizzle, from a 32-bit
// shared-memory address or a pointer
__device__ __forceinline__ uint64_t sw128_desc_u32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t sw128_desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  return sw128_desc_u32(smem_u32(ptr), lbo, sbo);
}

// K-major operand (rows of a tile, contracted over its columns), k-step kk
// of 16 columns: chunk kk / 4, 32 bytes further per step inside the 128-byte
// row; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kChunk + (kk & 3) * 16, 16, 1024);
}

// MN-major operand (contracted over the tile's rows, its columns the M or N
// dimension), k-step kk of 16 rows: 8-row groups 1024 bytes apart, the next
// 64 columns one chunk (8 KB) further
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* tile, int kk) {
  return sw128_desc(tile + kk * 16 * 64, kChunk * 2, 1024);
}

// shared-memory matrix descriptor, 32-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_32B: rows of 32 bytes, 16-byte half h of row r stored
// at h ^ ((r / 4) % 2), from a 256-byte aligned base). A K-major operand's
// k-step of 16 columns is one such 32-byte row (8-row groups `sbo` = 256
// bytes apart); an MN-major one steps `lbo` bytes per 16 columns of M or N
__device__ __forceinline__ uint64_t sw32_desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}

#define VIMO_ACC32                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VIMO_REGS32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D (64 x 64, float32) {+}= A . B^T, A and B K-major bf16 tiles in
// shared memory (128-byte swizzle); accumulate unless `zero`
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIMO_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VIMO_ACC32
      : "l"(da), "l"(db), "r"((uint32_t)zero));
}

// the same product with both operands MN-major (the transpose bits set): A
// stored as (K rows x M columns), B as (K rows x N columns)
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t da, uint64_t db,
                                                bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIMO_REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : VIMO_ACC32
      : "l"(da), "l"(db), "r"((uint32_t)zero));
}

// D (64 x 64, float32) += A . B, A (64 x 16 bf16) in registers, B an
// MN-major bf16 tile in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIMO_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VIMO_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1u));
}

#undef VIMO_ACC32
#undef VIMO_REGS32

// D (64 x 128, float32) += A . B, A (64 x 16 bf16) in registers, B an
// MN-major bf16 tile in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1u));
}

// D (64 x 128, float32) {+}= A . B^T, A (64 x 16 bf16) in registers, B a
// K-major bf16 operand in shared memory; accumulate unless `zero`
__device__ __forceinline__ void wgmma_rs_n128_k(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                bool zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((uint32_t)zero));
}

// D (64 x 16, float32) += A . B, A (64 x 16 bf16) in registers, B an
// MN-major bf16 operand in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1u));
}

// D (64 x 32, float32) += A . B, A (64 x 16 bf16) in registers, B an
// MN-major bf16 operand in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1u));
}

// D (64 x 48, float32) += A . B, A (64 x 16 bf16) in registers, B an
// MN-major bf16 operand in shared memory
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1u));
}

// acc += A . B for a 64 x 16 register slice A and an MN-major operand B of
// N columns (16, 32, 48, 64 or 128) described by `db`
template <int N>
__device__ __forceinline__ void wgmma_rs_n(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) {
    wgmma_rs_n16(acc, a, db);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(acc, a, db);
  } else if constexpr (N == 48) {
    wgmma_rs_n48(acc, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(acc, a, db);
  } else {
    static_assert(N == 128, "wgmma_rs_n: N is 16, 32, 48, 64 or 128");
    wgmma_rs_n128(acc, a, db);
  }
}

// acc (+)= A . B for a 64 x 16 register slice A and the MN-major k-step kk
// of tile B, N = 64 * NC
template <int NC>
__device__ __forceinline__ void wgmma_rs(float (&acc)[32 * NC], const uint32_t (&a)[4],
                                         const bf16* tile, int kk) {
  if constexpr (NC == 1) {
    wgmma_rs_n64(acc, a, mnmajor_desc(tile, kk));
  } else {
    wgmma_rs_n128(acc, a, mnmajor_desc(tile, kk));
  }
}

// ---------------------------------------------------------------------------
// registers and elementwise steps
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator columns 16c .. 16c + 15 (rounded to bf16) as the A operand of
// k-step c
__device__ __forceinline__ void to_a_operand(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][0] = pack_bf16(d[8 * c + 0], d[8 * c + 1]);
    a[c][1] = pack_bf16(d[8 * c + 2], d[8 * c + 3]);
    a[c][2] = pack_bf16(d[8 * c + 4], d[8 * c + 5]);
    a[c][3] = pack_bf16(d[8 * c + 6], d[8 * c + 7]);
  }
}

// the same for a 64 x 128 accumulator: the A operands of eight k-steps
__device__ __forceinline__ void to_a_operand(const float (&d)[64], uint32_t (&a)[8][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c][0] = pack_bf16(d[8 * c + 0], d[8 * c + 1]);
    a[c][1] = pack_bf16(d[8 * c + 2], d[8 * c + 3]);
    a[c][2] = pack_bf16(d[8 * c + 4], d[8 * c + 5]);
    a[c][3] = pack_bf16(d[8 * c + 6], d[8 * c + 7]);
  }
}

// exp(x) as 2^(x log2 e) on the special-function unit: a few float32 ulp
// from expf, far inside the bf16 rounding of P that follows; exp(-inf) = 0
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// 1 / (1 - rate) where element (r, j) of a tile's keep bits is set, else 0:
// a product, not a branch on random bits
__device__ __forceinline__ float keep_scale(const uint32_t* bits, int r, int j, float inv_keep) {
  return __uint2float_rn((bits[2 * r + (j >> 5)] >> (j & 31)) & 1u) * inv_keep;
}

// dst = round_bf16(src * scale) over NC chunks, 8 elements per step (the
// swizzle permutes 16-byte pieces, so an elementwise pass ignores it)
template <int NC>
__device__ __forceinline__ void scale_tile(bf16* dst, const bf16* src, float scale, int tid) {
  for (int i = tid; i < NC * kChunk / 8; i += kConsumers) {
    uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    bf16* x = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __float2bfloat16_rn(__bfloat162float(x[e]) * scale);
    reinterpret_cast<uint4*>(dst)[i] = raw;
  }
}

// rows r0 + (row of the accumulator) of a (T, D) output, times `mul`, as bf16
template <int NC>
__device__ __forceinline__ void store_rows(bf16* out, long long st, int r0, int t, int d,
                                           const float (&acc)[32 * NC], float mul, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8 * NC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + warp * 16 + g + 8 * (e >> 1);
      const int c = 8 * j + 2 * t4 + (e & 1);
      if (row < t && c < d) out[(long long)row * st + c] = __float2bfloat16_rn(acc[4 * j + e] * mul);
    }
  }
}

// a float2 from shared memory, kept in program order among the asm
// statements around it: the compiler cannot hoist the load, and the
// registers it takes, above a wgmma wait
__device__ __forceinline__ float2 ld_shared_f2(const float* ptr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(ptr)));
  return v;
}

// the pointer, opaque to the compiler at this point: the shared-memory
// descriptors built from it are computed here, not hoisted out of the loop
// around it to hold registers for its whole length
template <typename T>
__device__ __forceinline__ T* opaque(T* ptr) {
  asm volatile("" : "+l"(ptr));
  return ptr;
}

// the shared-memory address of `ptr`, opaque as above, in 32 bits
__device__ __forceinline__ uint32_t opaque_u32(const void* ptr) {
  uint32_t a = smem_u32(ptr);
  asm volatile("" : "+r"(a));
  return a;
}

// 1024-byte aligned start of dynamic shared memory (the swizzle atom)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t off = smem_u32(p) & 1023u;
  return off ? p + (1024u - off) : p;
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against libcuda)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// TMA can address a (B, H, T, D) operand of `elem`-byte elements in place:
// 16-byte aligned start, every stride a positive multiple of 16 bytes
inline bool tma_legal(const void* ptr, long long sb, long long sh, long long st, int elem = 2) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const long long strides[] = {sb, sh, st};
  for (long long s : strides)
    if (s <= 0 || s * elem % 16) return false;
  return true;
}

// dims (D, T, H, B) of a bf16 (or, with `f32`, float32) operand through its
// strides, boxes of `cols` x `rows`, the given swizzle, zeros out of bounds;
// 0, or -4 when cuTensorMapEncodeTiled refuses
inline int encode_box_map(CUtensorMap* map, const void* ptr, int B, int H, int t, int D,
                          long long sb, long long sh, long long st, int cols, int rows,
                          CUtensorMapSwizzle swizzle, bool f32 = false) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return -4;
  const cuuint64_t elem_bytes = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)t, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * elem_bytes, (cuuint64_t)sh * elem_bytes,
                                 (cuuint64_t)sb * elem_bytes};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : -4;
}

// dims (D, T, H, B) of a bf16 (or, with `f32`, float32) operand through its
// strides, boxes of 128 bytes (64 bf16 or 32 float32 columns) x 64 rows,
// 128-byte swizzle, zeros out of bounds; 0, or -4 when the driver refuses
inline int encode_map(CUtensorMap* map, const void* ptr, int B, int H, int t, int D,
                      long long sb, long long sh, long long st, bool f32 = false) {
  return encode_box_map(map, ptr, B, H, t, D, sb, sh, st, f32 ? 32 : 64, kTile,
                        CU_TENSOR_MAP_SWIZZLE_128B, f32);
}

}  // namespace vimo

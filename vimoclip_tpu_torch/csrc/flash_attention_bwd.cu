// Masked multi-head attention backward, for NVIDIA Hopper (sm_90a). Plain C
// entry point, bound from Python with ctypes
// (vimoclip_tpu_torch/ops/kernels/flash_attention.py), where a
// torch.autograd.Function pairs it with the forward's lse variant.
//
// Replaces: vimoclip_tpu/ops/pallas/flash_attention.py::_bwd_local and its
// three kernels:
//   K2 _dqkv_single_kernel (:282, call :461; keys fit one 512-key tile):
//                                                        entry `which` = 0
//   K3 _dq_kernel  (:214, call :493; dq sweep over key tiles, Tk > 512): 1
//   K4 _dkv_kernel (:244, call :519; dk/dv sweep over query tiles):      2
//
// What it computes, per (b, h), from the forward's lse and
// delta = rowsum(dO * O) (both float32, computed outside, as on the TPU):
//   s  = round_T(q * scale) . k + bias        (float32; bias -1e9 masked key,
//                                              keys past Tk left out)
//   P  = exp(s - lse)
//   dP = keep ? (dO . v) / (1 - rate) : 0      (keep: the forward's Philox
//                                              bits, flash_attention_common.cuh,
//                                              at the global coordinates
//                                              (row0 + row, col0 + key))
//   dS = P * (dP - delta)
//   dQ = round_T(dS) . K * scale,  dK = round_T(dS)^T . Q * scale,
//   dV = round_T(keep ? P / (1 - rate) : 0)^T . dO
// with float32 accumulators throughout and one rounding to T at the store,
// the rounding points of the TPU kernels (flash_attention.py:199-231, 262,
// 268). T is float32 or bfloat16. A fully masked row has lse = -1e9 and so
// recomputes P = 1 for each real key, as the TPU kernels do. No atomics
// anywhere: every sum runs in a fixed order, so two calls give bitwise-equal
// gradients.
//
// float32 K4 and K2 (dkv_tf32_kernel, and dq_reduce_kernel for K2's dq
// sum), at every head dim: three TF32 passes on the tensor cores per product
// (tf32.cuh: each operand split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), A.B = A_lo.B_hi + A_hi.B_lo + A_hi.B_hi in float32,
// about 2^-21 relative error a product). Bound: 3 x the FLOPs at 495
// TFLOP/s: K2 at (8, 8, 384, 384, 64) 6.04 GFLOP x 3 = 0.0366 ms, K4 at
// (8, 8, 1024, 1024, 64) 34.4 GFLOP x 3 = 0.208 ms. One CTA per (64-key
// tile, output slice of up to 128 columns, head, batch row), one producer
// warp and one consumer warpgroup. Per q tile the producer streams, through
// a three-slot ring of two-chunk slots (64 rows x 64 float32 columns a
// chunk, two 32-column 128-byte-swizzled TMA boxes, zeros past Tq, Tk and
// D), the head dim's (k, q) chunk pairs, then its (v, dO) pairs, then the
// slice's dO and q chunks, with the rows' lse and delta by tile parity.
// S^T = K (q * scale)^T and dP^T = V dO^T run on wgmma m64n64k8 (SS), each
// slot's chunks split in place into hi with their lo beside them (TF32 wgmma
// reads K-major operands only, and these are); q * scale is rounded to
// float32 first, the plain version's rounding point. P = exp(S + bias - lse)
// goes to shared memory (query rows x keys) before dP^T starts, so the two
// score accumulators never hold registers together; then dS = P (dP -
// delta) and the dropped P / (1 - rate) replace it there. dV += P^T dO and
// dK += dS^T q need dO and q as MN-major operands, which TF32 wgmma cannot
// read, so mma.sync m16n8k8 runs them: A gathered from P and dS in shared
// memory, B rows gathered from the raw slot, both split in registers (the
// k-step loop unrolled only for K4 at D <= 64: elsewhere hoisted loads of
// later k-steps spilled, and one k-step at a time ran faster). K2's dq share of the slice, dS K
// over the CTA's 64 keys, is an mma.sync too (A the rows of dS, B the
// slice's k chunks, resident raw), written to float32 scratch (B, H, nk,
// Tq, D) that dq_reduce_kernel adds up in tile order: no atomics. dK =
// scale (dS^T q) from unscaled q, as before. K4 and K2 both draw their own
// keep bits per tile (the float32 K3 writes none) and gather each thread's
// 32 into one word, as bf16 K2 does. Shared memory: ring 96 KB + lo 32 KB +
// P and dS 34 KB: 169,272 bytes for K4; K2 adds the slice's k chunks,
// 185,656 bytes at D <= 64 and 202,040 above; one CTA per SM. ptxas -v
// (sm_90a; p = 0 / 0.1): K4 212 / 208 registers at D <= 64, 252 / 251
// above, no spills; K2 223 / 224 at D <= 64, no spills, and 255 above,
// where dK and dV hold 128 and it spills 184 / 176 bytes.
// float32 K3 (dq_tf32_kernel up to head dim 128, dq_tf32_wide_kernel
// above), three TF32 passes a product as K4's. Bound: 3 x the FLOPs (S, dP
// and dS K: 6 B H Tq Tk D) at 495 TFLOP/s: 0.0879 ms at (8, 8, 768, 768, 64)
// and (8, 2, 768, 768, 256), 0.156 ms at (8, 8, 1024, 1024, 64). One
// producer warp per consumer warpgroup streams one-chunk slots (16 KB)
// through a three-slot ring; per key tile dP = dO V^T and then S =
// (q * scale) K^T run on wgmma m64n64k8 (SS) with query rows as M, both
// operands K-major along D and split in place (the lo beside); P = exp(S +
// bias - lse), dP dropped with the tile's Philox bits drawn by the
// warpgroup, dS = P (dP - delta) in registers; dq += dS K on mma.sync (K an
// MN-major B: its rows gathered from a raw k chunk, streamed again, and
// split in registers, as O += P V in the forward); dq x scale stored once
// per CTA: no scratch, no atomics, no keep-bit buffer. What was measured
// (PERF.md, tools/time_bwd_variants.py): at D <= 64 two CTAs per SM with q
// and dO streamed and split per tile (85,048 bytes, 167 / 168 registers at
// p = 0 / 0.1) beat one CTA with them split once and resident (134,200
// bytes); at D 65-128 resident q and dO win (199,736 bytes, 212 / 218
// registers, one CTA); gathering the update's B as hi and lo from S's split
// k chunk, P through shared memory, and overlapping each split with the
// previous chunk's products were all slower. Above 128 (183,392 bytes, 168
// registers, one CTA per SM) one CTA per (q tile, pair of 128-column
// slices) runs two consumer warpgroups, each with its own producer warp and
// ring: warpgroup 0 computes S over the whole head dim and writes P to
// shared memory, warpgroup 1 computes dP and turns P into dS there, and each
// accumulates its slice of dq. So S and dP run once per pair of slices (a
// CTA per slice, the scheme K4 and K2 keep, ran them once per slice, and
// spilled 436 / 468 bytes under two CTAs per SM). No spills.
//
// bfloat16: K2 (dqkv_wgmma_kernel), K3 (dq_wgmma_kernel), K4
// (dkv_wgmma_kernel), on the tensor cores from TMA-fed shared-memory tiles
// (the building blocks are in hopper.cuh).
//   Bounds: operations. K2 at its training shape (B=8, H=8, Tq=Tk=512,
//   D=64) does 10.7 GFLOP (Qs K^T, dO V^T, P^T dO, dS^T Q, dS K) = 10.9 us
//   at 989 TF/s, and moves 29.6 MB (8.8 us at 3.35 TB/s); at the long
//   batch's (8, 8, 768, 768, 64) K3 does 14.5 GFLOP (QK^T, dO V^T, dS K) =
//   14.7 us and K4 19.3 GFLOP (K Q^T, V dO^T, P^T dO, dS^T Q) = 19.5 us,
//   against 9.5 and 11.4 us of bytes. With dropout, drawing the keep bits
//   (Philox4x32-10, 10 rounds of two 32-bit multiplies per 4 keys) is more
//   integer issue than the tensor-core time: 4.2 M calls for K2's shape.
//   What the designs do about it:
//   - every product on the tensor cores: wgmma m64nNk16 (bf16 in, float32
//     accumulate). S and dP come from two shared-memory operands (SS); the
//     score tile is then turned into dS (and P) in registers, which already
//     sit in the A-operand layout of the next product (RS). K3 computes
//     S = Qs K^T and dP = dO V^T with query rows as wgmma's 64-row M; K4 and
//     K2 compute S^T = K Qs^T and dP^T = V dO^T with keys as M, so that P^T
//     and dS^T are the A operands of dV += P^T dO and dK += dS^T Q. The
//     second operand of those (K in K3; dO and Q in K4 and K2) is read
//     MN-major (transposed) from the same tile.
//   - one CTA per output tile (64 query rows for K3, 64 keys for K4 and K2,
//     per head and batch row) owns its accumulators in registers for the
//     whole sweep and stores them once.
//   - a producer warp streams the swept tiles (K, V for K3; Q, dO for K4 and
//     K2) with TMA into a two-stage ring of 128-byte-swizzled 64x64 chunks,
//     completion on mbarriers, so the next tile is in flight while one
//     warpgroup multiplies the current one. Boxes past Tq, Tk or D fill with
//     zeros: ragged lengths and head dims below 64 or 128 need no masks in
//     the loads. The producer also stages the tile's key bias (K3) or its
//     rows' lse and delta (K4, K2; lse = +inf past Tq, so P = 0 there).
//   - the keep bits: K3 draws them (the consumers fill a tile's bitmask while
//     its first products run) and writes each 64x64 tile's bits as 512
//     contiguous bytes of a (B, H, ceil(Tk/64), 64 ceil(Tq/64), 2) uint32
//     buffer; K4, launched after it, takes them with one bulk copy per tile
//     beside its TMA loads. K2 has no K3 before it and draws its own: those
//     of q tile t + 1 while tile t's dV/dK products run, where the S^T and
//     dP^T accumulators no longer hold registers.
//   - K2's dQ: its CTA's share for each q tile, round(dS) K over its 64 keys,
//     needs dS with query rows as M. dS^T, already rounded to bf16 as dK's A
//     operand, goes to a swizzled 64x64 shared tile (double-buffered, so the
//     next tile never overwrites it under a running product), and a third
//     SS product reads it back MN-major (the transpose bits) with K's
//     resident tile MN-major as B; a head dim of 128 takes two 64-column
//     halves through one reused accumulator. The shares go to float32
//     scratch (B, H, nk, Tq, D) that dq_reduce_kernel adds up in tile order:
//     at the training shape 67 MB written and read back. Summing them instead
//     across the nk <= 8 key-tile CTAs of one (b, h) as a thread block
//     cluster, through distributed shared memory, was slower with dropout
//     (PERF.md): its per-tile cluster barrier and its extra registers
//     cost more than the round trip.
//   - registers: at D = 64 two CTAs share an SM (168 registers a thread), and
//     S^T, dP^T, dK and dV alone hold 128. So the dq accumulator takes its
//     registers only after the dV/dK products have released those of P^T and
//     dS^T; the keep bits of the next tile are drawn two Philox calls at a
//     time under those products, and each thread gathers its 32 bits into
//     one word; the elementwise pass packs its operands 16 query rows at a
//     time and loads lse and delta where it uses them. Even so ptxas spills
//     4 bytes (28 with dropout) at D = 64 (PERF.md).
//   - the elementwise step: exp(s - lse) through ex2.approx (a few float32
//     ulp from expf, before P's bf16 rounding), 1 / (1 - rate) as one
//     reciprocal per thread, the keep bit as a product rather than a branch,
//     row data (bias, lse, delta) read as float2.
//   - K4 and K2 need Q scaled and rounded (for S) and unscaled (for dK).
//     Where the scale is a power of two (D = 64: 1/8, D = 16: 1/4),
//     round(q * scale) is q * scale exactly (barring subnormals), so one tile
//     serves both and S is scaled in registers, which is bitwise the same
//     score; otherwise the consumers write a scaled, rounded copy of each Q
//     tile.
//   Operands TMA cannot address (a start not 16-byte aligned, a stride not a
//   multiple of 16 bytes) are copied by the Python wrapper first; the entry
//   refuses them (-5).
//
// Head dims above 128 (bf16: dq_pair_wgmma_kernel for K3,
// dkv_pair_wgmma_kernel for K4 and, with its dq share, K2; float32:
// dkv_tf32_kernel with its 128-column slices, and the float32 K3's own
// scheme above): any head dim. Both bf16 kernels take a pair of 128-column
// output slices per CTA on two consumer warpgroups and a producer
// warpgroup (384 threads; setmaxnreg moves registers from the producers to
// the consumers: 24 / 240 for K4 and K2, 40 / 232 for K3), and compute the
// score products over the whole head dim once for the pair, their chunk
// products back to back.
// K3 (bf16): one CTA per (64-row q tile, pair, head, batch row). Per key
// tile warpgroup 0 computes S and warpgroup 1 dP, and warpgroup 1 draws the
// keep bits (pair 0's CTA stores them for K4); P (float32) crosses to
// warpgroup 1 through shared memory, and dS's bf16 A operand comes back in
// its place; each warpgroup adds dS K over its slice, from the key tile's
// pair k chunks that S read too (no second load of k). q (rounded once) and
// dO stay resident up to D 576 and stream with each key tile above; one or
// two buffers of the pair's k chunks, and rings of v chunks (and of the k
// chunks outside the pair), each filled by its own producer warp, sized per
// head dim (dq_pair_config). So S and dP run once per pair, 6 T^2 D of
// products per (batch row, head) at D 256 where a CTA per slice runs 10 (10
// against 18 at D 512), and q and dO are read once per CTA, not once per
// key tile. ptxas -v (sm_90a): 168 registers at launch, no spills (at 24 /
// 240 the producers spilled 48-64 bytes); 199,304 bytes of shared memory
// at D 256, 231,800 at D 512, one CTA per SM. What bounds it (PERF.md,
// tools/time_bwd_variants.py): no one step of a key tile's chain (the
// loads, S and dP, the exchange, the update) but their sum; issuing the
// next tile's products before this tile's exchange, 16-byte exchange
// accesses and both warpgroups drawing the keep bits were each slower.
// K4 and K2 (bf16): one CTA per (64-key tile, pair, head, batch row). Per q
// tile warpgroup 0 computes S^T and warpgroup 1 dP^T; P^T (float32) and
// dS^T (bf16, swizzled) cross through shared memory; each warpgroup
// updates its slice's dk and dv, and for K2 adds dS K over its slice to the
// dq scratch. The CTA's k and v are loaded once and stay resident up to D
// 384; above, they stream once per q tile with the chunks outside the
// pair. q and dO are loaded once per q tile, into two buffers where they
// fit (dkv_pair_config: up to D 256, and K4 where k and v stream), else one.
// With dropout both read the keep bits of each (key tile, q tile) with one
// bulk copy: K4 from K3's buffer, K2 from the same layout filled first by
// keep_bits_kernel. ptxas -v (sm_90a): 168 registers at launch for all four
// instantiations (240 after setmaxnreg), no spills; at D 256 224,664 bytes
// of shared memory, one CTA per SM.

#include <type_traits>

#include "flash_attention_common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace vimo;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const uint8_t* mask;  // (B, Tk), nonzero = ignore the key; may be null
  const float* lse;     // (B, H, Tq) contiguous
  const float* delta;   // (B, H, Tq) contiguous
  const int* seed;      // (B, H) contiguous; null = no dropout
  void* dq;
  void* dk;
  void* dv;
  float* dq_part;       // (B, H, nk, Tq, D) contiguous scratch (K2 only)
  uint32_t* keep_bits;  // (B, H, nk, tq_pad, 2) keep bits, bf16 K3 -> K4 with dropout
  int tq_pad;           // Tq rounded up to 64
  int B, H, Tq, Tk, D;
  int row0, col0;       // global (query row, key) of element (0, 0): dropout bits
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  long long m_sb;
  float scale;
  uint32_t threshold;
  float keep;           // 1 - rate
  float inv_keep;       // 1 / (1 - rate)
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// K2's second pass: dq = sum over the nk key tiles' shares, in tile order.
template <typename T>
__global__ void dq_reduce_kernel(const BwdParams p, int n_kt) {
  const long long n = (long long)p.B * p.H * p.Tq * p.D;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = (int)(idx % p.D);
  const int row = (int)((idx / p.D) % p.Tq);
  const long long bh = idx / ((long long)p.D * p.Tq);
  const int b = (int)(bh / p.H), h = (int)(bh % p.H);
  const long long tile = (long long)p.Tq * p.D;
  const float* src = p.dq_part + bh * n_kt * tile + (long long)row * p.D + c;
  float sum = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) sum += src[kt * tile];
  static_cast<T*>(p.dq)[b * p.dq_sb + h * p.dq_sh + row * p.dq_st + c] = from_f<T>(sum);
}

// ---------------------------------------------------------------------------
// K3 / K4 in bfloat16
// ---------------------------------------------------------------------------

constexpr uint32_t kBitsBytes = 2 * kTile * sizeof(uint32_t);  // keep bits of a 64x64 tile

template <int NC>
constexpr size_t dq_hop_smem_bytes() {
  return 1024 + (size_t)(2 + 2 * kStages) * NC * kChunk * sizeof(bf16) +
         sizeof(float) * kStages * kTile + sizeof(uint32_t) * 2 * 2 * kTile +
         sizeof(uint64_t) * (2 * kStages + 1);
}

template <int NC, bool POW2>
constexpr size_t dkv_hop_smem_bytes() {
  return 1024 + (size_t)(2 + 2 * kStages + (POW2 ? 0 : 1)) * NC * kChunk * sizeof(bf16) +
         (sizeof(float) * 2 * kTile + sizeof(uint32_t) * 2 * kTile) * kStages +
         sizeof(uint64_t) * (2 * kStages + 1);
}

// ---------------------------------------------------------------------------
// K3 (bf16): dq, one CTA per (64-row q tile, head, batch row)
// ---------------------------------------------------------------------------

template <int NC, bool DROP>
__global__ void __launch_bounds__(kHopThreads, 2) dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p) {
  constexpr int KS = 4 * NC;  // k-steps of the S and dP products
  constexpr uint32_t kTileBytes = NC * kChunk * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));  // round(q * scale)
  bf16* dOs = Qs + NC * kChunk;
  bf16* Kring = dOs + NC * kChunk;                // kStages tiles
  bf16* Vring = Kring + kStages * NC * kChunk;
  float* bias_ring = reinterpret_cast<float*>(Vring + kStages * NC * kChunk);  // kStages x 64
  uint32_t* bits = reinterpret_cast<uint32_t*>(bias_ring + kStages * kTile);   // 2 x 128 words
  uint64_t* full = reinterpret_cast<uint64_t*>(bits + 2 * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tk + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: q and dO once, then K/V tiles and their key bias
    const int lane = tid - kConsumers;
    const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * kTileBytes);
      for (int c = 0; c < NC; ++c) {
        tma_load(Qs + c * kChunk, &tm_q, qbar, 64 * c, q0, h, b);
        tma_load(dOs + c * kChunk, &tm_do, qbar, 64 * c, q0, h, b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, k0 = t * kTile;
      if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
      if (lane == 0) {  // the copies first, so they fly while the bias loads
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        for (int c = 0; c < NC; ++c) {
          tma_load(Kring + (s * NC + c) * kChunk, &tm_k, &full[s], 64 * c, k0, h, b);
          tma_load(Vring + (s * NC + c) * kChunk, &tm_v, &full[s], 64 * c, k0, h, b);
        }
      }
      for (int j = lane; j < kTile; j += 32) {
        const int key = k0 + j;
        bias_ring[s * kTile + j] =
            key >= p.Tk ? neg_inf() : (mask != nullptr && mask[key] ? kMaskValue : 0.f);
      }
      mbar_arrive(&full[s]);  // each lane after its own writes
    }
    return;
  }

  // consumer warpgroup: rows r_lo and r_lo + 8 of the tile per thread
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = warp * 16 + g;
  float lse_r[2], delta_r[2];
  bool row_in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_lo + 8 * r;
    row_in[r] = row < p.Tq;
    lse_r[r] = row_in[r] ? p.lse[bh * p.Tq + row] : 0.f;
    delta_r[r] = row_in[r] ? p.delta[bh * p.Tq + row] : 0.f;
  }
  const uint32_t seed = DROP ? (uint32_t)p.seed[bh] : 0u;
  // times 1 / (1 - rate): within a float32 ulp of the division, before the
  // bf16 rounding of dS
  const float inv_keep = 1.f / p.keep;

  mbar_wait(qbar, 0);
  scale_tile<NC>(Qs, Qs, p.scale, tid);
  fence_proxy_async();
  consumer_sync();

  float acc[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, k0 = t * kTile;
    const bf16* Ks = Kring + s * NC * kChunk;
    const bf16* Vs = Vring + s * NC * kChunk;
    mbar_wait(&full[s], (t / kStages) & 1);

    float sacc[32], dpacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(sacc, kmajor_desc(Qs, kk), kmajor_desc(Ks, kk), kk == 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(dpacc, kmajor_desc(dOs, kk), kmajor_desc(Vs, kk), kk == 0);
    wg_commit();

    // the keep bits of this tile while the products run (drawn by the
    // consumers: a producer warp alone is slower than the products);
    // double-buffered, so one barrier per tile orders the fill against every
    // reader. K4 reads them back: each thread stores its own word into the
    // tile's 512 contiguous bytes.
    uint32_t* tb = bits + (t & 1) * 2 * kTile;
    if constexpr (DROP) {
      fill_keep_bits(tb, kTile, p.row0 + q0, p.col0 + k0, seed, p.threshold, tid,
                     kConsumers);
      p.keep_bits[((bh * n_tiles + t) * p.tq_pad + q0) * 2 + tid] = tb[tid];
      consumer_sync();
    }
    wg_wait_all();
    fence_regs(sacc);
    fence_regs(dpacc);

    const float* bias = bias_ring + s * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // columns 8j + 2 t4 and the next: one 8-byte load of their bias
      const float2 bias2 = reinterpret_cast<const float2*>(bias)[4 * j + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * t4 + (e & 1);
        const float pj = exp_approx(sacc[4 * j + e] + ((e & 1) ? bias2.y : bias2.x) - lse_r[r]);
        float dpj = dpacc[4 * j + e];
        if constexpr (DROP) dpj *= keep_scale(tb, r_lo + 8 * r, col, inv_keep);
        sacc[4 * j + e] = row_in[r] ? pj * (dpj - delta_r[r]) : 0.f;  // dS
      }
    }
    uint32_t a[4][4];
    to_a_operand(sacc, a);
    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<NC>(acc, a[c], Ks, c);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<NC>(dq, p.dq_st, q0, p.Tq, p.D, acc, p.scale, tid);
}

// ---------------------------------------------------------------------------
// K4 (bf16): dk, dv, one CTA per (64-key tile, head, batch row)
// ---------------------------------------------------------------------------

template <int NC, bool DROP, bool POW2>
__global__ void __launch_bounds__(kHopThreads, NC == 1 ? 2 : 1) dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p) {
  constexpr int KS = 4 * NC;
  constexpr uint32_t kTileBytes = NC * kChunk * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* Vs = Ks + NC * kChunk;
  bf16* Qring = Vs + NC * kChunk;               // kStages tiles of unscaled q
  bf16* dOring = Qring + kStages * NC * kChunk;
  bf16* Qsc = dOring + kStages * NC * kChunk;   // round(q * scale), !POW2 only
  float* lse_ring = reinterpret_cast<float*>(Qsc + (POW2 ? 0 : NC * kChunk));  // kStages x 64
  float* delta_ring = lse_ring + kStages * kTile;
  uint32_t* bits_ring = reinterpret_cast<uint32_t*>(delta_ring + kStages * kTile);  // kStages x 128
  uint64_t* full = reinterpret_cast<uint64_t*>(bits_ring + kStages * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: K and V once, then Q/dO tiles with their rows' lse,
    // delta (P = 0 past Tq) and K3's keep bits
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * kTileBytes);
      for (int c = 0; c < NC; ++c) {
        tma_load(Ks + c * kChunk, &tm_k, kvbar, 64 * c, k0, h, b);
        tma_load(Vs + c * kChunk, &tm_v, kvbar, 64 * c, k0, h, b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, q0 = t * kTile;
      if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
      if (lane == 0) {  // the copies first, so they fly while the rows' data loads
        mbar_expect_tx(&full[s], 2 * kTileBytes + (DROP ? kBitsBytes : 0));
        for (int c = 0; c < NC; ++c) {
          tma_load(Qring + (s * NC + c) * kChunk, &tm_q, &full[s], 64 * c, q0, h, b);
          tma_load(dOring + (s * NC + c) * kChunk, &tm_do, &full[s], 64 * c, q0, h, b);
        }
        if constexpr (DROP)  // K3's keep bits of this (key tile, q tile): 512 bytes
          bulk_load(bits_ring + s * 2 * kTile,
                    p.keep_bits + ((bh * gridDim.x + blockIdx.x) * p.tq_pad + q0) * 2,
                    kBitsBytes, &full[s]);
      }
      for (int r = lane; r < kTile; r += 32) {
        const bool in = q0 + r < p.Tq;
        lse_ring[s * kTile + r] = in ? p.lse[bh * p.Tq + q0 + r] : pos_inf();
        delta_ring[s * kTile + r] = in ? p.delta[bh * p.Tq + q0 + r] : 0.f;
      }
      mbar_arrive(&full[s]);  // each lane after its own writes
    }
    return;
  }

  // consumer warpgroup: keys kl_lo and kl_lo + 8 of the tile per thread
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kl_lo = warp * 16 + g;
  const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kl_lo + 8 * r;
    kbias[r] = key >= p.Tk ? neg_inf() : (mask != nullptr && mask[key] ? kMaskValue : 0.f);
  }
  const float inv_keep = 1.f / p.keep;
  mbar_wait(kvbar, 0);

  float dk[32 * NC], dv[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) dk[i] = dv[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const bf16* Qt = Qring + s * NC * kChunk;
    const bf16* dOt = dOring + s * NC * kChunk;
    const float* lse_t = lse_ring + s * kTile;
    const float* delta_t = delta_ring + s * kTile;
    const uint32_t* bits_t = bits_ring + s * 2 * kTile;
    mbar_wait(&full[s], (t / kStages) & 1);
    const bf16* Qscore = Qt;
    if constexpr (!POW2) {
      scale_tile<NC>(Qsc, Qt, p.scale, tid);
      fence_proxy_async();
      consumer_sync();
      Qscore = Qsc;
    }

    float sacc[32], dpacc[32];  // S^T and dP^T: keys x query rows
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(sacc, kmajor_desc(Ks, kk), kmajor_desc(Qscore, kk), kk == 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(dpacc, kmajor_desc(Vs, kk), kmajor_desc(dOt, kk), kk == 0);
    wg_commit();
    wg_wait_all();
    fence_regs(sacc);
    fence_regs(dpacc);
    if constexpr (!POW2) consumer_sync();  // every warp's S^T has read Qsc

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // query rows 8j + 2 t4 and the next: one 8-byte load each of lse, delta
      const float2 lse2 = reinterpret_cast<const float2*>(lse_t)[4 * j + t4];
      const float2 delta2 = reinterpret_cast<const float2*>(delta_t)[4 * j + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * t4 + (e & 1);
        // POW2: the unscaled product times the power-of-two scale is the
        // scaled product, bit for bit
        const float sv = POW2 ? sacc[4 * j + e] * p.scale : sacc[4 * j + e];
        const float pj = exp_approx(sv + kbias[r] - ((e & 1) ? lse2.y : lse2.x));
        float pd = pj, dpj = dpacc[4 * j + e];
        if constexpr (DROP) {
          const float m = keep_scale(bits_t, col, kl_lo + 8 * r, inv_keep);
          pd *= m;
          dpj *= m;
        }
        sacc[4 * j + e] = pd;                                                // P^T, dropped
        dpacc[4 * j + e] = pj * (dpj - ((e & 1) ? delta2.y : delta2.x));     // dS^T
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_operand(sacc, pa);
    to_a_operand(dpacc, dsa);
    wg_fence();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs<NC>(dv, pa[c], dOt, c);
      wgmma_rs<NC>(dk, dsa[c], Qt, c);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[s]);
  }

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<NC>(dkp, p.dk_st, k0, p.Tk, p.D, dk, p.scale, tid);
  store_rows<NC>(dvp, p.dv_st, k0, p.Tk, p.D, dv, 1.f, tid);
}

// ---------------------------------------------------------------------------
// K2 (bf16): dq, dk, dv in one pass, one CTA per (64-key tile, head, batch
// row)
// ---------------------------------------------------------------------------

template <int NC, bool POW2>
constexpr size_t dqkv_hop_smem_bytes() {
  return 1024 + (size_t)(2 + 2 * kStages + (POW2 ? 0 : 1)) * NC * kChunk * sizeof(bf16) +
         2 * kChunk * sizeof(bf16) + sizeof(float) * 2 * kTile * kStages +
         sizeof(uint32_t) * 2 * 2 * kTile + sizeof(uint64_t) * (2 * kStages + 1);
}

// round(dS)^T, packed as the A operand of k-steps 0-3 (keys r_lo, r_lo + 8 x
// query-row pairs), into a 64 x 64 bf16 tile in the 128-byte swizzle's
// layout: 16-byte chunk c of row r at chunk c ^ (r % 8)
__device__ __forceinline__ void store_swizzled(bf16* tile, const uint32_t (&a)[4][4], int r_lo,
                                               int t4) {
  uint8_t* base = reinterpret_cast<uint8_t*>(tile);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r_lo + 8 * (i & 1), chunk = 2 * c + (i >> 1);
      *reinterpret_cast<uint32_t*>(base + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t4) = a[c][i];
    }
  }
}

// the keep bits of a thread's two keys (kl_lo, kl_lo + 8) and sixteen query
// rows (8j + 2 t4 + i, j < 8, i < 2) of a tile, gathered from the tile's
// bitmask into one word: bit 2 (2j + i) + r for key kl_lo + 8r
__device__ __forceinline__ uint32_t gather_keep(const uint32_t* bits, int kl_lo, int t4) {
  uint32_t out = 0u;
#pragma unroll
  for (int jc = 0; jc < 16; ++jc) {
    const uint32_t word = bits[2 * (8 * (jc >> 1) + 2 * t4 + (jc & 1)) + (kl_lo >> 5)];
    out |= ((word >> (kl_lo & 31)) & 1u) << (2 * jc);
    out |= ((word >> ((kl_lo + 8) & 31)) & 1u) << (2 * jc + 1);
  }
  return out;
}

template <int NC, bool DROP, bool POW2>
__global__ void __launch_bounds__(kHopThreads, NC == 1 ? 2 : 1) dqkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p) {
  constexpr int KS = 4 * NC;
  constexpr uint32_t kTileBytes = NC * kChunk * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* Vs = Ks + NC * kChunk;
  bf16* Qring = Vs + NC * kChunk;               // kStages tiles of unscaled q
  bf16* dOring = Qring + kStages * NC * kChunk;
  bf16* Qsc = dOring + kStages * NC * kChunk;   // round(q * scale), !POW2 only
  bf16* dSt = Qsc + (POW2 ? 0 : NC * kChunk);   // 2 tiles of round(dS)^T (keys x rows)
  float* lse_ring = reinterpret_cast<float*>(dSt + 2 * kChunk);  // kStages x 64
  float* delta_ring = lse_ring + kStages * kTile;
  uint32_t* bits = reinterpret_cast<uint32_t*>(delta_ring + kStages * kTile);  // 2 x 128
  uint64_t* full = reinterpret_cast<uint64_t*>(bits + 2 * 2 * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kvbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: K and V once, then Q/dO tiles with their rows' lse and
    // delta (P = 0 past Tq)
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * kTileBytes);
      for (int c = 0; c < NC; ++c) {
        tma_load(Ks + c * kChunk, &tm_k, kvbar, 64 * c, k0, h, b);
        tma_load(Vs + c * kChunk, &tm_v, kvbar, 64 * c, k0, h, b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, q0 = t * kTile;
      if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
      if (lane == 0) {  // the copies first, so they fly while the rows' data loads
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        for (int c = 0; c < NC; ++c) {
          tma_load(Qring + (s * NC + c) * kChunk, &tm_q, &full[s], 64 * c, q0, h, b);
          tma_load(dOring + (s * NC + c) * kChunk, &tm_do, &full[s], 64 * c, q0, h, b);
        }
      }
      for (int r = lane; r < kTile; r += 32) {
        const bool in = q0 + r < p.Tq;
        lse_ring[s * kTile + r] = in ? p.lse[bh * p.Tq + q0 + r] : pos_inf();
        delta_ring[s * kTile + r] = in ? p.delta[bh * p.Tq + q0 + r] : 0.f;
      }
      mbar_arrive(&full[s]);  // each lane after its own writes
    }
    return;
  }

  // consumer warpgroup: keys kl_lo and kl_lo + 8 of the tile per thread
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kl_lo = warp * 16 + g;
  const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kl_lo + 8 * r;
    kbias[r] = key >= p.Tk ? neg_inf() : (mask != nullptr && mask[key] ? kMaskValue : 0.f);
  }
  const float inv_keep = 1.f / p.keep;
  // this CTA's dq shares: (B, H, nk, Tq, D) float32, added up by dq_reduce_kernel
  float* part = p.dq_part + (bh * gridDim.x + blockIdx.x) * p.Tq * p.D;
  // the keep bits of each q tile are drawn while the previous tile's dV/dK
  // products run (there S^T and dP^T no longer hold registers), two Philox
  // calls at a time, and each thread gathers its 32 of them into one word;
  // the first tile's here
  uint32_t keep_word = 0u;
  if constexpr (DROP) {
    fill_keep_bits<2>(bits, kTile, p.row0, p.col0 + k0, (uint32_t)p.seed[bh], p.threshold, tid,
                      kConsumers);
    consumer_sync();
    keep_word = gather_keep(bits, kl_lo, t4);
  }
  mbar_wait(kvbar, 0);

  float dk[32 * NC], dv[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) dk[i] = dv[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, q0 = t * kTile;
    const bf16* Qt = Qring + s * NC * kChunk;
    const bf16* dOt = dOring + s * NC * kChunk;
    const float* lse_t = lse_ring + s * kTile;
    const float* delta_t = delta_ring + s * kTile;
    // double-buffered: a tile's keep bits and dS^T are rewritten two tiles
    // later, after every warp has passed the barrier of the tile between
    bf16* ds_tile = dSt + (t & 1) * kChunk;
    mbar_wait(&full[s], (t / kStages) & 1);
    const bf16* Qscore = Qt;
    if constexpr (!POW2) {
      scale_tile<NC>(Qsc, Qt, p.scale, tid);
      fence_proxy_async();
      consumer_sync();
      Qscore = Qsc;
    }

    float sacc[32], dpacc[32];  // S^T and dP^T: keys x query rows
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(sacc, kmajor_desc(Ks, kk), kmajor_desc(Qscore, kk), kk == 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(dpacc, kmajor_desc(Vs, kk), kmajor_desc(dOt, kk), kk == 0);
    wg_commit();
    wg_wait_all();
    fence_regs(sacc);
    fence_regs(dpacc);
    if constexpr (!POW2) consumer_sync();  // every warp's S^T has read Qsc

    // P^T (dropped) and dS^T, packed to bf16 A operands 16 query rows at a
    // time, so that the float32 tiles die as they go
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j = 2 * c; j < 2 * c + 2; ++j) {
        // query rows 8j + 2 t4 and the next: one 8-byte load each of lse,
        // delta, where they are used
        const float2 lse2 = ld_shared_f2(lse_t + 8 * j + 2 * t4);
        const float2 delta2 = ld_shared_f2(delta_t + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          // POW2: the unscaled product times the power-of-two scale is the
          // scaled product, bit for bit
          const float sv = POW2 ? sacc[4 * j + e] * p.scale : sacc[4 * j + e];
          const float pj = exp_approx(sv + kbias[r] - ((e & 1) ? lse2.y : lse2.x));
          float pd = pj, dpj = dpacc[4 * j + e];
          if constexpr (DROP) {  // 1 / (1 - rate) where kept, else 0
            const float m =
                __uint2float_rn((keep_word >> (2 * (2 * j + (e & 1)) + r)) & 1u) * inv_keep;
            pd *= m;
            dpj *= m;
          }
          sacc[4 * j + e] = pd;                                             // P^T, dropped
          dpacc[4 * j + e] = pj * (dpj - ((e & 1) ? delta2.y : delta2.x));  // dS^T
        }
      }
      pa[c][0] = pack_bf16(sacc[8 * c + 0], sacc[8 * c + 1]);
      pa[c][1] = pack_bf16(sacc[8 * c + 2], sacc[8 * c + 3]);
      pa[c][2] = pack_bf16(sacc[8 * c + 4], sacc[8 * c + 5]);
      pa[c][3] = pack_bf16(sacc[8 * c + 6], sacc[8 * c + 7]);
      dsa[c][0] = pack_bf16(dpacc[8 * c + 0], dpacc[8 * c + 1]);
      dsa[c][1] = pack_bf16(dpacc[8 * c + 2], dpacc[8 * c + 3]);
      dsa[c][2] = pack_bf16(dpacc[8 * c + 4], dpacc[8 * c + 5]);
      dsa[c][3] = pack_bf16(dpacc[8 * c + 6], dpacc[8 * c + 7]);
    }
    store_swizzled(ds_tile, dsa, kl_lo, t4);
    wg_fence();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs<NC>(dv, pa[c], dOt, c);
      wgmma_rs<NC>(dk, dsa[c], Qt, c);
    }
    wg_commit();
    // the next tile's keep bits (no K3 before K2 draws them) while these
    // products run; the barrier below orders the fill against its readers
    uint32_t* next_bits = bits + ((t + 1) & 1) * 2 * kTile;
    if constexpr (DROP) {
      if (t + 1 < n_tiles)
        fill_keep_bits<2>(next_bits, kTile, p.row0 + q0 + kTile, p.col0 + k0,
                          (uint32_t)p.seed[bh], p.threshold, tid, kConsumers);
    }
    fence_proxy_async();
    consumer_sync();  // every warp's dS^T (and the next tile's keep bits) is in place
    if constexpr (DROP) keep_word = gather_keep(next_bits, kl_lo, t4);
    // the dV/dK products are done with this slot's Q and dO, and with the
    // registers of P^T and dS^T, before the dq accumulator takes registers
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[s]);

    // this tile's share of dq: round(dS) K over the CTA's 64 keys, dS^T read
    // MN-major as the A operand and K's resident tile MN-major as B, one
    // 64-column half at a time, into the scratch (pairs of columns as one
    // 8-byte store where D is even)
#pragma unroll
    for (int hh = 0; hh < NC; ++hh) {
      float dq[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64_tt(dq, mnmajor_desc(ds_tile, kk), mnmajor_desc(Ks + hh * kChunk, kk), kk == 0);
      wg_commit();
      wg_wait_all();
      fence_regs(dq);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + kl_lo + 8 * r, c = 64 * hh + 8 * j + 2 * t4;
          if (row >= p.Tq || c >= p.D) continue;
          float* out = part + (long long)row * p.D + c;
          const float x = dq[4 * j + 2 * r] * p.scale, y = dq[4 * j + 2 * r + 1] * p.scale;
          if (p.D % 2 == 0) {
            *reinterpret_cast<float2*>(out) = make_float2(x, y);
          } else {
            out[0] = x;
            if (c + 1 < p.D) out[1] = y;
          }
        }
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<NC>(dkp, p.dk_st, k0, p.Tk, p.D, dk, p.scale, tid);
  store_rows<NC>(dvp, p.dv_st, k0, p.Tk, p.D, dv, 1.f, tid);
}

// ---------------------------------------------------------------------------
// head dims above 128 (bf16): dq, dk and dv cut into 128-column output
// slices, and one CTA per pair of them on two consumer warpgroups, the score
// products over the whole head dim once for the pair (dkv_pair_wgmma_kernel
// for K4 and K2, dq_pair_wgmma_kernel for K3, below)
// ---------------------------------------------------------------------------

constexpr int kSlice = 128;  // output columns of one consumer warpgroup

__host__ __device__ constexpr int n_slices(int d) { return (d + kSlice - 1) / kSlice; }

// a float from shared memory, kept in program order among the asm
// statements around it (as ld_shared_f2): the value is loaded where it is
// used and holds no register before
__device__ __forceinline__ float ld_shared_f1(const float* ptr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_u32(ptr)));
  return v;
}

// ---------------------------------------------------------------------------
// K4 (bf16) above head dim 128, and K2 with DQ: one CTA per (64-key tile,
// pair of 128-column output slices, head, batch row). S^T and dP^T run once
// per q tile for the pair, one on each consumer warpgroup; each warpgroup
// accumulates its slice of dk and dv (and K2's dq share of it).
// ---------------------------------------------------------------------------

// two consumer warpgroups and a producer warpgroup, one or two warps of
// which load: 168 registers a thread at launch (a pool of 384 x 168), the
// producers' 24 and the consumers' 240 after setmaxnreg, the most the pool
// allows (dk and dv of a 128-column slice hold 128 of them)
constexpr int kPairThreads = 3 * kConsumers;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kMaxSmem = 232448;  // dynamic shared memory an H100 block may take
constexpr uint32_t kPairChunkBytes = kChunk * sizeof(bf16);
// one q tile's buffer of the pair's columns: q (4 chunks), dO (4), the rows'
// lse and delta, K3's keep bits
constexpr int kUBytes = 8 * kPairChunkBytes + 2 * kTile * sizeof(float) + kBitsBytes;

// How a CTA holds its operands, chosen per head dim (dkv_pair_config): the
// CTA's own k and v loaded once and resident, or streamed with each q tile
// where shared memory forbids; one or two q-tile buffers of the pair's
// columns; the slots of each warpgroup's ring (the chunks outside the pair,
// streamed k and v, and warpgroup 0's rounded q); whether the scale is a
// power of two (S^T from unscaled q, scaled in registers: bit for bit the
// product of round(q * scale)).
struct DkvPair {
  int kv_res, nu, rs, pow2;
};

// byte offsets from the 1024-aligned base; `total` counts the alignment slack
struct DkvPairSmem {
  int kres, vres, ksl, u, ring0, ring1, ds, xp, kbias, bars, total;
};

__host__ __device__ inline DkvPairSmem dkv_pair_smem(int n_ch, const DkvPair& g, bool dq) {
  const int slot = (g.kv_res ? 1 : 2) * (int)kPairChunkBytes;
  const bool many = n_ch > 4;  // chunks outside a pair exist
  const bool r0 = !g.kv_res || many || !g.pow2, r1 = !g.kv_res || many;
  DkvPairSmem s;
  s.kres = 0;
  s.vres = s.kres + (g.kv_res ? n_ch * (int)kPairChunkBytes : 0);
  s.ksl = s.vres + (g.kv_res ? n_ch * (int)kPairChunkBytes : 0);
  s.u = s.ksl + (dq && !g.kv_res ? 4 * (int)kPairChunkBytes : 0);
  s.ring0 = s.u + g.nu * kUBytes;
  s.ring1 = s.ring0 + (r0 ? g.rs * slot : 0);
  s.ds = s.ring1 + (r1 ? g.rs * slot : 0);
  s.xp = s.ds + (int)kPairChunkBytes;
  s.kbias = s.xp + 32 * kConsumers * (int)sizeof(float);
  s.bars = s.kbias + kTile * (int)sizeof(float);
  s.total = 1024 + s.bars + (3 * g.nu + 4 * g.rs + 1) * (int)sizeof(uint64_t);
  return s;
}

// resident k and v first; then, where the rings stream k and v (each chunk
// waits out a TMA load unless slots - 1 chunks' products are in flight),
// the deeper ring before a second q-tile buffer, else the other way round
inline DkvPair dkv_pair_config(int d, float scale, bool dq) {
  int exponent = 0;
  const int pow2 = frexpf(scale, &exponent) == 0.5f;
  const int n_ch = (d + 63) / 64;
  for (int kv = 1; kv >= 0; --kv)
    for (int i = 0; i < 6; ++i) {
      const int nu = kv ? 2 - i / 3 : 2 - i % 2, rs = kv ? 4 - i % 3 : 4 - i / 2;
      const DkvPair g{kv, nu, rs, pow2};
      if (dkv_pair_smem(n_ch, g, dq).total <= kMaxSmem) return g;
    }
  return DkvPair{0, 1, 2, pow2};  // flat in D: always fits
}

// store_swizzled's layout at the 32-bit shared address `tile` (an opaque
// one: the eight swizzled offsets are recomputed where used), and its
// inverse: the A operand read back by the thread of the same index in the
// other warpgroup (the layout depends on that index only)
__device__ __forceinline__ uint32_t swizzled_word(uint32_t tile, int c, int i, int r_lo, int t4) {
  const int row = r_lo + 8 * (i & 1), chunk = 2 * c + (i >> 1);
  return tile + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t4;
}

__device__ __forceinline__ void store_swizzled_u32(uint32_t tile, const uint32_t (&a)[4][4],
                                                   int r_lo, int t4) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(swizzled_word(tile, c, i, r_lo, t4)),
                   "r"(a[c][i]) : "memory");
  }
}

__device__ __forceinline__ void load_swizzled_u32(uint32_t tile, uint32_t (&a)[4][4], int r_lo,
                                                  int t4) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[c][i])
                   : "r"(swizzled_word(tile, c, i, r_lo, t4)) : "memory");
  }
}

// what a consumer warpgroup of dkv_pair_wgmma_kernel reads: shared memory
// (its own ring and barriers), the CTA's tile and the sweep's shape
struct DkvPairCtx {
  bf16 *kres, *vres, *ksl, *ring, *ds_tile;
  uint8_t* ubase;
  uint64_t *full, *empty, *uq_full, *udo_full, *u_empty, *kvbar;
  float *xp, *kbias_s;
  int n_ch, ch0, pc, start, slot_ch, k0, kt, n_kt, b, n_tiles;
  size_t bh;
};

// One consumer warpgroup of dkv_pair_wgmma_kernel, its role (W) fixed at
// compile time, so that each role's loop holds only its own values
template <int W, bool DROP, bool DQ>
__device__ __forceinline__ void dkv_pair_consumer(const BwdParams& p, const DkvPair& g,
                                                  const DkvPairCtx& C) {
  bf16* kres = C.kres;
  bf16* vres = C.vres;
  bf16* ksl = C.ksl;
  uint8_t* ubase = C.ubase;
  bf16* ring = C.ring;
  uint64_t* full = C.full;
  uint64_t* empty = C.empty;
  bf16* ds_tile = C.ds_tile;
  float* xp = C.xp;
  float* kbias_s = C.kbias_s;
  uint64_t* uq_full = C.uq_full;
  uint64_t* udo_full = C.udo_full;
  uint64_t* u_empty = C.u_empty;
  uint64_t* kvbar = C.kvbar;
  const int n_ch = C.n_ch, ch0 = C.ch0, pc = C.pc, start = C.start, slot_ch = C.slot_ch;
  const int k0 = C.k0, kt = C.kt, n_kt = C.n_kt, b = C.b, h = blockIdx.y, n_tiles = C.n_tiles;
  const size_t bh = C.bh;
  // keys kl_lo and kl_lo + 8 of the tile per thread
  constexpr int w = W;
  const int ltid = threadIdx.x & (kConsumers - 1);
  const int lane = ltid & 31;
  const int t4 = lane & 3;
  const int kl_lo = (ltid >> 5) * 16 + (lane >> 2);
  const int cw = ch0 + 2 * w;                   // the warpgroup's first chunk
  const int sl_ch = max(0, min(2, n_ch - cw));  // its chunks that hold columns
  const float inv_keep = p.inv_keep;
  // chunk c of the sweep comes through this warpgroup's ring (the producer's
  // rule): streamed k or v, a chunk outside the pair, or warpgroup 0's
  // rounded copy of a pair chunk
  const auto uses_slot = [&](int c) {
    return !g.kv_res || c < ch0 || c >= ch0 + pc || (w == 0 && !g.pow2);
  };
  if (w == 0) {
    // the keys' bias (-1e9 masked, -inf past Tk), read where it is used
    if (ltid < kTile) {
      const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
      const int key = k0 + ltid;
      kbias_s[ltid] = key >= p.Tk ? neg_inf() : (mask != nullptr && mask[key] ? kMaskValue : 0.f);
    }
    named_sync(1, kConsumers);
  }
  if (g.kv_res || DQ) mbar_wait(kvbar, 0);

  float dk[64], dv[64];  // the slice's 128 columns
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  int n = 0;  // ring slots consumed so far
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    const int u = t % g.nu;
    const uint32_t upar = (t / g.nu) & 1;
    bf16* uq = opaque(reinterpret_cast<bf16*>(ubase + u * kUBytes));
    bf16* udo = uq + 4 * kChunk;
    const float* ulse = reinterpret_cast<const float*>(udo + 4 * kChunk);
    const float* udelta = ulse + kTile;
    const uint32_t* ubits = reinterpret_cast<const uint32_t*>(udelta + kTile);
    const bf16* res = w == 0 ? kres : vres;
    const bf16* ubuf = w == 0 ? uq : udo;

    // S^T (warpgroup 0) or dP^T (1) over the head dim's chunks, issued back
    // to back (warpgroup 0 rounds each q chunk first unless pow2) and waited
    // for once
    float sacc[32];
    int rel = n;  // the first ring slot not yet released
    bool u_ready = false;
    for (int i = 0; i < n_ch; ++i) {
      const int c = (start + i) % n_ch;
      const bool in_pair = c >= ch0 && c < ch0 + pc;
      if (in_pair && !u_ready) {  // before the pair's slots: the producer fills them after it
        mbar_wait(w == 0 ? &uq_full[u] : &udo_full[u], upar);
        u_ready = true;
      }
      bf16* slot = nullptr;
      if (uses_slot(c)) {
        const int s = n % g.rs;
        slot = ring + s * slot_ch * kChunk;
        mbar_wait(&full[s], (n / g.rs) & 1);
        ++n;
      }
      const bf16* a_op = g.kv_res ? res + c * kChunk : slot;
      const bf16* b_op = in_pair ? ubuf + (c - ch0) * kChunk : slot + (slot_ch - 1) * kChunk;
      if (w == 0 && !g.pow2) {  // round(q * scale) into the slot (in place for a streamed chunk)
        bf16* qs = slot + (slot_ch - 1) * kChunk;
        scale_tile<1>(qs, b_op, p.scale, ltid);
        fence_proxy_async();
        named_sync(1, kConsumers);
        b_op = qs;
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(sacc, kmajor_desc(a_op, kk), kmajor_desc(b_op, kk), i == 0 && kk == 0);
      wg_commit();
      // a ring smaller than the tile's chunks: release each slot once its
      // products are done, rs - 1 chunks still in flight
      if (i >= g.rs - 1 && uses_slot((start + i - (g.rs - 1)) % n_ch)) {
        if (g.rs == 4) {
          wg_wait<3>();
        } else if (g.rs == 3) {
          wg_wait<2>();
        } else {
          wg_wait<1>();
        }
        mbar_arrive(&empty[rel++ % g.rs]);
      }
    }
    wg_wait_all();
    fence_regs(sacc);
    for (; rel < n; ++rel) mbar_arrive(&empty[rel % g.rs]);

    uint32_t pa[4][4], dsa[4][4];
    uint32_t keep_word = 0u;  // this thread's 32 keep bits of the tile (gather_keep)
    if (w == 0) {
      // P^T = exp(S^T + key bias - lse) (a fully masked row: lse = -1e9 =
      // S + bias, P = 1) to warpgroup 1, then the dropped P^T's A operand
      const float kb0 = ld_shared_f1(kbias_s + kl_lo), kb1 = ld_shared_f1(kbias_s + kl_lo + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lse2 = ld_shared_f2(ulse + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = g.pow2 ? sacc[4 * j + e] * p.scale : sacc[4 * j + e];
          const float pj = exp_approx(sv + ((e >> 1) ? kb1 : kb0) - ((e & 1) ? lse2.y : lse2.x));
          sacc[4 * j + e] = pj;
          xp[(4 * j + e) * kConsumers + ltid] = pj;
        }
      }
      named_arrive(2, 2 * kConsumers);
      mbar_wait(&udo_full[u], upar);  // dO (and K4's keep bits)
      if constexpr (DROP) keep_word = gather_keep(ubits, kl_lo, t4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pd[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = 2 * c + (k >> 2), e = k & 3;
          pd[k] = sacc[8 * c + k];
          if constexpr (DROP)  // 1 / (1 - rate) where kept, else 0
            pd[k] *= __uint2float_rn((keep_word >> (2 * (2 * j + (e & 1)) + (e >> 1))) & 1u) *
                     inv_keep;
        }
        pa[c][0] = pack_bf16(pd[0], pd[1]);
        pa[c][1] = pack_bf16(pd[2], pd[3]);
        pa[c][2] = pack_bf16(pd[4], pd[5]);
        pa[c][3] = pack_bf16(pd[6], pd[7]);
      }
      named_sync(3, 2 * kConsumers);  // dS^T is in its tile
      load_swizzled_u32(opaque_u32(ds_tile), dsa, kl_lo, t4);
      mbar_wait(&uq_full[u], upar);
    } else {
      // dS^T = P^T (dP^T dropped - delta) and the dropped P^T, packed to bf16
      // A operands 16 query rows at a time, so that dP^T dies as it goes
      if constexpr (DROP) keep_word = gather_keep(ubits, kl_lo, t4);
      named_sync(2, 2 * kConsumers);  // P^T is in xp
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pd[8], ds[8];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * c + jj;
          const float2 delta2 = ld_shared_f2(udelta + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pj = ld_shared_f1(xp + (4 * j + e) * kConsumers + ltid);
            float pdj = pj, dpj = sacc[4 * j + e];
            if constexpr (DROP) {  // 1 / (1 - rate) where kept, else 0
              const float m =
                  __uint2float_rn((keep_word >> (2 * (2 * j + (e & 1)) + (e >> 1))) & 1u) * inv_keep;
              pdj *= m;
              dpj *= m;
            }
            pd[4 * jj + e] = pdj;
            ds[4 * jj + e] = pj * (dpj - ((e & 1) ? delta2.y : delta2.x));
          }
        }
        // the dropped P^T's A operand waits in this thread's words of the
        // exchange, already read (word 4c + i after elements 8c .. 8c + 7),
        // so that it holds no registers while dS^T forms
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(smem_u32(xp + (4 * c + i) * kConsumers + ltid)),
                       "r"(pack_bf16(pd[2 * i], pd[2 * i + 1])) : "memory");
        dsa[c][0] = pack_bf16(ds[0], ds[1]);
        dsa[c][1] = pack_bf16(ds[2], ds[3]);
        dsa[c][2] = pack_bf16(ds[4], ds[5]);
        dsa[c][3] = pack_bf16(ds[6], ds[7]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(pa[c][i])
                       : "r"(smem_u32(xp + (4 * c + i) * kConsumers + ltid)) : "memory");
      }
      store_swizzled_u32(opaque_u32(ds_tile), dsa, kl_lo, t4);
      fence_proxy_async();  // K2's dq products read the tile
      named_arrive(3, 2 * kConsumers);
      if constexpr (DQ) named_sync(4, kConsumers);  // every thread's dS^T is in place
      mbar_wait(&uq_full[u], upar);
    }

    // the slice's dv += P^T dO and dk += dS^T q, B read MN-major from the buffer
    wg_fence();
    fence_regs(dv);
    fence_regs(dk);
    if (sl_ch > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        wgmma_rs<2>(dv, pa[c], udo + 2 * w * kChunk, c);
        wgmma_rs<2>(dk, dsa[c], uq + 2 * w * kChunk, c);
      }
    }
    wg_commit();
    if constexpr (DQ) {
      wg_wait_all();  // P^T's and dS^T's registers free before dq's take theirs
      fence_regs(dv);
      fence_regs(dk);
      // this tile's share of dq's slice columns: round(dS) K over the CTA's
      // 64 keys, dS^T read MN-major as the A operand and K's slice chunks
      // MN-major as B, one 64-column half at a time, into the scratch
      // (B, H, nk, Tq, D) that dq_reduce_kernel adds up
      const bf16* kslice = opaque(g.kv_res ? kres + cw * kChunk : ksl + 2 * w * kChunk);
      const uint32_t dst = opaque_u32(ds_tile);
      // the thread's two rows of the share, from the slice's first column
      float* rows[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rows[r] = p.dq_part + ((bh * n_kt + kt) * p.Tq + q0 + kl_lo + 8 * r) * p.D + 64 * cw +
                  2 * t4;
#pragma unroll 1
      for (int hh = 0; hh < sl_ch; ++hh) {
        float dq[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64_tt(dq, sw128_desc_u32(dst + kk * 16 * 64 * 2, kChunk * 2, 1024),
                          mnmajor_desc(kslice + hh * kChunk, kk), kk == 0);
        wg_commit();
        wg_wait_all();
        fence_regs(dq);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (q0 + kl_lo + 8 * r >= p.Tq) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 64 * (cw + hh) + 8 * j + 2 * t4;
            if (c >= p.D) continue;
            float* out = rows[r] + 64 * hh + 8 * j;
            const float x = dq[4 * j + 2 * r] * p.scale, y = dq[4 * j + 2 * r + 1] * p.scale;
            if (p.D % 2 == 0) {
              *reinterpret_cast<float2*>(out) = make_float2(x, y);
            } else {
              out[0] = x;
              if (c + 1 < p.D) out[1] = y;
            }
          }
        }
      }
    }
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&u_empty[u]);
  }

  if (sl_ch > 0) {
    bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh + 64 * cw;
    bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh + 64 * cw;
    store_rows<2>(dkp, p.dk_st, k0, p.Tk, p.D - 64 * cw, dk, p.scale, ltid);
    store_rows<2>(dvp, p.dv_st, k0, p.Tk, p.D - 64 * cw, dv, 1.f, ltid);
  }}

// The producer warp loads the CTA's k and v once (kv_res; K2 otherwise its
// pair's k chunks), then per q tile the ring slots of the head dim's chunks
// in the consumers' order (from the chunk after the pair, wrapping to the
// pair's last) and a buffer of the pair's q and dO chunks with the rows' lse
// (+inf past Tq: P = 0) and delta, and for K4 K3's keep bits of the tile.
// Warpgroup 0 computes S^T = K round(q * scale)^T, warpgroup 1 dP^T = V dO^T,
// over the whole head dim, each issuing its chunk products back to back and
// waiting once. Warpgroup 0 hands P^T (float32) to warpgroup 1 (named
// barrier 2), which forms dS^T, keeps its bf16 A operand in a swizzled tile
// and hands it back (barrier 3); both drop P^T with the same keep bits. Then
// each updates its slice's dv += P^T dO and dk += dS^T q from the buffer, and
// for K2 adds dS K over the slice to the dq scratch from the dS^T tile. The
// keep bits come with each q tile's buffer, one bulk copy from the buffer K3
// fills for K4 (keep_bits_kernel fills it for K2).
// Barriers 1 and 4 are warpgroup 0's and 1's own. Every exchange buffer is
// single: each side passes the other's barrier of the next tile only after
// it is done with this tile's.
template <bool DROP, bool DQ>
__global__ void __launch_bounds__(kPairThreads, 1) dkv_pair_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p, const DkvPair g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const int tid = threadIdx.x;
  const int n_ch = (p.D + 63) / 64;
  const DkvPairSmem L = dkv_pair_smem(n_ch, g, DQ);
  bf16* kres = reinterpret_cast<bf16*>(base + L.kres);
  bf16* vres = reinterpret_cast<bf16*>(base + L.vres);
  bf16* ksl = reinterpret_cast<bf16*>(base + L.ksl);
  uint8_t* ubase = base + L.u;
  bf16* ring0 = reinterpret_cast<bf16*>(base + L.ring0);
  bf16* ring1 = reinterpret_cast<bf16*>(base + L.ring1);
  bf16* ds_tile = reinterpret_cast<bf16*>(base + L.ds);  // round(dS)^T, keys x query rows
  float* xp = reinterpret_cast<float*>(base + L.xp);     // P^T: element e of thread i at e 128 + i
  float* kbias_s = reinterpret_cast<float*>(base + L.kbias);
  uint64_t* uq_full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* udo_full = uq_full + g.nu;
  uint64_t* u_empty = udo_full + g.nu;
  uint64_t* r0full = u_empty + g.nu;
  uint64_t* r0empty = r0full + g.rs;
  uint64_t* r1full = r0empty + g.rs;
  uint64_t* r1empty = r1full + g.rs;
  uint64_t* kvbar = r1empty + g.rs;

  const int n_pairs = (n_ch + 3) / 4;
  const int pr = blockIdx.x % n_pairs;
  const int kt = blockIdx.x / n_pairs, n_kt = (p.Tk + kTile - 1) / kTile;
  const int k0 = kt * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ch0 = 4 * pr, pc = min(4, n_ch - ch0);  // the pair's chunks
  const int start = (ch0 + pc) % n_ch;               // the sweep's first chunk
  const int slot_ch = g.kv_res ? 1 : 2;              // chunks of a ring slot: [k or v,] q or dO
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;
  if (tid == 0) {
    for (int i = 0; i < g.nu; ++i) {
      mbar_init(&uq_full[i], 32);
      mbar_init(&udo_full[i], 32);
      mbar_init(&u_empty[i], 2 * kConsumers);
    }
    for (int i = 0; i < g.rs; ++i) {
      mbar_init(&r0full[i], 1);
      mbar_init(&r0empty[i], kConsumers);
      mbar_init(&r1full[i], 1);
      mbar_init(&r1empty[i], kConsumers);
    }
    mbar_init(kvbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 2 * kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (tid >= 2 * kConsumers + 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      if (g.kv_res) {
        mbar_arrive_tx(kvbar, 2 * n_ch * kPairChunkBytes);
        for (int c = 0; c < n_ch; ++c) {
          tma_load(kres + c * kChunk, &tm_k, kvbar, 64 * c, k0, h, b);
          tma_load(vres + c * kChunk, &tm_v, kvbar, 64 * c, k0, h, b);
        }
      } else if (DQ) {
        mbar_arrive_tx(kvbar, pc * kPairChunkBytes);
        for (int i = 0; i < pc; ++i) tma_load(ksl + i * kChunk, &tm_k, kvbar, 64 * (ch0 + i), k0, h, b);
      }
    }
    int n0 = 0, n1 = 0;  // ring slots filled so far
    // ring slots of sweep positions [i0, i1) of q tile t (chunks in the
    // consumers' order)
    const auto fill_slots = [&](int t, int i0, int i1) {
      const int q0 = t * kTile;
      for (int i = i0; i < i1; ++i) {
        const int c = (start + i) % n_ch;
        const bool in_pair = c >= ch0 && c < ch0 + pc;
        if (!g.kv_res || !in_pair || !g.pow2) {  // warpgroup 0's slot: k chunk, q chunk
          const int s = n0 % g.rs;
          if (n0 >= g.rs) mbar_wait(&r0empty[s], ((n0 / g.rs) - 1) & 1);
          bf16* slot = ring0 + s * slot_ch * kChunk;
          const uint32_t bytes = ((g.kv_res ? 0 : 1) + (in_pair ? 0 : 1)) * kPairChunkBytes;
          if (bytes) {
            mbar_arrive_tx(&r0full[s], bytes);
            if (!g.kv_res) tma_load(slot, &tm_k, &r0full[s], 64 * c, k0, h, b);
            if (!in_pair) tma_load(slot + (slot_ch - 1) * kChunk, &tm_q, &r0full[s], 64 * c, q0, h, b);
          } else {
            mbar_arrive(&r0full[s]);  // a slot for the rounded copy of the pair's q chunk
          }
          ++n0;
        }
        if (!g.kv_res || !in_pair) {  // warpgroup 1's slot: v chunk, dO chunk
          const int s = n1 % g.rs;
          if (n1 >= g.rs) mbar_wait(&r1empty[s], ((n1 / g.rs) - 1) & 1);
          bf16* slot = ring1 + s * slot_ch * kChunk;
          mbar_arrive_tx(&r1full[s], ((g.kv_res ? 0 : 1) + (in_pair ? 0 : 1)) * kPairChunkBytes);
          if (!g.kv_res) tma_load(slot, &tm_v, &r1full[s], 64 * c, k0, h, b);
          if (!in_pair) tma_load(slot + (slot_ch - 1) * kChunk, &tm_do, &r1full[s], 64 * c, q0, h, b);
          ++n1;
        }
      }
    };
    // per q tile: the slots of the chunks outside the pair (they run first
    // and prefetch while the previous tile's updates hold the buffer), the
    // buffer, then the slots of the pair's chunks
    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = t * kTile;
      if (lane == 0) fill_slots(t, 0, n_ch - pc);
      __syncwarp();
      const int u = t % g.nu;
      if (t >= g.nu) mbar_wait(&u_empty[u], ((t / g.nu) - 1) & 1);
      bf16* uq = reinterpret_cast<bf16*>(ubase + u * kUBytes);
      bf16* udo = uq + 4 * kChunk;
      float* ulse = reinterpret_cast<float*>(udo + 4 * kChunk);
      float* udelta = ulse + kTile;
      uint32_t* ubits = reinterpret_cast<uint32_t*>(udelta + kTile);
      if (lane == 0) {  // the copies first, so they fly while the rows' data loads
        mbar_expect_tx(&uq_full[u], pc * kPairChunkBytes);
        for (int i = 0; i < pc; ++i)
          tma_load(uq + i * kChunk, &tm_q, &uq_full[u], 64 * (ch0 + i), q0, h, b);
        mbar_expect_tx(&udo_full[u], pc * kPairChunkBytes + (DROP ? kBitsBytes : 0));
        for (int i = 0; i < pc; ++i)
          tma_load(udo + i * kChunk, &tm_do, &udo_full[u], 64 * (ch0 + i), q0, h, b);
        if constexpr (DROP)  // the keep bits of this (key tile, q tile): 512 bytes
          bulk_load(ubits, p.keep_bits + ((bh * n_kt + kt) * p.tq_pad + q0) * 2, kBitsBytes,
                    &udo_full[u]);
      }
      for (int r = lane; r < kTile; r += 32) {
        const bool in = q0 + r < p.Tq;
        ulse[r] = in ? p.lse[bh * p.Tq + q0 + r] : pos_inf();
        udelta[r] = in ? p.delta[bh * p.Tq + q0 + r] : 0.f;
      }
      mbar_arrive(&uq_full[u]);  // each lane after its own writes
      mbar_arrive(&udo_full[u]);
      if (lane == 0) fill_slots(t, n_ch - pc, n_ch);
      __syncwarp();
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const bool w0 = tid < kConsumers;
  const DkvPairCtx C{kres, vres, ksl, w0 ? ring0 : ring1, ds_tile, ubase,
                     w0 ? r0full : r1full, w0 ? r0empty : r1empty, uq_full, udo_full, u_empty,
                     kvbar, xp, kbias_s, n_ch, ch0, pc, start, slot_ch, k0, kt, n_kt, b, n_tiles,
                     bh};
  if (w0) {
    dkv_pair_consumer<0, DROP, DQ>(p, g, C);
  } else {
    dkv_pair_consumer<1, DROP, DQ>(p, g, C);
  }
}

// ---------------------------------------------------------------------------
// K3 (bf16) above head dim 128: one CTA per (64-row q tile, pair of
// 128-column dq slices, head, batch row). S and dP run once per key tile
// for the pair, one on each consumer warpgroup; each warpgroup accumulates
// its slice of dq.
// ---------------------------------------------------------------------------

// How a CTA holds its operands, chosen per head dim (dq_pair_config): q
// (rounded once) and dO resident for the whole key sweep, or streamed with
// each key tile where shared memory forbids; one or two buffers of a key
// tile's pair k chunks and the keys' bias; the slots of each warpgroup's
// ring (warpgroup 0: the k chunks outside the pair, and q where it streams;
// warpgroup 1: every v chunk, and dO where it streams).
struct DqPair {
  int res, nkp, rs;
};

// byte offsets from the 1024-aligned base; `total` counts the alignment slack
struct DqPairSmem {
  int q, dout, kp, ring0, ring1, xp, kbias, bits, bars, total;
};

// warpgroup 0's ring has no slot when q is resident and every chunk is the
// pair's
__host__ __device__ inline int dq_pair_r0(int n_ch, const DqPair& g) {
  return g.res && n_ch <= 4 ? 0 : g.rs;
}

__host__ __device__ inline DqPairSmem dq_pair_smem(int n_ch, const DqPair& g) {
  const int chunk = (int)kPairChunkBytes;
  const int slot = (g.res ? 1 : 2) * chunk;
  DqPairSmem s;
  s.q = 0;
  s.dout = s.q + (g.res ? n_ch * chunk : 0);
  s.kp = s.dout + (g.res ? n_ch * chunk : 0);
  s.ring0 = s.kp + g.nkp * 4 * chunk;
  s.ring1 = s.ring0 + dq_pair_r0(n_ch, g) * slot;
  s.xp = s.ring1 + g.rs * slot;
  s.kbias = s.xp + 32 * kConsumers * (int)sizeof(float);
  s.bits = s.kbias + g.nkp * kTile * (int)sizeof(float);
  s.bars = s.bits + 2 * 2 * kTile * (int)sizeof(uint32_t);
  s.total = 1024 + s.bars +
            (1 + 2 * dq_pair_r0(n_ch, g) + 2 * g.rs + 2 * g.nkp) * (int)sizeof(uint64_t);
  return s;
}

// resident q and dO first; then rings of at least three slots (two chunks'
// products in flight while the third loads), two k-pair buffers (the next
// tile's loading while this tile's are in use) before one, the deepest
// ring that fits
inline DqPair dq_pair_config(int d) {
  const int n_ch = (d + 63) / 64;
  for (int res = 1; res >= 0; --res)
    for (int lo = 3; lo >= 2; --lo)
      for (int nkp = 2; nkp >= 1; --nkp)
        for (int rs = 6; rs >= lo; --rs) {
          const DqPair g{res, nkp, rs};
          if (dq_pair_smem(n_ch, g).total <= kMaxSmem) return g;
        }
  return DqPair{0, 1, 2};  // flat in D: always fits
}

// the register split of dq_pair_wgmma_kernel's pool (384 x 168): its two
// producer warps' loops need 40 (at 24 they spilled 48-64 bytes), which
// leaves the consumers 232
constexpr int kDqProducerRegs = 40, kDqConsumerRegs = 232;

// wait until at most n (< 6) committed wgmma groups are pending
__device__ __forceinline__ void wg_wait_upto(int n) {
  switch (n) {
    case 0: wg_wait<0>(); break;
    case 1: wg_wait<1>(); break;
    case 2: wg_wait<2>(); break;
    case 3: wg_wait<3>(); break;
    case 4: wg_wait<4>(); break;
    default: wg_wait<5>(); break;
  }
}

// what a consumer warpgroup of dq_pair_wgmma_kernel reads: shared memory
// (its resident operand, its own ring and barriers) and the CTA's tile
struct DqPairCtx {
  bf16 *res, *kp, *ring;
  float *xp, *kbias;
  uint32_t* bits;
  uint64_t *full, *empty, *kp_full, *kp_empty, *qbar;
  int n_ch, ch0, pc, start, rs, q0, pr, b;
  size_t bh;
};

// One consumer warpgroup of dq_pair_wgmma_kernel, its role (W) fixed at
// compile time, so that each role's loop holds only its own values.
// Warpgroup 0 computes S = round(q * scale) K^T and P = exp(S + bias - lse)
// into the exchange xp (element e of thread i at e 128 + i); warpgroup 1
// computes dP = dO V^T, draws the tile's keep bits, reads P back (the
// element its namesake in warpgroup 0 holds: the accumulator layout depends
// on the thread's index in its warpgroup only), forms dS = P (dP dropped -
// delta) and leaves dS's bf16 A operand in the words of xp it has read,
// where warpgroup 0 picks it up. Then each adds dS K over its slice's k
// columns, which are the tile's pair chunks.
template <int W, bool DROP>
__device__ __forceinline__ void dq_pair_consumer(const BwdParams& p, const DqPair& g,
                                                 const DqPairCtx& C) {
  const int n_ch = C.n_ch, ch0 = C.ch0, pc = C.pc, start = C.start, rs = C.rs, q0 = C.q0;
  const int b = C.b, h = blockIdx.y;
  const size_t bh = C.bh;
  const int n_tiles = (p.Tk + kTile - 1) / kTile;
  const int slot_ch = g.res ? 1 : 2;  // chunks of a ring slot: [q or dO,] k or v
  // rows r_lo and r_lo + 8 of the tile per thread
  const int ltid = threadIdx.x & (kConsumers - 1);
  const int lane = ltid & 31;
  const int t4 = lane & 3;
  const int r_lo = (ltid >> 5) * 16 + (lane >> 2);
  const int cw = ch0 + 2 * W;                   // the warpgroup's first chunk of dq
  const int sl_ch = max(0, min(2, n_ch - cw));  // its chunks that hold columns
  // the rows' lse (warpgroup 0) or delta (1); 0 past Tq
  float row_v[2];
  bool row_in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_lo + 8 * r;
    row_in[r] = row < p.Tq;
    row_v[r] = row_in[r] ? (W == 0 ? p.lse : p.delta)[bh * p.Tq + row] : 0.f;
  }
  // chunk c of the sweep comes through this warpgroup's ring (the
  // producers' rule): every v chunk; a k chunk outside the pair, or a
  // streamed q chunk
  const auto uses_slot = [&](int c) {
    return W == 1 || !g.res || c < ch0 || c >= ch0 + pc;
  };
  if (g.res) {
    mbar_wait(C.qbar, 0);
    if (W == 0) {  // round(q * scale) once for the whole sweep
      for (int c = 0; c < n_ch; ++c) scale_tile<1>(C.res + c * kChunk, C.res + c * kChunk, p.scale, ltid);
      fence_proxy_async();
      named_sync(1, kConsumers);
    }
  }

  float acc[64];  // the slice's 128 columns
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int n = 0;  // ring slots consumed so far
  for (int t = 0; t < n_tiles; ++t) {
    const int u = t % g.nkp;
    const uint32_t upar = (t / g.nkp) & 1;
    const bf16* kpu = opaque(C.kp + u * 4 * kChunk);

    // S (warpgroup 0) or dP (1) over the head dim's chunks, from the chunk
    // after the pair on (wrapping to the pair's last), issued back to back
    // (a streamed q chunk rounded in its slot first) and waited for once; a
    // ring smaller than the tile's chunks releases each slot once its
    // products are done, rs - 1 chunks still in flight
    float sacc[32];
    int rel = n;  // the first ring slot not yet released
    bool kp_ready = false;
    for (int i = 0; i < n_ch; ++i) {
      const int c = (start + i) % n_ch;
      const bool in_pair = c >= ch0 && c < ch0 + pc;
      if (W == 0 && in_pair && !kp_ready) {
        mbar_wait(&C.kp_full[u], upar);
        kp_ready = true;
      }
      bf16* slot = nullptr;
      if (uses_slot(c)) {
        const int s = n % rs;
        slot = C.ring + s * slot_ch * kChunk;
        mbar_wait(&C.full[s], (n / rs) & 1);
        ++n;
      }
      const bf16* a_op = g.res ? C.res + c * kChunk : slot;
      if (W == 0 && !g.res) {
        scale_tile<1>(slot, slot, p.scale, ltid);
        fence_proxy_async();
        named_sync(1, kConsumers);
      }
      const bf16* b_op =
          W == 0 && in_pair ? kpu + (c - ch0) * kChunk : slot + (slot_ch - 1) * kChunk;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(sacc, kmajor_desc(a_op, kk), kmajor_desc(b_op, kk), i == 0 && kk == 0);
      wg_commit();
      if (rs > 0 && i >= rs - 1 && uses_slot((start + i - (rs - 1)) % n_ch)) {
        wg_wait_upto(rs - 1);
        mbar_arrive(&C.empty[rel++ % rs]);
      }
    }
    // the keep bits of this tile while dP's last products run, double-
    // buffered: one barrier per tile orders the fill against every reader;
    // pair 0's CTA stores them for K4, each thread its own word
    uint32_t* tb = C.bits + (t & 1) * 2 * kTile;
    if constexpr (W == 1 && DROP) {
      fill_keep_bits(tb, kTile, p.row0 + q0, p.col0 + t * kTile, (uint32_t)p.seed[bh],
                     p.threshold, ltid, kConsumers);
      if (C.pr == 0) p.keep_bits[((bh * n_tiles + t) * p.tq_pad + q0) * 2 + ltid] = tb[ltid];
      named_sync(4, kConsumers);
    }
    wg_wait_all();
    fence_regs(sacc);
    for (; rel < n; ++rel) mbar_arrive(&C.empty[rel % rs]);

    uint32_t dsa[4][4];  // round(dS) as the A operand of dq += dS K
    if constexpr (W == 0) {
      // P = exp(S + key bias - lse) (a fully masked row: lse = -1e9 = S +
      // bias, P = 1) to warpgroup 1, then dS's A operand back
      const float* kb = C.kbias + u * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias2 = ld_shared_f2(kb + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pj =
              exp_approx(sacc[4 * j + e] + ((e & 1) ? bias2.y : bias2.x) - row_v[e >> 1]);
          C.xp[(4 * j + e) * kConsumers + ltid] = pj;
        }
      }
      named_arrive(2, 2 * kConsumers);
      named_sync(3, 2 * kConsumers);  // dS is in xp
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(dsa[c][i])
                       : "r"(smem_u32(C.xp + (4 * c + i) * kConsumers + ltid)) : "memory");
      }
    } else {
      // dS = P (dP dropped - delta), zero past Tq, packed to bf16 16
      // columns at a time; word 4c + i of the A operand goes where P's
      // elements 8c .. 8c + 7 were, already read
      named_sync(2, 2 * kConsumers);  // P is in xp
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float ds[8];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * c + jj;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float pj = ld_shared_f1(C.xp + (4 * j + e) * kConsumers + ltid);
            float dpj = sacc[4 * j + e];
            if constexpr (DROP) dpj *= keep_scale(tb, r_lo + 8 * r, 8 * j + 2 * t4 + (e & 1), p.inv_keep);
            ds[4 * jj + e] = row_in[r] ? pj * (dpj - row_v[r]) : 0.f;
          }
        }
        dsa[c][0] = pack_bf16(ds[0], ds[1]);
        dsa[c][1] = pack_bf16(ds[2], ds[3]);
        dsa[c][2] = pack_bf16(ds[4], ds[5]);
        dsa[c][3] = pack_bf16(ds[6], ds[7]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(smem_u32(C.xp + (4 * c + i) * kConsumers + ltid)),
                       "r"(dsa[c][i]) : "memory");
      }
      named_arrive(3, 2 * kConsumers);
      mbar_wait(&C.kp_full[u], upar);
    }

    // the slice's dq += round(dS) K, B the pair buffer's chunks read MN-major
    wg_fence();
    fence_regs(acc);
    if (sl_ch > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_rs<2>(acc, dsa[c], kpu + 2 * W * kChunk, c);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(&C.kp_empty[u]);
  }

  if (sl_ch > 0) {
    bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh + 64 * cw;
    store_rows<2>(dq, p.dq_st, q0, p.Tq, p.D - 64 * cw, acc, p.scale, ltid);
  }
}

// Producer warp 0 loads q and dO once where they stay resident, then per
// key tile warpgroup 0's ring slots in its order (from the chunk after the
// pair on, wrapping to the pair's last) with the buffer of the pair's k
// chunks and the keys' bias (-1e9 masked, -inf past Tk) before the pair's
// own; producer warp 1 fills warpgroup 1's ring, every chunk's v (and dO).
// Barriers 1 and 4 are warpgroup 0's and 1's own, 2 hands P over, 3 dS
// back. The exchange is single: each side passes the other's barrier of the
// next tile only after it is done with this tile's. Only pair 0's CTA
// stores the keep bits, in the layout K4 reads.
template <bool DROP>
__global__ void __launch_bounds__(kPairThreads, 1) dq_pair_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p, const DqPair g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const int tid = threadIdx.x;
  const int n_ch = (p.D + 63) / 64;
  const DqPairSmem L = dq_pair_smem(n_ch, g);
  const int r0 = dq_pair_r0(n_ch, g);
  bf16* qres = reinterpret_cast<bf16*>(base + L.q);     // round(q * scale), resident
  bf16* dores = reinterpret_cast<bf16*>(base + L.dout);  // dO, resident
  bf16* kp = reinterpret_cast<bf16*>(base + L.kp);      // nkp x the pair's 4 k chunks
  bf16* ring0 = reinterpret_cast<bf16*>(base + L.ring0);
  bf16* ring1 = reinterpret_cast<bf16*>(base + L.ring1);
  float* xp = reinterpret_cast<float*>(base + L.xp);     // P, then dS's A operand
  float* kbias = reinterpret_cast<float*>(base + L.kbias);  // nkp x 64
  uint32_t* bits = reinterpret_cast<uint32_t*>(base + L.bits);  // 2 x 128 words
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* full0 = qbar + 1;
  uint64_t* empty0 = full0 + r0;
  uint64_t* full1 = empty0 + r0;
  uint64_t* empty1 = full1 + g.rs;
  uint64_t* kp_full = empty1 + g.rs;
  uint64_t* kp_empty = kp_full + g.nkp;

  const int n_pairs = (n_ch + 3) / 4;
  const int pr = blockIdx.x % n_pairs;
  const int q0 = (blockIdx.x / n_pairs) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ch0 = 4 * pr, pc = min(4, n_ch - ch0);  // the pair's chunks
  const int start = (ch0 + pc) % n_ch;               // the sweep's first chunk
  const int slot_ch = g.res ? 1 : 2;
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tk + kTile - 1) / kTile;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < r0; ++i) {
      mbar_init(&full0[i], 1);
      mbar_init(&empty0[i], kConsumers);
    }
    for (int i = 0; i < g.rs; ++i) {
      mbar_init(&full1[i], 1);
      mbar_init(&empty1[i], kConsumers);
    }
    for (int i = 0; i < g.nkp; ++i) {
      mbar_init(&kp_full[i], 32);
      mbar_init(&kp_empty[i], 2 * kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 2 * kConsumers) {
    reg_dealloc<kDqProducerRegs>();
    if (tid >= 2 * kConsumers + 64) return;
    const int lane = tid & 31;
    if (tid >= 2 * kConsumers + 32) {  // producer warp 1: warpgroup 1's ring
      if (lane == 0) {
        int n1 = 0;
        for (int t = 0; t < n_tiles; ++t) {
          for (int i = 0; i < n_ch; ++i, ++n1) {
            const int c = (start + i) % n_ch;
            const int s = n1 % g.rs;
            if (n1 >= g.rs) mbar_wait(&empty1[s], ((n1 / g.rs) - 1) & 1);
            bf16* slot = ring1 + s * slot_ch * kChunk;
            mbar_arrive_tx(&full1[s], slot_ch * kPairChunkBytes);
            if (!g.res) tma_load(slot, &tm_do, &full1[s], 64 * c, q0, h, b);
            tma_load(slot + (slot_ch - 1) * kChunk, &tm_v, &full1[s], 64 * c, t * kTile, h, b);
          }
        }
      }
      return;
    }
    if (lane == 0 && g.res) {
      mbar_arrive_tx(qbar, 2 * n_ch * kPairChunkBytes);
      for (int c = 0; c < n_ch; ++c) {
        tma_load(qres + c * kChunk, &tm_q, qbar, 64 * c, q0, h, b);
        tma_load(dores + c * kChunk, &tm_do, qbar, 64 * c, q0, h, b);
      }
    }
    const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
    int n0 = 0;  // ring 0 slots filled so far
    // ring 0 slots of sweep positions [i0, i1) of key tile t
    const auto fill_slots = [&](int t, int i0, int i1) {
      for (int i = i0; i < i1; ++i) {
        const int c = (start + i) % n_ch;
        const bool in_pair = c >= ch0 && c < ch0 + pc;
        if (g.res && in_pair) continue;
        const int s = n0 % r0;
        if (n0 >= r0) mbar_wait(&empty0[s], ((n0 / r0) - 1) & 1);
        bf16* slot = ring0 + s * slot_ch * kChunk;
        mbar_arrive_tx(&full0[s], ((g.res ? 0 : 1) + (in_pair ? 0 : 1)) * kPairChunkBytes);
        if (!g.res) tma_load(slot, &tm_q, &full0[s], 64 * c, q0, h, b);
        if (!in_pair) tma_load(slot + (slot_ch - 1) * kChunk, &tm_k, &full0[s], 64 * c, t * kTile, h, b);
        ++n0;
      }
    };
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      if (lane == 0) fill_slots(t, 0, n_ch - pc);
      __syncwarp();
      const int u = t % g.nkp;
      if (t >= g.nkp) mbar_wait(&kp_empty[u], ((t / g.nkp) - 1) & 1);
      if (lane == 0) {  // the copies first, so they fly while the bias loads
        mbar_expect_tx(&kp_full[u], pc * kPairChunkBytes);
        for (int i = 0; i < pc; ++i)
          tma_load(kp + (u * 4 + i) * kChunk, &tm_k, &kp_full[u], 64 * (ch0 + i), k0, h, b);
      }
      for (int j = lane; j < kTile; j += 32) {
        const int key = k0 + j;
        kbias[u * kTile + j] =
            key >= p.Tk ? neg_inf() : (mask != nullptr && mask[key] ? kMaskValue : 0.f);
      }
      mbar_arrive(&kp_full[u]);  // each lane after its own writes
      if (lane == 0) fill_slots(t, n_ch - pc, n_ch);
      __syncwarp();
    }
    return;
  }

  reg_alloc<kDqConsumerRegs>();
  const bool w0 = tid < kConsumers;
  const DqPairCtx C{w0 ? qres : dores, kp, w0 ? ring0 : ring1, xp, kbias, bits,
                    w0 ? full0 : full1, w0 ? empty0 : empty1, kp_full, kp_empty, qbar,
                    n_ch, ch0, pc, start, w0 ? r0 : g.rs, q0, pr, b, bh};
  if (w0) {
    dq_pair_consumer<0, DROP>(p, g, C);
  } else {
    dq_pair_consumer<1, DROP>(p, g, C);
  }
}

// ---------------------------------------------------------------------------
// K4 and K2 in float32: three-pass TF32 on the tensor cores (tf32.cuh), one
// CTA per (64-key tile, output slice of up to 128 columns, head, batch row),
// sweeping query tiles; with DQ (K2) also each q tile's dq share of the slice
// into scratch
// ---------------------------------------------------------------------------

constexpr int kF32Slots = 3;          // ring of two-chunk slots
constexpr int kDsStride = kTile + 4;  // K2's dS rows in shared memory, padded

// SC: chunks of the output slice (1 at D <= 64, else 2)
template <int SC, bool DQ>
constexpr size_t dkv_tf32_smem_bytes() {
  return 1024 +
         sizeof(float) * ((size_t)(2 * kF32Slots + 2 + (DQ ? SC : 0)) * kFChunk +
                          2 * kTile * kDsStride + 2 * 2 * kTile + kTile) +
         sizeof(uint32_t) * 2 * 2 * kTile + sizeof(uint64_t) * (2 * kF32Slots + 1);
}

// acc {+}= one ring slot's (A chunk, B chunk) product, three TF32 passes:
// both chunks split in the slot (B times `mul_b`), the products waited for,
// the slot released; `n` counts the slots consumed
__device__ __forceinline__ void score_chunk(float (&acc)[32], float* ring, float* lo,
                                            uint64_t* full, uint64_t* empty, int& n,
                                            float mul_b, bool zero, int tid) {
  const int s = n % kF32Slots;
  float* slot = ring + s * 2 * kFChunk;
  mbar_wait(&full[s], (n / kF32Slots) & 1);
  ++n;
  split_pair(slot, lo, mul_b, tid);
  wg_fence();
  wgmma_tf32x3(acc, slot, lo, slot + kFChunk, lo + kFChunk, zero);
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  consumer_sync();  // every warp's products are done with lo
  mbar_arrive(&empty[s]);
}

template <int SC, bool DROP, bool DQ>
__global__ void __launch_bounds__(kHopThreads, 1) dkv_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(align1024(smem_raw));  // kF32Slots x 2 chunks
  float* lo = ring + kF32Slots * 2 * kFChunk;    // lo of the score slot's two chunks
  float* Ksl = lo + 2 * kFChunk;                 // DQ: the slice's k chunks, raw
  float* P_s = Ksl + (DQ ? SC : 0) * kFChunk;    // dropped P / (1 - rate), query rows x keys
  float* dS_s = P_s + kTile * kDsStride;         // dS, query rows x keys
  float* lse_buf = dS_s + kTile * kDsStride;     // 2 x 64, by tile parity
  float* delta_buf = lse_buf + 2 * kTile;                 // 2 x 64
  float* kbias_s = delta_buf + 2 * kTile;                 // the keys' bias
  uint32_t* bits = reinterpret_cast<uint32_t*>(kbias_s + kTile);  // 2 x 128 words
  uint64_t* full = reinterpret_cast<uint64_t*>(bits + 2 * 2 * kTile);
  uint64_t* empty = full + kF32Slots;
  uint64_t* kbar = empty + kF32Slots;

  const int tid = threadIdx.x;
  const int n_ch = (p.D + 63) / 64;
  const int n_sl = n_slices(p.D);
  const int sl = blockIdx.x % n_sl;
  const int kt = blockIdx.x / n_sl, n_kt = (p.Tk + kTile - 1) / kTile;
  const int k0 = kt * kTile, h = blockIdx.y, b = blockIdx.z;
  const int c0 = sl * kSlice;
  const int sl_ch = min(SC, n_ch - 2 * sl);
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < kF32Slots; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // Per q tile the producer fills n_ch slots with (k chunk c, q chunk c),
  // n_ch with (v chunk c, dO chunk c), then one with dO's and one with q's
  // chunks of the slice: at least four slots, more than the ring holds, so it
  // writes tile t + 2's lse and delta only after the consumers released a
  // slot of tile t + 1, when they are done with tile t's.
  if (tid >= kConsumers) {
    const int lane = tid - kConsumers;
    if (DQ && lane == 0) {
      mbar_arrive_tx(kbar, sl_ch * kFChunkBytes);
      for (int i = 0; i < sl_ch; ++i) tma_chunk(Ksl + i * kFChunk, &tm_k, kbar, c0 + 64 * i, k0, h, b);
    }
    int n = 0;  // slots filled so far
    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = t * kTile;
      for (int f = 0; f < 2 * n_ch + 2; ++f, ++n) {
        const int s = n % kF32Slots;
        if (n >= kF32Slots) mbar_wait(&empty[s], ((n / kF32Slots) - 1) & 1);
        if (lane == 0) {
          float* slot = ring + s * 2 * kFChunk;
          if (f < 2 * n_ch) {
            const bool dp = f >= n_ch;  // the dP^T operands
            const int c = dp ? f - n_ch : f;
            mbar_expect_tx(&full[s], 2 * kFChunkBytes);
            tma_chunk(slot, dp ? &tm_v : &tm_k, &full[s], 64 * c, k0, h, b);
            tma_chunk(slot + kFChunk, dp ? &tm_do : &tm_q, &full[s], 64 * c, q0, h, b);
          } else {
            const CUtensorMap* map = f == 2 * n_ch ? &tm_do : &tm_q;
            mbar_expect_tx(&full[s], sl_ch * kFChunkBytes);
            for (int i = 0; i < sl_ch; ++i)
              tma_chunk(slot + i * kFChunk, map, &full[s], c0 + 64 * i, q0, h, b);
          }
        }
        if (f == 0) {
          for (int r = lane; r < kTile; r += 32) {
            const bool in = q0 + r < p.Tq;
            lse_buf[(t & 1) * kTile + r] = in ? p.lse[bh * p.Tq + q0 + r] : pos_inf();  // P = 0
            delta_buf[(t & 1) * kTile + r] = in ? p.delta[bh * p.Tq + q0 + r] : 0.f;
          }
        }
        mbar_arrive(&full[s]);  // each lane after its own writes
      }
    }
    return;
  }

  // consumer warpgroup: keys kl_lo and kl_lo + 8 of the tile per thread
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kl_lo = warp * 16 + g;
  const BOffsets bo = b_offsets(lane);
  {
    const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
    if (tid < kTile) {
      const int key = k0 + tid;
      kbias_s[tid] = key >= p.Tk ? neg_inf() : (mask != nullptr && mask[key] ? kMaskValue : 0.f);
    }
    consumer_sync();
  }
  if constexpr (DQ) mbar_wait(kbar, 0);
  const uint32_t seed = DROP ? (uint32_t)p.seed[bh] : 0u;
  const float inv_keep = 1.f / p.keep;

  float dk[SC][32], dv[SC][32];  // the slice's columns, 64 per chunk
#pragma unroll
  for (int i = 0; i < SC; ++i) {
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  int n = 0;  // slots consumed so far
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    // the keep bits of this tile, ordered against their readers by the
    // first slot's barrier, and gathered into one word per thread after it
    uint32_t* tb = bits + (t & 1) * 2 * kTile;
    if constexpr (DROP)
      fill_keep_bits<2>(tb, kTile, p.row0 + q0, p.col0 + k0, seed, p.threshold, tid, kConsumers);

    // S^T = K (q * scale)^T over the head dim's chunks, three TF32 passes
    // (SS), every chunk split in its slot; then P^T = exp(S^T + bias - lse)
    // goes to shared memory (as P: query rows x keys), so that S^T's and
    // dP^T's accumulators never hold registers at once
    const float* lse_t = lse_buf + (t & 1) * kTile;
    const float* delta_t = delta_buf + (t & 1) * kTile;
    {
      float sacc[32];  // keys x query rows
      for (int c = 0; c < n_ch; ++c)
        score_chunk(sacc, ring, lo, full, empty, n, p.scale, c == 0, tid);
      const float kb0 = kbias_s[kl_lo], kb1 = kbias_s[kl_lo + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // query rows 8j + 2 t4 and the next
        const float2 lse2 = reinterpret_cast<const float2*>(lse_t)[4 * j + t4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          P_s[(8 * j + 2 * t4 + (e & 1)) * kDsStride + kl_lo + 8 * r] =
              exp_approx(sacc[4 * j + e] + (r ? kb1 : kb0) - ((e & 1) ? lse2.y : lse2.x));
        }
      }
    }
    uint32_t keep_word = 0u;
    if constexpr (DROP) keep_word = gather_keep(tb, kl_lo, t4);

    // dP^T = V dO^T likewise; then dS = P (dP - delta) and P dropped (times
    // 1 / (1 - rate)) in shared memory, where the updates below gather
    // their A fragments (each thread rewrites only the elements it wrote)
    {
      float dpacc[32];
      for (int c = 0; c < n_ch; ++c)
        score_chunk(dpacc, ring, lo, full, empty, n, 1.f, c == 0, tid);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 delta2 = reinterpret_cast<const float2*>(delta_t)[4 * j + t4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int at = (8 * j + 2 * t4 + (e & 1)) * kDsStride + kl_lo + 8 * r;
          const float pj = P_s[at];
          float pd = pj, dpj = dpacc[4 * j + e];
          if constexpr (DROP) {  // 1 / (1 - rate) where kept, else 0
            const float m =
                __uint2float_rn((keep_word >> (2 * (2 * j + (e & 1)) + r)) & 1u) * inv_keep;
            pd *= m;
            dpj *= m;
          }
          P_s[at] = pd;
          dS_s[at] = pj * (dpj - ((e & 1) ? delta2.y : delta2.x));
        }
      }
    }
    consumer_sync();  // ordered for K2's dq share, which reads other warps' dS

    // dV += P^T dO, then dK += dS^T q, over the slice's chunks: mma.sync,
    // the A fragments (keys kl_lo, kl_lo + 8) from P and dS in shared
    // memory, dO and q rows gathered from the raw slot
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = n % kF32Slots;
      const float* slot = ring + s * 2 * kFChunk;
      const float* a_src = (u == 0 ? P_s : dS_s) + 2 * t4 * kDsStride + kl_lo;
      mbar_wait(&full[s], (n / kF32Slots) & 1);
      ++n;
      // unrolled only for K4 at D <= 64: elsewhere the loads of later
      // k-steps, hoisted, spill beside dK and dV's 128 registers (SC = 2)
      // or K2's dq share, and one k-step at a time ran faster
#pragma unroll(SC == 1 && !DQ ? 8 : 1)
      for (int c = 0; c < 8; ++c) {
        uint32_t ah[4], al[4];
        const float* a = a_src + 8 * c * kDsStride;
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8], ah[1], al[1]);
        split_tf32(a[kDsStride], ah[2], al[2]);
        split_tf32(a[kDsStride + 8], ah[3], al[3]);
#pragma unroll
        for (int i = 0; i < SC; ++i) {
          if (i < sl_ch) {
            const int n_nt = live_ntiles(p.D, c0 + 64 * i);
            if (u == 0) {
              mma_tf32x3_step(dv[i], ah, al, slot + i * kFChunk, c, n_nt, bo);
            } else {
              mma_tf32x3_step(dk[i], ah, al, slot + i * kFChunk, c, n_nt, bo);
            }
          }
        }
      }
      mbar_arrive(&empty[s]);
    }

    if constexpr (DQ) {
      // this tile's share of dq's slice: dS K over the CTA's 64 keys, query
      // rows 16 warp + g (+ 8) of dS read from shared memory as mma's A,
      // K's slice rows gathered from its resident chunks, into the scratch
      // (B, H, nk, Tq, D) that dq_reduce_kernel adds up in tile order
      float* part = p.dq_part + (bh * n_kt + kt) * p.Tq * p.D;
      const float* ds_lo_row = dS_s + (warp * 16 + g) * kDsStride + 2 * t4;
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        if (i >= sl_ch) continue;
        float dq[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dq[e] = 0.f;
        const int n_nt = live_ntiles(p.D, c0 + 64 * i);
#pragma unroll 1
        for (int c = 0; c < 8; ++c) {
          const float2 x = *reinterpret_cast<const float2*>(ds_lo_row + 8 * c);
          const float2 y = *reinterpret_cast<const float2*>(ds_lo_row + 8 * kDsStride + 8 * c);
          uint32_t ah[4], al[4];
          split_tf32(x.x, ah[0], al[0]);
          split_tf32(y.x, ah[1], al[1]);
          split_tf32(x.y, ah[2], al[2]);
          split_tf32(y.y, ah[3], al[3]);
          mma_tf32x3_step(dq, ah, al, Ksl + i * kFChunk, c, n_nt, bo);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + warp * 16 + g + 8 * r, col = c0 + 64 * i + 8 * j + 2 * t4;
            if (row >= p.Tq || col >= p.D) continue;
            float* out = part + (long long)row * p.D + col;
            const float x = dq[4 * j + 2 * r] * p.scale, y = dq[4 * j + 2 * r + 1] * p.scale;
            if (p.D % 2 == 0) {
              *reinterpret_cast<float2*>(out) = make_float2(x, y);
            } else {
              out[0] = x;
              if (col + 1 < p.D) out[1] = y;
            }
          }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < SC; ++i) {
    store_rows_f32(dkp, p.dk_st, k0, p.Tk, c0 + 64 * i, p.D, dk[i], p.scale, tid);
    store_rows_f32(dvp, p.dv_st, k0, p.Tk, c0 + 64 * i, p.D, dv[i], 1.f, tid);
  }
}

// ---------------------------------------------------------------------------
// K3 in float32: three-pass TF32 on the tensor cores (tf32.cuh), sweeping
// key tiles. Up to head dim 128 one CTA per (64-row q tile, head, batch row)
// and one consumer warpgroup (dq_tf32_kernel); above it one CTA per (q tile,
// pair of 128-column output slices, head, batch row) and two
// (dq_tf32_wide_kernel)
// ---------------------------------------------------------------------------

constexpr int kDqSlots = 3;    // ring of one-chunk slots
constexpr int kBiasTiles = 4;  // key bias of the tiles in flight

// acc = A . B^T over the head dim's n_ch chunks, three TF32 passes (SS).
// A: QC > 0, resident and split (hi chunks at a_hi, lo at a_lo); QC = 0,
// streamed through the ring before each B chunk and split in its slot times
// `a_mul`, its lo into a_lo. Each B chunk (k or v) is split in its slot, its
// lo into b_lo. `n` counts the slots consumed; `bar` is the warpgroup's
// barrier.
template <int QC>
__device__ __forceinline__ void dq_score(float (&acc)[32], const float* a_hi, float* a_lo,
                                         float a_mul, float* ring, float* b_lo, uint64_t* full,
                                         uint64_t* empty, int& n, int n_ch, int tid, int bar) {
  for (int c = 0; c < n_ch; ++c) {
    const float* ah;
    const float* al;
    int sa = 0;
    if constexpr (QC > 0) {
      ah = a_hi + c * kFChunk;
      al = a_lo + c * kFChunk;
    } else {
      sa = n % kDqSlots;
      float* aslot = ring + sa * kFChunk;
      mbar_wait(&full[sa], (n / kDqSlots) & 1);
      ++n;
      split_chunk(aslot, a_lo, a_mul, tid);
      ah = aslot;
      al = a_lo;
    }
    const int sb = n % kDqSlots;
    float* bslot = ring + sb * kFChunk;
    mbar_wait(&full[sb], (n / kDqSlots) & 1);
    ++n;
    split_chunk(bslot, b_lo, 1.f, tid);
    fence_proxy_async();
    named_sync(bar, kConsumers);
    wg_fence();
    wgmma_tf32x3(acc, ah, al, bslot, b_lo, c == 0);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    named_sync(bar, kConsumers);  // every warp's products are done with the lo chunks
    if constexpr (QC == 0) mbar_arrive(&empty[sa]);
    mbar_arrive(&empty[sb]);
  }
}

// dq {+}= dS K over `n_sc` chunks of k streamed raw through the ring from
// column `col`: mma.sync, dS (accumulator layout) from registers, K rows
// gathered from the raw chunk and split there (tf32.cuh)
template <int SC>
__device__ __forceinline__ void dq_update(float (&acc)[SC][32], const float (&ds)[32],
                                          float* ring, uint64_t* full, uint64_t* empty, int& n,
                                          int n_sc, int col, int d, const BOffsets& bo) {
#pragma unroll
  for (int i = 0; i < SC; ++i) {
    if (i < n_sc) {
      const int s = n % kDqSlots;
      mbar_wait(&full[s], (n / kDqSlots) & 1);
      ++n;
      mma_tf32x3_chunk(acc[i], ds, ring + s * kFChunk, live_ntiles(d, col + 64 * i), bo);
      mbar_arrive(&empty[s]);
    }
  }
}

// a key tile's bias (-1e9 masked, -inf past Tk), written by a producer warp
__device__ __forceinline__ void fill_bias(float* bias, const BwdParams& p, const uint8_t* mask,
                                          int k0, int lane) {
  for (int j = lane; j < kTile; j += 32) {
    const int key = k0 + j;
    bias[j] = key >= p.Tk ? neg_inf() : (mask != nullptr && mask[key] ? kMaskValue : 0.f);
  }
}

// the rows' lse and delta for query rows r_lo and r_lo + 8 of the tile from
// q0 (lse = +inf past Tq: P = 0 there)
__device__ __forceinline__ void row_stats(const BwdParams& p, size_t bh, int q0, int r_lo,
                                          float (&lse_r)[2], float (&delta_r)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_lo + 8 * r;
    lse_r[r] = row < p.Tq ? p.lse[bh * p.Tq + row] : pos_inf();
    delta_r[r] = row < p.Tq ? p.delta[bh * p.Tq + row] : 0.f;
  }
}

// QC: chunks of q and of dO kept resident (2 at D 65-128), 0 when both are
// streamed beside k and v (D <= 64)
template <int QC>
constexpr size_t dq_tf32_smem_bytes() {
  return 1024 +
         sizeof(float) * ((size_t)(QC > 0 ? 4 * QC : 1) * kFChunk +
                          (size_t)(kDqSlots + 1) * kFChunk + kBiasTiles * kTile) +
         sizeof(uint32_t) * 2 * 2 * kTile + sizeof(uint64_t) * (2 * kDqSlots + 1);
}

// SC: chunks of dq (1 at D <= 64, else 2). Two CTAs share an SM where q and
// dO are streamed, one where they are resident: at D <= 64 two CTAs of
// streamed q and dO ran faster than one with them resident, at 128 slower.
template <int QC, int SC, bool DROP>
__global__ void __launch_bounds__(kHopThreads, QC == 0 ? 2 : 1) dq_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  // QC > 0: q * scale (hi, then lo) and dO (hi, then lo), QC chunks each;
  // QC = 0: the lo of the streamed q or dO chunk
  float* res = reinterpret_cast<float*>(align1024(smem_raw));
  float* q_hi = res;
  float* q_lo = res + QC * kFChunk;
  float* do_hi = res + 2 * QC * kFChunk;
  float* do_lo = res + 3 * QC * kFChunk;
  float* ring = res + (QC > 0 ? 4 * QC : 1) * kFChunk;  // kDqSlots chunks
  float* b_lo = ring + kDqSlots * kFChunk;               // lo of the k or v chunk in use
  float* bias_ring = b_lo + kFChunk;                     // kBiasTiles x 64
  uint32_t* bits = reinterpret_cast<uint32_t*>(bias_ring + kBiasTiles * kTile);  // 2 x 128 words
  uint64_t* full = reinterpret_cast<uint64_t*>(bits + 2 * 2 * kTile);
  uint64_t* empty = full + kDqSlots;
  uint64_t* qbar = empty + kDqSlots;

  const int tid = threadIdx.x;
  const int n_ch = (p.D + 63) / 64;  // 64-column chunks of the head dim
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tk + kTile - 1) / kTile;
  const int score_fills = (QC > 0 ? 1 : 2) * n_ch;  // ring slots of one score product
  if (tid == 0) {
    for (int s = 0; s < kDqSlots; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // Per key tile the producer fills the slots of dP's operands (v chunk c,
  // or dO chunk c and v chunk c), then of S's (k, or q and k), then the k
  // chunks again, raw, for dq += dS K: at least three slots, so when it
  // fills tile t's first slot the consumers have released a slot of tile
  // t - 1 and are done with tile t - 2's key bias (tile t overwrites tile
  // t - 4's).
  if (tid >= kConsumers) {
    const int lane = tid - kConsumers;
    const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
    if (QC > 0 && lane == 0) {
      mbar_arrive_tx(qbar, 2 * QC * kFChunkBytes);
      for (int c = 0; c < QC; ++c) {
        tma_chunk(q_hi + c * kFChunk, &tm_q, qbar, 64 * c, q0, h, b);
        tma_chunk(do_hi + c * kFChunk, &tm_do, qbar, 64 * c, q0, h, b);
      }
    }
    int n = 0;  // slots filled so far
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      for (int f = 0; f < 2 * score_fills + n_ch; ++f, ++n) {
        const int s = n % kDqSlots;
        if (n >= kDqSlots) mbar_wait(&empty[s], ((n / kDqSlots) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], kFChunkBytes);
          float* slot = ring + s * kFChunk;
          if (f < 2 * score_fills) {
            const bool dp = f < score_fills;  // dP's operands
            const int i = dp ? f : f - score_fills;
            const bool is_a = QC == 0 && (i & 1) == 0;  // a streamed dO or q chunk
            const int c = QC > 0 ? i : i >> 1;
            const CUtensorMap* map = is_a ? (dp ? &tm_do : &tm_q) : (dp ? &tm_v : &tm_k);
            tma_chunk(slot, map, &full[s], 64 * c, is_a ? q0 : k0, h, b);
          } else {
            tma_chunk(slot, &tm_k, &full[s], 64 * (f - 2 * score_fills), k0, h, b);
          }
        }
        if (f == 0) fill_bias(bias_ring + (t % kBiasTiles) * kTile, p, mask, k0, lane);
        mbar_arrive(&full[s]);  // each lane after its own writes
      }
    }
    return;
  }

  // consumer warpgroup: query rows r_lo and r_lo + 8 of the tile per thread
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r_lo = (tid >> 5) * 16 + (lane >> 2);
  const uint32_t seed = DROP ? (uint32_t)p.seed[bh] : 0u;
  const float inv_keep = 1.f / p.keep;
  const BOffsets bo = b_offsets(lane);
  float lse_r[2], delta_r[2];
  row_stats(p, bh, q0, r_lo, lse_r, delta_r);
  if constexpr (QC > 0) {
    // q * scale (rounded to float32 first, the plain version's rounding
    // point) and dO split once for the whole sweep; the first chunk's fence
    // and barrier below publish them to wgmma
    mbar_wait(qbar, 0);
    for (int c = 0; c < QC; ++c) {
      split_chunk(q_hi + c * kFChunk, q_lo + c * kFChunk, p.scale, tid);
      split_chunk(do_hi + c * kFChunk, do_lo + c * kFChunk, 1.f, tid);
    }
  }
  float* a_lo_q = QC > 0 ? q_lo : res;  // QC = 0: one lo chunk for q and dO
  float* a_lo_do = QC > 0 ? do_lo : res;

  float acc[SC][32];  // dq, 64 columns per chunk
#pragma unroll
  for (int i = 0; i < SC; ++i) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  }

  int n = 0;  // slots consumed so far
  for (int t = 0; t < n_tiles; ++t) {
    // the keep bits of this tile; double-buffered, and the barriers of dP's
    // first chunk order the fill against every reader
    uint32_t* tb = bits + (t & 1) * 2 * kTile;
    if constexpr (DROP)
      fill_keep_bits(tb, kTile, p.row0 + q0, p.col0 + t * kTile, seed, p.threshold, tid,
                     kConsumers);

    // dP = dO V^T, then S = (q * scale) K^T, over the head dim's chunks
    float dpacc[32], sacc[32];
    dq_score<QC>(dpacc, do_hi, a_lo_do, 1.f, ring, b_lo, full, empty, n, n_ch, tid, 1);
    dq_score<QC>(sacc, q_hi, a_lo_q, p.scale, ring, b_lo, full, empty, n, n_ch, tid, 1);

    // P = exp(S + bias - lse) (a fully masked row: lse = -1e9 = S + bias,
    // P = 1), dP dropped (times 1 / (1 - rate) where kept), dS = P (dP -
    // delta) in place of S
    const float* bias = bias_ring + (t % kBiasTiles) * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bias2 = reinterpret_cast<const float2*>(bias)[4 * j + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pj = exp_approx(sacc[4 * j + e] + ((e & 1) ? bias2.y : bias2.x) - lse_r[r]);
        float dpj = dpacc[4 * j + e];
        if constexpr (DROP) dpj *= keep_scale(tb, r_lo + 8 * r, 8 * j + 2 * t4 + (e & 1), inv_keep);
        sacc[4 * j + e] = pj * (dpj - delta_r[r]);
      }
    }
    dq_update<SC>(acc, sacc, ring, full, empty, n, n_ch, 0, p.D, bo);
  }

  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < SC; ++i)
    store_rows_f32(dq, p.dq_st, q0, p.Tq, 64 * i, p.D, acc[i], p.scale, tid);
}

constexpr int kWideThreads = 2 * kHopThreads;  // two consumer warpgroups, two producer warps

// per warpgroup a ring and the lo of its A and B chunks, then the shared
// exchange of P and dS (32 floats a thread), the key bias and the keep bits
constexpr size_t dq_tf32_wide_smem_bytes() {
  return 1024 + sizeof(float) * ((size_t)(2 * (kDqSlots + 2) + 1) * kFChunk + kBiasTiles * kTile) +
         sizeof(uint32_t) * 2 * 2 * kTile + sizeof(uint64_t) * 2 * 2 * kDqSlots;
}

// Above head dim 128. Warpgroup 0 (threads 0-127) computes S = (q * scale)
// K^T over the whole head dim and warpgroup 1 (128-255) dP = dO V^T, both
// from chunks streamed with TMA by their own producer warp (256-287,
// 288-319) through their own ring; warpgroup 0 writes P to shared memory,
// warpgroup 1 turns it into dS there (a thread reads and writes the element
// its namesake in the other warpgroup holds: the accumulator layout depends
// on the thread's index in its warpgroup only), and each accumulates dq over
// its slice of the pair from its producer's raw k chunks. So S and dP run
// once per pair of slices, not once per slice.
template <bool DROP>
__global__ void __launch_bounds__(kWideThreads, 1) dq_tf32_wide_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  float* res = reinterpret_cast<float*>(align1024(smem_raw));
  float* xch = res + 2 * (kDqSlots + 2) * kFChunk;  // P, then dS: element e of thread t at e 128 + t
  float* bias_ring = xch + kFChunk;                  // kBiasTiles x 64
  uint32_t* bits = reinterpret_cast<uint32_t*>(bias_ring + kBiasTiles * kTile);  // 2 x 128 words
  uint64_t* bars = reinterpret_cast<uint64_t*>(bits + 2 * 2 * kTile);

  const int tid = threadIdx.x;
  const int w = tid < 2 * kConsumers ? tid >> 7 : (tid - 2 * kConsumers) >> 5;  // warpgroup
  float* ring = res + w * (kDqSlots + 2) * kFChunk;  // kDqSlots chunks
  float* a_lo = ring + kDqSlots * kFChunk;           // lo of the q or dO chunk in use
  float* b_lo = a_lo + kFChunk;                      // lo of the k or v chunk in use
  uint64_t* full = bars + w * 2 * kDqSlots;
  uint64_t* empty = full + kDqSlots;

  const int n_ch = (p.D + 63) / 64;
  const int n_pairs = (n_slices(p.D) + 1) / 2;
  const int q0 = (blockIdx.x / n_pairs) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int c0 = (2 * (blockIdx.x % n_pairs) + w) * kSlice;  // the warpgroup's slice
  const int sl_ch = max(0, min(2, n_ch - c0 / 64));             // its chunks that hold columns
  const size_t bh = (size_t)b * p.H + h;
  const int n_tiles = (p.Tk + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < 2 * kDqSlots; ++s) {
      mbar_init(&bars[(s / kDqSlots) * 2 * kDqSlots + s % kDqSlots], 32);
      mbar_init(&bars[(s / kDqSlots) * 2 * kDqSlots + kDqSlots + s % kDqSlots], kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // Per key tile producer w fills n_ch (A chunk c, B chunk c) slot pairs, S's
  // (q, k) for warpgroup 0 and dP's (dO, v) for 1, then its slice's raw k
  // chunks: at least six slots, so when producer 0 fills tile t's first slot
  // warpgroup 0 has released a slot of tile t - 1 and is done with tile t -
  // 2's key bias (tile t overwrites tile t - 4's).
  if (tid >= 2 * kConsumers) {
    const int lane = tid & 31;
    const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
    int n = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      for (int f = 0; f < 2 * n_ch + sl_ch; ++f, ++n) {
        const int s = n % kDqSlots;
        if (n >= kDqSlots) mbar_wait(&empty[s], ((n / kDqSlots) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], kFChunkBytes);
          float* slot = ring + s * kFChunk;
          if (f < 2 * n_ch) {
            const bool is_a = (f & 1) == 0;
            const CUtensorMap* map = is_a ? (w == 0 ? &tm_q : &tm_do) : (w == 0 ? &tm_k : &tm_v);
            tma_chunk(slot, map, &full[s], 64 * (f >> 1), is_a ? q0 : k0, h, b);
          } else {
            tma_chunk(slot, &tm_k, &full[s], c0 + 64 * (f - 2 * n_ch), k0, h, b);
          }
        }
        if (w == 0 && f == 0) fill_bias(bias_ring + (t % kBiasTiles) * kTile, p, mask, k0, lane);
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int ltid = tid & (kConsumers - 1);
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r_lo = (ltid >> 5) * 16 + (lane >> 2);
  const uint32_t seed = DROP ? (uint32_t)p.seed[bh] : 0u;
  const float inv_keep = 1.f / p.keep;
  const BOffsets bo = b_offsets(lane);
  float lse_r[2], delta_r[2];
  row_stats(p, bh, q0, r_lo, lse_r, delta_r);
  float* x = xch + ltid;

  float acc[2][32];  // the slice's columns of dq, 64 per chunk
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  }

  int n = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float sacc[32];
    if (w == 0) {
      // S, then P = exp(S + bias - lse) to the exchange (a fully masked row:
      // lse = -1e9 = S + bias, P = 1)
      dq_score<0>(sacc, nullptr, a_lo, p.scale, ring, b_lo, full, empty, n, n_ch, ltid, 1);
      const float* bias = bias_ring + (t % kBiasTiles) * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias2 = reinterpret_cast<const float2*>(bias)[4 * j + t4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[(4 * j + e) * kConsumers] =
              exp_approx(sacc[4 * j + e] + ((e & 1) ? bias2.y : bias2.x) - lse_r[e >> 1]);
      }
      named_sync(3, 2 * kConsumers);  // P is written
      named_sync(3, 2 * kConsumers);  // dS is written
#pragma unroll
      for (int e = 0; e < 32; ++e) sacc[e] = x[e * kConsumers];
    } else {
      // the keep bits of this tile (double-buffered; dq_score's barriers
      // order the fill against the readers), dP, then dS = P (dP - delta),
      // dP dropped (times 1 / (1 - rate) where kept)
      uint32_t* tb = bits + (t & 1) * 2 * kTile;
      if constexpr (DROP)
        fill_keep_bits(tb, kTile, p.row0 + q0, p.col0 + t * kTile, seed, p.threshold, ltid,
                       kConsumers);
      dq_score<0>(sacc, nullptr, a_lo, 1.f, ring, b_lo, full, empty, n, n_ch, ltid, 2);
      named_sync(3, 2 * kConsumers);  // P is written
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float dpj = sacc[4 * j + e];
          if constexpr (DROP) dpj *= keep_scale(tb, r_lo + 8 * r, 8 * j + 2 * t4 + (e & 1), inv_keep);
          sacc[4 * j + e] = x[(4 * j + e) * kConsumers] * (dpj - delta_r[r]);
          x[(4 * j + e) * kConsumers] = sacc[4 * j + e];
        }
      }
      named_sync(3, 2 * kConsumers);  // dS is written
    }
    dq_update<2>(acc, sacc, ring, full, empty, n, sl_ch, c0, p.D, bo);
  }

  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    store_rows_f32(dq, p.dq_st, q0, p.Tq, c0 + 64 * i, p.D, acc[i], p.scale, ltid);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// bf16 launch (K2, K3, K4): tensor maps and dispatch
// ---------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <typename Kernel>
int launch_hop(Kernel kernel, size_t smem, dim3 grid, const Maps& m, const BwdParams& p,
               cudaStream_t stream, int threads = kHopThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(m.q, m.k, m.v, m.dout, p);
  return (int)cudaGetLastError();
}

// K2: the single pass, then dq_reduce_kernel over its dq shares
template <int NC, bool POW2, bool DROP>
int run_dqkv(const Maps& m, const BwdParams& p, cudaStream_t s) {
  if (p.dq_part == nullptr) return -7;
  const int n_kt = (p.Tk + kTile - 1) / kTile;
  const int rc = launch_hop(dqkv_wgmma_kernel<NC, DROP, POW2>, dqkv_hop_smem_bytes<NC, POW2>(),
                            dim3(n_kt, p.H, p.B), m, p, s);
  if (rc != 0) return rc;
  const long long n = (long long)p.B * p.H * p.Tq * p.D;
  dq_reduce_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, n_kt);
  return (int)cudaGetLastError();
}

template <int NC>
int run_hop(const Maps& m, const BwdParams& p, int which, cudaStream_t s) {
  const bool drop = p.seed != nullptr;
  if (which == 1) {
    const dim3 grid((p.Tq + kTile - 1) / kTile, p.H, p.B);
    const size_t smem = dq_hop_smem_bytes<NC>();
    return drop ? launch_hop(dq_wgmma_kernel<NC, true>, smem, grid, m, p, s)
                : launch_hop(dq_wgmma_kernel<NC, false>, smem, grid, m, p, s);
  }
  // round(q * scale) == q * scale exactly when the scale is a power of two
  // (D = 4^n: 1, 4, 16, 64; never above 64, so only the one-chunk kernels)
  int exponent = 0;
  const bool pow2 = frexpf(p.scale, &exponent) == 0.5f;
  if constexpr (NC == 1) {
    if (pow2) {
      if (which == 0) return drop ? run_dqkv<NC, true, true>(m, p, s) : run_dqkv<NC, true, false>(m, p, s);
      const dim3 grid((p.Tk + kTile - 1) / kTile, p.H, p.B);
      const size_t smem = dkv_hop_smem_bytes<NC, true>();
      return drop ? launch_hop(dkv_wgmma_kernel<NC, true, true>, smem, grid, m, p, s)
                  : launch_hop(dkv_wgmma_kernel<NC, false, true>, smem, grid, m, p, s);
    }
  }
  if (which == 0) return drop ? run_dqkv<NC, false, true>(m, p, s) : run_dqkv<NC, false, false>(m, p, s);
  const dim3 grid((p.Tk + kTile - 1) / kTile, p.H, p.B);
  const size_t smem = dkv_hop_smem_bytes<NC, false>();
  return drop ? launch_hop(dkv_wgmma_kernel<NC, true, false>, smem, grid, m, p, s)
              : launch_hop(dkv_wgmma_kernel<NC, false, false>, smem, grid, m, p, s);
}

// bf16 K2 above 128 with dropout: the keep bits of every 64x64 (key tile, q
// tile) in the layout dq_pair_wgmma_kernel writes for K4, one word a thread,
// so that the paired kernel reads them as K4 does (no K3 runs before K2)
__global__ void keep_bits_kernel(const BwdParams p, int n_kt) {
  const long long n = (long long)p.B * p.H * n_kt * p.tq_pad * 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long word = idx >> 1;  // (bh, key tile, row) of the word pair
  const int row = (int)(word % p.tq_pad);
  const int kt = (int)((word / p.tq_pad) % n_kt);
  const long long bh = word / ((long long)p.tq_pad * n_kt);
  fill_keep_bits(p.keep_bits + word * 2, 1, p.row0 + row, p.col0 + kt * kTile,
                 (uint32_t)p.seed[bh], p.threshold, (int)(idx & 1), 2);
}

// bf16 above 128, on the paired kernels: K3 on dq_pair_wgmma_kernel; K4,
// or K2 and its dq sum, on dkv_pair_wgmma_kernel
template <bool DROP>
int run_hop_wide(const Maps& m, const BwdParams& p, int which, cudaStream_t s) {
  const int n_ch = (p.D + 63) / 64;
  const int n_qt = (p.Tq + kTile - 1) / kTile, n_kt = (p.Tk + kTile - 1) / kTile;
  if (which == 1) {
    const DqPair g = dq_pair_config(p.D);
    const int smem = dq_pair_smem(n_ch, g).total;
    const auto kernel = dq_pair_wgmma_kernel<DROP>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(n_qt * ((n_ch + 3) / 4), p.H, p.B), kPairThreads, smem, s>>>(m.q, m.k, m.v,
                                                                                m.dout, p, g);
    return (int)cudaGetLastError();
  }
  const bool dq = which == 0;
  if (dq && p.dq_part == nullptr) return -7;
  if (dq && DROP) {
    if (p.keep_bits == nullptr) return -6;
    const long long n = (long long)p.B * p.H * n_kt * p.tq_pad * 2;
    keep_bits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, n_kt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const DkvPair g = dkv_pair_config(p.D, p.scale, dq);
  const int smem = dkv_pair_smem(n_ch, g, dq).total;
  const auto kernel = dq ? dkv_pair_wgmma_kernel<DROP, true> : dkv_pair_wgmma_kernel<DROP, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_kt * ((n_ch + 3) / 4), p.H, p.B), kPairThreads, smem, s>>>(m.q, m.k, m.v,
                                                                               m.dout, p, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dq) return (int)err;
  const long long n = (long long)p.B * p.H * p.Tq * p.D;
  dq_reduce_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, n_kt);
  return (int)cudaGetLastError();
}

// float32 K4 (which 2) or K2 (which 0, then dq_reduce_kernel over its dq
// shares) on the TF32 kernel
template <int SC, bool DROP>
int run_dkv_tf32(const Maps& m, const BwdParams& p, int which, cudaStream_t s) {
  const int n_kt = (p.Tk + kTile - 1) / kTile;
  const dim3 grid(n_kt * n_slices(p.D), p.H, p.B);
  if (which == 2)
    return launch_hop(dkv_tf32_kernel<SC, DROP, false>, dkv_tf32_smem_bytes<SC, false>(), grid,
                      m, p, s);
  if (p.dq_part == nullptr) return -7;
  const int rc = launch_hop(dkv_tf32_kernel<SC, DROP, true>, dkv_tf32_smem_bytes<SC, true>(),
                            grid, m, p, s);
  if (rc != 0) return rc;
  const long long n = (long long)p.B * p.H * p.Tq * p.D;
  dq_reduce_kernel<float><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, n_kt);
  return (int)cudaGetLastError();
}

// float32 K3 on the TF32 kernels: up to head dim 64 q and dO streamed, at
// 65-128 resident, above 128 the two-warpgroup kernel
int run_dq_tf32(const Maps& m, const BwdParams& p, cudaStream_t s) {
  const bool drop = p.seed != nullptr;
  const int n_qt = (p.Tq + kTile - 1) / kTile;
  if (p.D <= 64) {
    const size_t smem = dq_tf32_smem_bytes<0>();
    return drop ? launch_hop(dq_tf32_kernel<0, 1, true>, smem, dim3(n_qt, p.H, p.B), m, p, s)
                : launch_hop(dq_tf32_kernel<0, 1, false>, smem, dim3(n_qt, p.H, p.B), m, p, s);
  }
  if (p.D <= kSlice) {
    const size_t smem = dq_tf32_smem_bytes<2>();
    return drop ? launch_hop(dq_tf32_kernel<2, 2, true>, smem, dim3(n_qt, p.H, p.B), m, p, s)
                : launch_hop(dq_tf32_kernel<2, 2, false>, smem, dim3(n_qt, p.H, p.B), m, p, s);
  }
  const dim3 grid(n_qt * ((n_slices(p.D) + 1) / 2), p.H, p.B);
  return launch_hop(drop ? dq_tf32_wide_kernel<true> : dq_tf32_wide_kernel<false>,
                    dq_tf32_wide_smem_bytes(), grid, m, p, s, kWideThreads);
}

// float32: K2, K3 and K4 on operands TMA can address in place (-5
// otherwise)
int run_float(const BwdParams& p, int which, cudaStream_t s) {
  if (which < 0 || which > 2) return -3;
  if (!tma_legal(p.q, p.q_sb, p.q_sh, p.q_st, 4) || !tma_legal(p.k, p.k_sb, p.k_sh, p.k_st, 4) ||
      !tma_legal(p.v, p.v_sb, p.v_sh, p.v_st, 4) ||
      !tma_legal(p.dout, p.do_sb, p.do_sh, p.do_st, 4))
    return -5;
  Maps m;
  int rc = encode_map(&m.q, p.q, p.B, p.H, p.Tq, p.D, p.q_sb, p.q_sh, p.q_st, true);
  if (rc == 0) rc = encode_map(&m.k, p.k, p.B, p.H, p.Tk, p.D, p.k_sb, p.k_sh, p.k_st, true);
  if (rc == 0) rc = encode_map(&m.v, p.v, p.B, p.H, p.Tk, p.D, p.v_sb, p.v_sh, p.v_st, true);
  if (rc == 0)
    rc = encode_map(&m.dout, p.dout, p.B, p.H, p.Tq, p.D, p.do_sb, p.do_sh, p.do_st, true);
  if (rc != 0) return rc;
  if (which == 1) return run_dq_tf32(m, p, s);
  const bool drop = p.seed != nullptr;
  if (p.D <= 64) return drop ? run_dkv_tf32<1, true>(m, p, which, s) : run_dkv_tf32<1, false>(m, p, which, s);
  return drop ? run_dkv_tf32<2, true>(m, p, which, s) : run_dkv_tf32<2, false>(m, p, which, s);
}

// bf16: K2 (which 0), K3 (which 1) or K4 (which 2); with dropout K3 writes
// the keep bits to p.keep_bits and K4 reads them, while K2 draws its own
int run_hopper(const BwdParams& p, int which, cudaStream_t s) {
  if (which < 0 || which > 2) return -3;
  if (!tma_legal(p.q, p.q_sb, p.q_sh, p.q_st) || !tma_legal(p.k, p.k_sb, p.k_sh, p.k_st) ||
      !tma_legal(p.v, p.v_sb, p.v_sh, p.v_st) ||
      !tma_legal(p.dout, p.do_sb, p.do_sh, p.do_st))
    return -5;
  if (which != 0 && p.seed != nullptr && p.keep_bits == nullptr) return -6;
  Maps m;
  int rc = encode_map(&m.q, p.q, p.B, p.H, p.Tq, p.D, p.q_sb, p.q_sh, p.q_st);
  if (rc == 0) rc = encode_map(&m.k, p.k, p.B, p.H, p.Tk, p.D, p.k_sb, p.k_sh, p.k_st);
  if (rc == 0) rc = encode_map(&m.v, p.v, p.B, p.H, p.Tk, p.D, p.v_sb, p.v_sh, p.v_st);
  if (rc == 0) rc = encode_map(&m.dout, p.dout, p.B, p.H, p.Tq, p.D, p.do_sb, p.do_sh, p.do_st);
  if (rc != 0) return rc;
  if (p.D > kSlice)
    return p.seed != nullptr ? run_hop_wide<true>(m, p, which, s) : run_hop_wide<false>(m, p, which, s);
  return p.D <= 64 ? run_hop<1>(m, p, which, s) : run_hop<2>(m, p, which, s);
}

}  // namespace

// which: 0 = K2 (dq, dk, dv), 1 = K3 (dq), 2 = K4 (dk, dv). dtype: 0 =
// float32, 1 = bfloat16. dq_part: float32 scratch of B*H*ceil(Tk/64)*Tq*D
// floats for K2's dq shares (null for K3 and K4). keep_bits: with
// dropout in bf16 K3/K4, a (B, H, ceil(Tk/64), 64 ceil(Tq/64), 2) uint32
// buffer (the keep bits of each 64x64 tile in 512 contiguous bytes) that K3
// fills and K4 reads; null otherwise.
// Any head dim: above 128 the wide kernels run. Returns 0, a cudaError_t
// code, -1 for an unknown dtype, -3 for an unknown `which`, -4 when the
// driver refuses a tensor map, -5 for a bf16 operand TMA cannot address, -6
// for dropout without keep_bits, -7 for bf16 K2 without dq_part, -8 for a
// negative offset or a col0 that is no multiple of 4.
extern "C" int vimo_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* mask,
    const float* lse, const float* delta, const int* seed,
    void* dq, void* dk, void* dv, float* dq_part, unsigned int* keep_bits,
    int which, int dtype, int B, int H, int Tq, int Tk, int D, int row0, int col0,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long do_sb, long long do_sh, long long do_st,
    long long dq_sb, long long dq_sh, long long dq_st,
    long long dk_sb, long long dk_sh, long long dk_st,
    long long dv_sb, long long dv_sh, long long dv_st,
    long long m_sb, float scale, unsigned int threshold, float keep, void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.lse = lse; p.delta = delta; p.seed = seed;
  p.dq = dq; p.dk = dk; p.dv = dv; p.dq_part = dq_part;
  p.keep_bits = keep_bits; p.tq_pad = (Tq + 63) / 64 * 64;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
  if (row0 < 0 || col0 < 0 || col0 % 4 != 0) return -8;
  p.row0 = row0; p.col0 = col0;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_st = do_st;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_st = dq_st;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_st = dk_st;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_st = dv_st;
  p.m_sb = m_sb;
  p.scale = scale;
  p.threshold = seed != nullptr ? threshold : 0u;
  p.keep = seed != nullptr ? keep : 1.0f;
  p.inv_keep = 1.0f / p.keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_float(p, which, s);
  if (dtype == 1) return run_hopper(p, which, s);
  return -1;
}

// CTAs of bf16 K2 that fit one SM at head dim D, with or without dropout
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the power-of-two-scale
// kernel at D <= 64, the wide kernel above 128); a negative cudaError_t code
// on failure
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int threads = kHopThreads) {
  int n = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int vimo_flash_attention_bwd_dqkv_occupancy(int D, int drop) {
  if (D <= 64)
    return drop ? occupancy(dqkv_wgmma_kernel<1, true, true>, dqkv_hop_smem_bytes<1, true>())
                : occupancy(dqkv_wgmma_kernel<1, false, true>, dqkv_hop_smem_bytes<1, true>());
  if (D <= kSlice)
    return drop ? occupancy(dqkv_wgmma_kernel<2, true, false>, dqkv_hop_smem_bytes<2, false>())
                : occupancy(dqkv_wgmma_kernel<2, false, false>, dqkv_hop_smem_bytes<2, false>());
  // the model's scale, 1 / sqrt(D), which decides the paired kernel's layout
  const DkvPair g = dkv_pair_config(D, 1.f / sqrtf((float)D), true);
  const size_t smem = dkv_pair_smem((D + 63) / 64, g, true).total;
  return drop ? occupancy(dkv_pair_wgmma_kernel<true, true>, smem, kPairThreads)
              : occupancy(dkv_pair_wgmma_kernel<false, true>, smem, kPairThreads);
}

// CTAs of bf16 K3 that fit one SM at head dim D, with or without dropout
// (the paired kernel above 128, in its layout at that head dim); a negative
// cudaError_t code on failure
extern "C" int vimo_flash_attention_bwd_dq_occupancy(int D, int drop) {
  if (D <= 64)
    return drop ? occupancy(dq_wgmma_kernel<1, true>, dq_hop_smem_bytes<1>())
                : occupancy(dq_wgmma_kernel<1, false>, dq_hop_smem_bytes<1>());
  if (D <= kSlice)
    return drop ? occupancy(dq_wgmma_kernel<2, true>, dq_hop_smem_bytes<2>())
                : occupancy(dq_wgmma_kernel<2, false>, dq_hop_smem_bytes<2>());
  const size_t smem = dq_pair_smem((D + 63) / 64, dq_pair_config(D)).total;
  return drop ? occupancy(dq_pair_wgmma_kernel<true>, smem, kPairThreads)
              : occupancy(dq_pair_wgmma_kernel<false>, smem, kPairThreads);
}

extern "C" const char* vimo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

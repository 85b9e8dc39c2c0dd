// Masked multi-head attention backward, for NVIDIA Hopper (sm_90a). Plain C
// entry point, bound from Python with ctypes
// (vimoclip_tpu_torch/ops/kernels/flash_attention.py), where a
// torch.autograd.Function pairs it with the forward's lse variant.
//
// Replaces: vimoclip_tpu/ops/pallas/flash_attention.py::_bwd_local and its
// three kernels:
//   K2 _dqkv_single_kernel (keys fit one 512-key tile): entry `which` = 0
//   K3 _dq_kernel  (dq sweep over key tiles, Tk > 512):  `which` = 1
//   K4 _dkv_kernel (dk/dv sweep over query tiles):       `which` = 2
//
// What it computes, per (b, h), from the forward's lse and
// delta = rowsum(dO * O) (both float32, computed outside, as on the TPU):
//   s  = round_T(q * scale) . k + bias        (float32; bias -1e9 masked key,
//                                              keys past Tk left out)
//   P  = exp(s - lse)
//   dP = keep ? (dO . v) / (1 - rate) : 0      (keep: the forward's Philox
//                                              bits, flash_attention_common.cuh)
//   dS = P * (dP - delta)
//   dQ = round_T(dS) . K * scale,  dK = round_T(dS)^T . Q * scale,
//   dV = round_T(keep ? P / (1 - rate) : 0)^T . dO
// with float32 accumulators throughout and one rounding to T at the store,
// the rounding points of the TPU kernels (flash_attention.py:199-231, 262,
// 268). T is float32 or bfloat16.
//
// Design. One recompute of P gives all three gradients in K2: one CTA per
// (64-key tile, head, batch row) sweeps every 64-row query tile, keeping its
// keys' dK/dV in registers, and writes its share of dQ (the sum over its 64
// keys) to float32 scratch (B, H, nk, Tq, D); a second small kernel adds the
// nk shares in a fixed order. No atomics anywhere, so two calls give
// bitwise-equal gradients. K4 is the same CTA without the dQ share; K3 is
// one CTA per 64-row query tile sweeping the key tiles with dQ in
// registers. The keep bits of each 64x64 tile are drawn into a shared-memory
// bitmask by the whole CTA from global (row, column) coordinates, so every
// kernel regenerates the forward's mask whatever its tiling.
//
// What bounds it on the H100: at the TFAM training shapes (B=8, H=8,
// T=384, D=64) a backward is about 6 GFLOP on a few MB, so operations bound
// it: 6 us on bf16 tensor cores. This first version does the products with
// float32 FMAs from shared memory for both types (four lanes share a row or
// key, as in the forward's float32 kernel), so it runs far from that bound,
// at best near the 67 TF/s FMA rate. Moving the bf16 products onto
// mma.sync/wgmma is later work.

#include "flash_attention_common.cuh"

namespace {

using vimo::fill_keep_bits;
using vimo::kept;
using vimo::mask_score;
using vimo::pos_inf;

constexpr int kB = 64;                  // query rows per q tile, keys per k tile
constexpr int kLanes = 4;               // lanes sharing one row (or one key)
constexpr int kThreads = kB * kLanes;   // 256
constexpr int kPer = kB / kLanes;       // partners per lane in a 64x64 tile
constexpr int kBitWords = 2 * kB;

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
  int B, H, Tq, Tk, D;
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
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_t(float x) { return to_f(from_f<T>(x)); }

// rows [r0, r0 + kB) of a (T, D) head, as float32 (times `mul`, rounded to T
// when `mul` != 1), into a kB x S shared tile; zeros past `t` and past D
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long st, int r0,
                                           int t, int d, float mul, bool scaled, int tid) {
  constexpr int S = DP + 1;
  for (int e = tid; e < kB * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    float x = 0.f;
    if (r0 + r < t && c < d) {
      x = to_f(src[(long long)(r0 + r) * st + c]);
      if (scaled) x = round_t<T>(x * mul);
    }
    dst[r * S + c] = x;
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)4 * kB * (DP + 1) + kB * (kB + 4)) +
         sizeof(uint32_t) * kBitWords;
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)5 * kB * (DP + 1) + 2 * kB * (kB + 4) + 2 * kB) +
         sizeof(uint32_t) * kBitWords;
}

// ---------------------------------------------------------------------------
// K3: dq, one CTA per (64-row q tile, head, batch row), sweeping key tiles
// ---------------------------------------------------------------------------

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = kB + 4;
  constexpr int DPL = DP / kLanes;
  extern __shared__ float smem[];
  float* Qs = smem;            // round_T(q * scale)
  float* dOs = Qs + kB * S;
  float* Ks = dOs + kB * S;
  float* Vs = Ks + kB * S;
  float* dSs = Vs + kB * S;    // kB x PS : round_T(dS)
  uint32_t* bits = reinterpret_cast<uint32_t*>(dSs + kB * PS);

  const int tid = threadIdx.x;
  const int row = tid / kLanes, lane = tid % kLanes;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
  const uint32_t seed = DROP ? (uint32_t)p.seed[b * p.H + h] : 0u;

  stage_rows<T, DP>(Qs, q, p.q_st, q0, p.Tq, p.D, p.scale, true, tid);
  stage_rows<T, DP>(dOs, dout, p.do_st, q0, p.Tq, p.D, 1.f, false, tid);
  const bool row_in = q0 + row < p.Tq;
  const size_t rs = ((size_t)b * p.H + h) * p.Tq + q0 + row;
  const float lse_r = row_in ? p.lse[rs] : 0.f;
  const float delta_r = row_in ? p.delta[rs] : 0.f;

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  const float* qrow = Qs + row * S;
  const float* dorow = dOs + row * S;
  float* dsrow = dSs + row * PS;

  const int n_tiles = (p.Tk + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile is consumed (and Qs/dOs written)
    stage_rows<T, DP>(Ks, k, p.k_st, k0, p.Tk, p.D, 1.f, false, tid);
    stage_rows<T, DP>(Vs, v, p.v_st, k0, p.Tk, p.D, 1.f, false, tid);
    if constexpr (DROP) fill_keep_bits(bits, kB, q0, k0, seed, p.threshold, tid, kThreads);
    __syncthreads();

    float s[kPer], dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      const float qc = qrow[c], dc = dorow[c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kk = (lane + kLanes * j) * S + c;
        s[j] = fmaf(qc, Ks[kk], s[j]);
        dp[j] = fmaf(dc, Vs[kk], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int jj = lane + kLanes * j;
      const float pj = expf(mask_score(s[j], k0 + jj, p.Tk, mask) - lse_r);
      float dpj = dp[j];
      if constexpr (DROP) dpj = kept(bits, row, jj) ? dpj / p.keep : 0.f;
      dsrow[jj] = row_in ? round_t<T>(pj * (dpj - delta_r)) : 0.f;
    }
    __syncwarp();  // the row's four lanes see each other's dS

    const int n_keys = min(kB, p.Tk - k0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const float ds = dsrow[jj];
      const float* krow = Ks + jj * S + lane;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(ds, krow[kLanes * i], acc[i]);
    }
  }

  if (row_in) {
    T* out = dq + (long long)(q0 + row) * p.dq_st;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + kLanes * i;
      if (c < p.D) out[c] = from_f<T>(acc[i] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 (and K2 with DQ): dk/dv, one CTA per (64-key tile, head, batch row),
// sweeping query tiles; with DQ also the tile's share of dq into scratch
// ---------------------------------------------------------------------------

template <typename T, int DP, bool DROP, bool DQ>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const BwdParams p) {
  constexpr int S = DP + 1;
  constexpr int PS = kB + 4;
  constexpr int DPL = DP / kLanes;
  extern __shared__ float smem[];
  float* Ks = smem;            // this CTA's keys, unscaled
  float* Vs = Ks + kB * S;
  float* Qs = Vs + kB * S;     // round_T(q * scale) of the current q tile
  float* Qu = Qs + kB * S;     // q, unscaled
  float* dOs = Qu + kB * S;
  float* Ps = dOs + kB * S;    // kB keys x PS rows : round_T(dropped P / keep)
  float* dSs = Ps + kB * PS;   // kB keys x PS rows : round_T(dS)
  float* lse_s = dSs + kB * PS;
  float* delta_s = lse_s + kB;
  uint32_t* bits = reinterpret_cast<uint32_t*>(delta_s + kB);

  const int tid = threadIdx.x;
  const int key = tid / kLanes, lane = tid % kLanes;
  const int k0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
  const uint32_t seed = DROP ? (uint32_t)p.seed[b * p.H + h] : 0u;
  const size_t bh = (size_t)b * p.H + h;

  stage_rows<T, DP>(Ks, k, p.k_st, k0, p.Tk, p.D, 1.f, false, tid);
  stage_rows<T, DP>(Vs, v, p.v_st, k0, p.Tk, p.D, 1.f, false, tid);

  float dk[DPL], dv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) dk[i] = dv[i] = 0.f;
  const float* krow = Ks + key * S;
  const float* vrow = Vs + key * S;
  float* prow = Ps + key * PS;
  float* dsrow = dSs + key * PS;

  const int n_tiles = (p.Tq + kB - 1) / kB;
  const int n_kt = gridDim.x;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kB;
    __syncthreads();  // the previous tile is consumed (and Ks/Vs written)
    stage_rows<T, DP>(Qs, q, p.q_st, q0, p.Tq, p.D, p.scale, true, tid);
    stage_rows<T, DP>(Qu, q, p.q_st, q0, p.Tq, p.D, 1.f, false, tid);
    stage_rows<T, DP>(dOs, dout, p.do_st, q0, p.Tq, p.D, 1.f, false, tid);
    for (int r = tid; r < kB; r += kThreads) {
      const bool in = q0 + r < p.Tq;
      lse_s[r] = in ? p.lse[bh * p.Tq + q0 + r] : pos_inf();  // P = 0 past Tq
      delta_s[r] = in ? p.delta[bh * p.Tq + q0 + r] : 0.f;
    }
    if constexpr (DROP) fill_keep_bits(bits, kB, q0, k0, seed, p.threshold, tid, kThreads);
    __syncthreads();

    float s[kPer], dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      const float kc = krow[c], vc = vrow[c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qq = (lane + kLanes * j) * S + c;
        s[j] = fmaf(Qs[qq], kc, s[j]);
        dp[j] = fmaf(dOs[qq], vc, dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = lane + kLanes * j;
      const float pj = expf(mask_score(s[j], k0 + key, p.Tk, mask) - lse_s[r]);
      float pd = pj, dpj = dp[j];
      if constexpr (DROP) {
        const bool kp = kept(bits, r, key);
        pd = kp ? pj / p.keep : 0.f;
        dpj = kp ? dpj / p.keep : 0.f;
      }
      prow[r] = round_t<T>(pd);
      dsrow[r] = round_t<T>(pj * (dpj - delta_s[r]));
    }
    __syncwarp();  // the key's four lanes see each other's P and dS

    const int n_rows = min(kB, p.Tq - q0);
    for (int r = 0; r < n_rows; ++r) {
      const float pd = prow[r], ds = dsrow[r];
      const float* dor = dOs + r * S + lane;
      const float* qur = Qu + r * S + lane;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        dv[i] = fmaf(pd, dor[kLanes * i], dv[i]);
        dk[i] = fmaf(ds, qur[kLanes * i], dk[i]);
      }
    }

    if constexpr (DQ) {
      __syncthreads();  // every key's dS of this tile is in shared memory
      const int r = tid / kLanes;
      if (q0 + r < p.Tq) {
        float acc[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
        const int n_keys = min(kB, p.Tk - k0);
        for (int kk = 0; kk < n_keys; ++kk) {
          const float ds = dSs[kk * PS + r];
          const float* kr = Ks + kk * S + lane;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] = fmaf(ds, kr[kLanes * i], acc[i]);
        }
        float* out = p.dq_part + ((bh * n_kt + blockIdx.x) * p.Tq + q0 + r) * p.D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int c = lane + kLanes * i;
          if (c < p.D) out[c] = acc[i] * p.scale;
        }
      }
    }
  }

  if (k0 + key < p.Tk) {
    T* dkr = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh + (long long)(k0 + key) * p.dk_st;
    T* dvr = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh + (long long)(k0 + key) * p.dv_st;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + kLanes * i;
      if (c < p.D) {
        dkr[c] = from_f<T>(dk[i] * p.scale);
        dvr[c] = from_f<T>(dv[i]);
      }
    }
  }
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
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const BwdParams& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool DROP>
int run(const BwdParams& p, int which, cudaStream_t s) {
  const int n_qt = (p.Tq + kB - 1) / kB, n_kt = (p.Tk + kB - 1) / kB;
  if (which == 1)
    return launch(dq_kernel<T, DP, DROP>, dq_smem_bytes<DP>(), dim3(n_qt, p.H, p.B), p, s);
  if (which == 2)
    return launch(dkv_kernel<T, DP, DROP, false>, dkv_smem_bytes<DP>(),
                  dim3(n_kt, p.H, p.B), p, s);
  if (which != 0) return -3;
  const int rc = launch(dkv_kernel<T, DP, DROP, true>, dkv_smem_bytes<DP>(),
                        dim3(n_kt, p.H, p.B), p, s);
  if (rc != 0) return rc;
  const long long n = (long long)p.B * p.H * p.Tq * p.D;
  dq_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, n_kt);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int run_drop(const BwdParams& p, int which, cudaStream_t s) {
  if (p.seed != nullptr) return run<T, DP, true>(p, which, s);
  return run<T, DP, false>(p, which, s);
}

template <typename T>
int run_type(const BwdParams& p, int which, cudaStream_t s) {
  if (p.D <= 32) return run_drop<T, 32>(p, which, s);
  if (p.D <= 64) return run_drop<T, 64>(p, which, s);
  return run_drop<T, 128>(p, which, s);
}

}  // namespace

// which: 0 = K2 (dq, dk, dv; dq_part scratch of B*H*ceil(Tk/64)*Tq*D
// floats), 1 = K3 (dq), 2 = K4 (dk, dv). dtype: 0 = float32, 1 = bfloat16.
// Returns 0, a cudaError_t code, -1 for an unknown dtype, -2 for a head dim
// above 128 or -3 for an unknown `which`.
extern "C" int vimo_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* mask,
    const float* lse, const float* delta, const int* seed,
    void* dq, void* dk, void* dv, float* dq_part,
    int which, int dtype, int B, int H, int Tq, int Tk, int D,
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
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 128) return -2;
  if (dtype == 0) return run_type<float>(p, which, s);
  if (dtype == 1) return run_type<__nv_bfloat16>(p, which, s);
  return -1;
}

extern "C" const char* vimo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

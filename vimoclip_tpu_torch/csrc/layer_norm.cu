// Fused residual add + LayerNorm + cast between the vision towers' GEMMs,
// for NVIDIA Hopper (sm_90a). Plain C entry point, bound from Python with
// ctypes (vimoclip_tpu_torch/ops/kernels/layer_norm.py).
//
// Replaces no TPU kernel: the JAX package leaves the residual add and the
// LayerNorm to XLA, which fuses them into the GEMMs' neighbours itself. In
// the port each tower block ran them as three PyTorch passes over the
// float32 residual stream: x + o (a float32 + bf16 add, 10 B an element),
// F.layer_norm(x) (8 B) and the next linear's cast to bf16 (6 B), twice a
// block. What it computes, for each row r of a contiguous (rows, H) float32
// x, an optional (rows, H) delta (float32 or bf16) and float32 w, b of H:
//   x_out[r] = x[r] + float(delta[r])                   (one float32 add)
//   mean = sum(x_out[r]) / H,  var = sum((x_out[r] - mean)^2) / H
//   out[r] = round_T(w * (rsqrt(var + eps) * (x_out[r] - mean)) + b)
// with T float32 or bf16 (round-to-nearest-even). x_out equals PyTorch's
// x + delta bit for bit; out differs from F.layer_norm(x_out).to(T) only by
// the order of the two sums (PyTorch's kernel runs Welford's update).
// Without delta it writes out alone and x_out is x. Given mean and rstd
// (float32 of rows, or null), it also writes each row's mean and
// rsqrt(var + eps), 8 B a row: what PyTorch's LayerNorm backward takes, so
// a training step runs this kernel forward and
// aten::native_layer_norm_backward after it.
//
// What bounds it on the H100: memory alone. Per element 4 B of x and 2 B of
// a bf16 delta read, 4 B of x_out and 2 B of a bf16 out written: 12 B, and
// ~8 flops. At the SigLIP teacher's window (128 frames x 729 tokens, H
// 1152) one call moves 1.29 GB, 0.385 ms at 3.35 TB/s. The design moves each
// byte once:
//
// - One warp per row, the row held in registers: lane l owns the 4-element
//   chunks l, l + 32, ... (VEC = ceil(H / 128) of them: 9 at 1152, 6 at
//   768), loaded as one 16-byte load of x and one 8-byte (bf16) or 16-byte
//   (float32) load of delta each, all issued before the first is used, so a
//   warp keeps ~7 KB in flight at 1152. Every warp access is contiguous.
// - Mean and centred variance in two passes over the registers (no second
//   read of device memory, no E[x^2] - mean^2 cancellation), each a
//   butterfly of warp shuffles; then rsqrtf.
// - w and b (4.6 KB each at 1152) are read per row through the read-only
//   path: every row of every CTA reads the same lines, so they stay in L1
//   and L2 and cost no device-memory bytes.
// - No shared memory, no synchronisation: 8 warps (rows) a CTA, a CTA per 8
//   rows. A ragged row count leaves the last CTA's spare warps idle; a
//   hidden size that is no multiple of 128 leaves lanes idle in the last
//   chunk (the chunk index is checked, the row is never padded).
// - VEC is a template parameter chosen from H at the launch, a shape the
//   caller observes: one algorithm for CLIP B (768), SigLIP (1152) and any
//   H that is a multiple of 4 up to 2048.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per CTA, one warp each
constexpr int kMaxVec = 16;  // H up to 16 * 128 = 2048

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

template <int VEC, typename DeltaT, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
add_layer_norm_kernel(const float* __restrict__ x, const DeltaT* __restrict__ delta,
                      const float* __restrict__ weight, const float* __restrict__ bias,
                      float* __restrict__ x_out, OutT* __restrict__ out,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int64_t rows,
                      int hidden, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int chunks = hidden >> 2;
  const int64_t base = row * hidden;

  float v[VEC][4];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = j * 32 + lane;
    if (c < chunks) {
      load4(x + base + 4 * c, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = 0.f;
    }
  }
  if (delta != nullptr) {
    float d[VEC][4];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = j * 32 + lane;
      if (c < chunks) {
        load4(delta + base + 4 * c, d[j]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) d[j][k] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = __fadd_rn(v[j][k], d[j][k]);
      const int c = j * 32 + lane;
      if (c < chunks) store4(x_out + base + 4 * c, v[j]);
    }
  }

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s += v[j][k];  // lanes past the row hold zeros
  }
  const float mean = warp_sum(s) / static_cast<float>(hidden);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (j * 32 + lane < chunks) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t = v[j][k] - mean;
        q = fmaf(t, t, q);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / static_cast<float>(hidden) + eps);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = j * 32 + lane;
    if (c < chunks) {
      float w[4], b[4], o[4];
      load4(weight + 4 * c, w);
      load4(bias + 4 * c, b);
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = fmaf(w[k], rstd * (v[j][k] - mean), b[k]);
      store4(out + base + 4 * c, o);
    }
  }
}

template <int VEC, typename DeltaT, typename OutT>
int launch_vec(const float* x, const void* delta, const float* w, const float* b,
               float* x_out, void* out, float* mean, float* rstd, int64_t rows, int hidden,
               float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  add_layer_norm_kernel<VEC, DeltaT, OutT><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                                             stream>>>(
      x, static_cast<const DeltaT*>(delta), w, b, x_out, static_cast<OutT*>(out), mean, rstd,
      rows, hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename DeltaT, typename OutT, int VEC = 1>
int dispatch_vec(int vec, const float* x, const void* delta, const float* w, const float* b,
                 float* x_out, void* out, float* mean, float* rstd, int64_t rows, int hidden,
                 float eps, cudaStream_t stream) {
  if constexpr (VEC > kMaxVec) {
    return -1;
  } else {
    if (vec == VEC)
      return launch_vec<VEC, DeltaT, OutT>(x, delta, w, b, x_out, out, mean, rstd, rows,
                                           hidden, eps, stream);
    return dispatch_vec<DeltaT, OutT, VEC + 1>(vec, x, delta, w, b, x_out, out, mean, rstd,
                                               rows, hidden, eps, stream);
  }
}

template <typename DeltaT>
int dispatch_out(int out_dtype, int vec, const float* x, const void* delta, const float* w,
                 const float* b, float* x_out, void* out, float* mean, float* rstd,
                 int64_t rows, int hidden, float eps, cudaStream_t stream) {
  if (out_dtype == 0)
    return dispatch_vec<DeltaT, float>(vec, x, delta, w, b, x_out, out, mean, rstd, rows,
                                       hidden, eps, stream);
  if (out_dtype == 1)
    return dispatch_vec<DeltaT, __nv_bfloat16>(vec, x, delta, w, b, x_out, out, mean, rstd,
                                               rows, hidden, eps, stream);
  return -1;
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

}  // namespace

// delta may be null (then delta_dtype is ignored and x_out is not written);
// mean and rstd are both null or both rows floats; delta_dtype and
// out_dtype: 0 float32, 1 bfloat16. Returns 0, a CUDA error
// code (> 0), -1 for an unsupported hidden size or dtype, -2 for a pointer
// not aligned to its vector loads and stores.
extern "C" int vimo_add_layer_norm(const float* x, const void* delta, int delta_dtype,
                                   const float* weight, const float* bias, float* x_out,
                                   void* out, int out_dtype, float* mean, float* rstd,
                                   int64_t rows, int hidden, float eps, void* stream) {
  if (hidden <= 0 || hidden % 4 != 0 || hidden > kMaxVec * 128) return -1;
  if (delta_dtype != 0 && delta_dtype != 1) return -1;
  if (out_dtype != 0 && out_dtype != 1) return -1;
  if ((mean == nullptr) != (rstd == nullptr)) return -1;
  const uintptr_t delta_vec = delta_dtype == 0 ? 16 : 8, out_vec = out_dtype == 0 ? 16 : 8;
  if (!aligned(x, 16) || !aligned(weight, 16) || !aligned(bias, 16) || !aligned(out, out_vec) ||
      (delta != nullptr && (!aligned(delta, delta_vec) || !aligned(x_out, 16))))
    return -2;
  if (rows <= 0) return 0;
  const int vec = (hidden + 127) / 128;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (delta == nullptr || delta_dtype == 0)
    return dispatch_out<float>(out_dtype, vec, x, delta, weight, bias, x_out, out, mean, rstd,
                               rows, hidden, eps, s);
  return dispatch_out<__nv_bfloat16>(out_dtype, vec, x, delta, weight, bias, x_out, out, mean,
                                     rstd, rows, hidden, eps, s);
}

extern "C" const char* vimo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

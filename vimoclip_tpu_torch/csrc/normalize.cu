// Fused uint8 -> CLIP-normalised float conversion, for NVIDIA Hopper
// (sm_90a). Plain C entry point, bound from Python with ctypes
// (vimoclip_tpu_torch/ops/kernels/normalize.py).
//
// Replaces: vimoclip_tpu/ops/pallas/preprocess_kernel.py::fused_normalize
// (kernel _normalize_kernel). What it computes, for element i of a
// contiguous (..., H, W, 3) uint8 tensor, whose channel is c = i mod 3:
//   out[i] = round_T((float(x[i]) - sub_c) * mul_c)
// with sub_c = f32(mean_c) * 255 and mul_c = 1 / (f32(std_c) * 255) computed
// on the host in float32 as on the TPU, the subtraction and the product each
// rounded once (no FMA contraction), then one rounding to T (float32, or
// bfloat16 round-to-nearest-even). The plain version in normalize.py does the
// same two operations, so the two agree bit for bit.
//
// What bounds it on the H100: nothing but memory. One byte read and 4 (f32)
// or 2 (bf16) bytes written per element, two flops each: at the stage-1
// training step's (232, 224, 224, 3) frames 104.8 MB in bf16, 31 us at
// 3.35 TB/s. The design moves each byte once, every warp access contiguous:
//
// - The TPU padded rows to a block and took the channel from a W*3-wide
//   constant table laid out for its lanes. Here a thread takes a group of G
//   consecutive elements (4 for f32, 8 for bf16): one 4- or 8-byte load and
//   one 16-byte store, so a warp's load and its store each cover one
//   contiguous span. The group's first channel is (first element) mod 3;
//   the three constants are rotated into registers by it.
// - Each thread keeps 4 groups in flight (loads first, then the stores), a
//   grid-stride loop covers any size.
// - Any element count and any base alignment: the groups start at the first
//   element where the input is G-byte and the output 16-byte aligned; the
//   few elements before it and after the last whole group are done one by
//   one by the same kernel. When no element aligns both (an input view at
//   an odd offset with a float32 output), every element takes that scalar
//   path. Nothing is padded.
//
// A first version gave each thread 48 elements (three 16-byte loads, the
// lcm of 16 and 3, so a fixed channel pattern) and 12 or 6 16-byte stores at
// a 192- or 96-byte stride across the warp: it ran at 437 GB/s in f32 and
// 923 GB/s in bf16 on an H100 80GB HBM3 at 700 W (PERF.md), slower than the
// plain version in f32. Contiguous warp stores are what this version changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // groups in flight per thread

struct Consts {
  float sub[3];
  float mul[3];
};

template <typename T>
struct Group;
template <>
struct Group<float> {  // 4 elements: a 4-byte load, one float4 store
  static constexpr int G = 4;
  using In = uint32_t;
};
template <>
struct Group<__nv_bfloat16> {  // 8 elements: an 8-byte load, one 16-byte store
  static constexpr int G = 8;
  using In = uint2;
};

__device__ __forceinline__ float normalize1(uint32_t x, float sub, float mul) {
  return __fmul_rn(__fsub_rn(static_cast<float>(x), sub), mul);
}

// entry (c + j) mod 3 of a three-entry table, j a compile-time offset
__device__ __forceinline__ float rotated(const float (&t)[3], int c, int j) {
  const int i = c + j >= 3 ? c + j - 3 : c + j;
  return i == 0 ? t[0] : (i == 1 ? t[1] : t[2]);
}

// 32-bit word i (a compile-time index) of a group's input
__device__ __forceinline__ uint32_t word(uint32_t a, int) { return a; }
__device__ __forceinline__ uint32_t word(const uint2& a, int i) { return i == 0 ? a.x : a.y; }

__device__ __forceinline__ void store1(float* out, int64_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, int64_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_group(float* out, const float (&v)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store_group(__nv_bfloat16* out, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Groups of G elements from `head` on, then the scalar head [0, head) and
// tail [head + G * groups, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const uint8_t* __restrict__ x, T* __restrict__ out, int64_t n,
                 int64_t head, int64_t groups, Consts c) {
  constexpr int G = Group<T>::G;
  using In = typename Group<T>::In;
  const In* src = reinterpret_cast<const In*>(x + head);
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g0 = tid; g0 < groups; g0 += stride * kUnroll) {
    In in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * stride;
      if (g < groups) in[u] = src[g];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * stride;
      if (g >= groups) break;
      const int64_t first = head + g * G;
      const int ch = static_cast<int>(static_cast<uint64_t>(first) % 3u);
      float v[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const uint32_t byte = (word(in[u], k >> 2) >> (8 * (k & 3))) & 0xffu;
        v[k] = normalize1(byte, rotated(c.sub, ch, k % 3), rotated(c.mul, ch, k % 3));
      }
      store_group(out + first, v);
    }
  }
  const int64_t body_end = head + groups * G;
  const int64_t edges = head + (n - body_end);
  for (int64_t e = tid; e < edges; e += stride) {
    const int64_t i = e < head ? e : body_end + (e - head);
    const int ch = static_cast<int>(static_cast<uint64_t>(i) % 3u);
    store1(out, i, normalize1(x[i], rotated(c.sub, ch, 0), rotated(c.mul, ch, 0)));
  }
}

template <typename T>
int launch(const uint8_t* x, T* out, int64_t n, const Consts& c, cudaStream_t stream) {
  constexpr int G = Group<T>::G;
  // first element where the input is G-byte and the output 16-byte aligned
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out);
  int64_t head = n;
  for (int64_t s = 0; s < 16 && s < n; ++s) {
    if ((xa + s) % G == 0 && (oa + s * sizeof(T)) % 16 == 0) {
      head = s;
      break;
    }
  }
  const int64_t groups = (n - head) / G;
  int device = 0, sms = 132;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough threads for every group once kUnroll deep; the edges (< 16 + G
  // elements) fit in the first block
  const int64_t work = groups > 0 ? (groups + kUnroll - 1) / kUnroll : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;  // grid-stride past that
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  normalize_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, out, n, head, groups, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_dtype: 0 float32, 1 bfloat16. Returns 0, a CUDA error code (> 0), or
// -1 for an unsupported dtype.
extern "C" int vimo_fused_normalize(const uint8_t* x, void* out, int64_t n, int out_dtype,
                                    float sub0, float sub1, float sub2,
                                    float mul0, float mul1, float mul2, void* stream) {
  if (n <= 0) return 0;
  const Consts c = {{sub0, sub1, sub2}, {mul0, mul1, mul2}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch(x, static_cast<float*>(out), n, c, s);
  if (out_dtype == 1) return launch(x, static_cast<__nv_bfloat16*>(out), n, c, s);
  return -1;
}

extern "C" const char* vimo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

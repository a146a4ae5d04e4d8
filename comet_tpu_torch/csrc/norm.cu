// K5: LayerNorm over the last axis of [rows, C], bf16 or f32.
//
// Replaces comet_tpu/ops/pallas_norm.py::_ln_kernel. Same function: the
// mean in f32, the variance as the mean of the squared centered values (not
// E[x^2] - mean^2), rsqrt(var + eps), then scale and bias in f32 (each
// optional: none means ones and zeros), written in the input dtype.
//
// What bounds it on the H100: memory. Each element is read once and written
// once for a few FLOPs: bytes = 2 * rows * C * sizeof(dtype).
//
// What the design does about it: one warp per row, eight rows per CTA. The
// row is read once with 16-byte vector loads (8 bf16 or 4 f32 values a
// lane) and held in registers for both passes (mean, then the centered
// variance), so it crosses the memory bus exactly twice, in and out; scale
// and bias come in 16-byte vectors too (L1 and L2 serve them). The
// statistics are warp shuffles; no shared memory. Templated on the number
// of vectors a lane holds, so C up to 1024 (a multiple of 8) stays in
// registers.
#include "mma.cuh"

namespace comet {
namespace {

constexpr int kNormThreads = 256;  // 8 warps, one row each
constexpr int kMaxC = 1024;

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&f)[8]) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// NV: 16-byte vectors a lane holds (C <= 32 * NV * VE).
template <typename T, int NV>
__global__ void __launch_bounds__(kNormThreads) layer_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ y, int rows, int C, float eps) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));  // values per vector
  const int row = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nvec = C / VE;
  const T* xr = x + (long long)row * C;
  T* yr = y + (long long)row * C;

  float v[NV][VE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nvec) {
      load_vec(xr + idx * VE, v[i]);
#pragma unroll
      for (int e = 0; e < VE; ++e) s += v[i][e];
    }
  }
  const float mu = warp_sum(s) / static_cast<float>(C);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        v[i][e] -= mu;
        ss += v[i][e] * v[i][e];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / static_cast<float>(C) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nvec) {
#pragma unroll
      for (int e = 0; e < VE; ++e) v[i][e] *= rstd;
      if (scale != nullptr) {
#pragma unroll
        for (int j = 0; j < VE; j += 4) {
          const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + idx * VE + j));
          const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + idx * VE + j));
          v[i][j] = v[i][j] * sc.x + bi.x;
          v[i][j + 1] = v[i][j + 1] * sc.y + bi.y;
          v[i][j + 2] = v[i][j + 2] * sc.z + bi.z;
          v[i][j + 3] = v[i][j + 3] * sc.w + bi.w;
        }
      }
      store_vec(yr + idx * VE, v[i]);
    }
  }
}

template <typename T, int NV>
int launch_ln(const void* x, const float* scale, const float* bias, void* y, int rows, int C,
              float eps, cudaStream_t stream) {
  const int grid = (rows + kNormThreads / 32 - 1) / (kNormThreads / 32);
  layer_norm_kernel<T, NV><<<grid, kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_ln(const void* x, const float* scale, const float* bias, void* y, int rows, int C,
                float eps, cudaStream_t stream) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  const int nv = (C / VE + 31) / 32;
  switch (nv) {
    case 1: return launch_ln<T, 1>(x, scale, bias, y, rows, C, eps, stream);
    case 2: return launch_ln<T, 2>(x, scale, bias, y, rows, C, eps, stream);
    case 3: return launch_ln<T, 3>(x, scale, bias, y, rows, C, eps, stream);
    case 4: return launch_ln<T, 4>(x, scale, bias, y, rows, C, eps, stream);
    case 5: return launch_ln<T, 5>(x, scale, bias, y, rows, C, eps, stream);
    case 6: return launch_ln<T, 6>(x, scale, bias, y, rows, C, eps, stream);
    case 7: return launch_ln<T, 7>(x, scale, bias, y, rows, C, eps, stream);
    case 8: return launch_ln<T, 8>(x, scale, bias, y, rows, C, eps, stream);
    default: return -1;
  }
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for an unsupported width or dtype, else the CUDA
// error code of the launch. x and y are contiguous [rows, C] of one dtype
// (is_bf16: bf16, else f32); scale and bias are f32 [C], both or neither;
// every pointer is 16-byte aligned.
extern "C" int comet_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                    int rows, int C, int is_bf16, float eps, void* stream) {
  if (C < 8 || C % 8 != 0 || C > comet::kMaxC) return -1;
  if ((scale == nullptr) != (bias == nullptr)) return -1;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return comet::dispatch_ln<comet::bf16>(x, s, b, y, rows, C, eps, st);
  return comet::dispatch_ln<float>(x, s, b, y, rows, C, eps, st);
}

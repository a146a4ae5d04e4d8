// K5: LayerNorm over the last axis of [rows, C], bf16 or f32.
//
// Replaces comet_tpu/ops/pallas_norm.py::_ln_kernel. Same function: the
// mean in f32, the variance as the mean of the squared centered values (not
// E[x^2] - mean^2), rsqrt(var + eps), then scale and bias in f32 (each
// optional: none means ones and zeros), written in the input dtype.
//
// What bounds it on the H100: memory. Each element is read once and written
// once for a few FLOPs: bytes = 2 * rows * C * sizeof(dtype). At the main
// path's shapes (16 to 9,296 rows of 256 to 768 columns, at most 14 MB each
// way) the whole call is one or two memory round trips per row, so what
// counts is that every row's loads are in flight from the start and that no
// CTA waits for a second wave.
//
// The design (ops/norm.py::norm_plan picks the numbers):
// - A group of G = 16 or 32 lanes takes a row, each lane NV 16-byte vectors
//   (8 bf16 or 4 f32 values): 32 lanes where they all hold the same number
//   of vectors, at least two; else 16 (C 256 and 384 in bf16: 2 and 3
//   vectors a lane, none idle; C 768: 32 lanes holding 3). The statistics
//   are shuffles within the group; no shared memory for them.
// - A persistent grid: at most as many CTAs of 256 threads as the card
//   holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), so
//   no CTA runs in a second wave. Group g of CTA b takes rows g * grid + b,
//   then every (256 / G) * grid-th row: consecutive rows go to different
//   CTAs, so a grid of one CTA per SM spreads even a few hundred rows over
//   every SM, and the CTAs' rows differ by at most one step.
// - The next row in flight while the current row is normalised: where the
//   card holds a group for every row at once, each group takes one row and
//   the kernel keeps no second buffer; else a group issues the 16-byte loads
//   of its next row into registers before it reduces the current one. A
//   row stays in registers as it arrived (bf16 pairs) and is unpacked in
//   each pass, and the row loop is not unrolled, so two rows cost 8 NV
//   registers a lane; the launch bounds give NV <= 3 a budget of 64
//   registers (4 CTAs per SM), which ptxas would otherwise undercut with
//   small spills.
// - A warp walks its rows while its first group has one, and a group
//   without a row reduces zeros and stores nothing, so every shuffle has the
//   whole warp and the full mask (a partial mask made ptxas add a slow
//   divergent path, and spills, to every shuffle).
// - Scale and bias are read into shared memory once per CTA (f32, 8 C
//   bytes), after the first row's loads are out, and from there for every
//   row. 1 / C comes from the host, so the row loop has no division.
#include "mma.cuh"

namespace comet {
namespace {

constexpr int kNormThreads = 256;
constexpr int kMaxC = 1024;

template <typename T>
struct Vec {
  static constexpr int VE = 16 / static_cast<int>(sizeof(T));  // values per 16-byte vector
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// Sum over this thread's group of G lanes. Every lane of the warp calls it
// (a group without a row sums zeros), so the shuffles take the full mask.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 16-byte vectors lane, lane + G, ... of a row (zeros past its end, and
// for a group without a row: valid false).
template <typename T, int G, int NV>
__device__ __forceinline__ void load_row(uint4 (&raw)[NV], const T* __restrict__ xr, bool valid,
                                         int lane, int nvec) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + G * i;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (valid && idx < nvec) raw[i] = *reinterpret_cast<const uint4*>(xr + idx * Vec<T>::VE);
  }
}

// Normalises one row held as raw vectors, unpacked in each pass so that no
// second copy of the row occupies registers, and stores it if valid (the
// group has a row). inv_c = 1 / C; sc / bi: the CTA's copy of scale and
// bias in shared memory, or nullptr.
template <typename T, int G, int NV>
__device__ __forceinline__ void normalise_row(const uint4 (&raw)[NV], T* __restrict__ yr,
                                              bool valid, int lane, int nvec, float inv_c,
                                              float eps, const float* sc, const float* bi) {
  constexpr int VE = Vec<T>::VE;
  float f[VE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    unpack(raw[i], f);  // zeros past the row's end
#pragma unroll
    for (int e = 0; e < VE; ++e) s += f[e];
  }
  const float mu = group_sum<G>(s) * inv_c;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + G * i < nvec) {
      unpack(raw[i], f);
#pragma unroll
      for (int e = 0; e < VE; ++e) ss += (f[e] - mu) * (f[e] - mu);
    }
  }
  const float rstd = rsqrtf(group_sum<G>(ss) * inv_c + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + G * i;
    if (valid && idx < nvec) {
      unpack(raw[i], f);
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] = (f[e] - mu) * rstd;
      if (sc != nullptr) {
#pragma unroll
        for (int j = 0; j < VE; j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(sc + idx * VE + j);
          const float4 b = *reinterpret_cast<const float4*>(bi + idx * VE + j);
          f[j] = f[j] * a.x + b.x;
          f[j + 1] = f[j + 1] * a.y + b.y;
          f[j + 2] = f[j + 2] * a.z + b.z;
          f[j + 3] = f[j + 3] * a.w + b.w;
        }
      }
      *reinterpret_cast<uint4*>(yr + idx * VE) = pack(f);
    }
  }
}

// TWO: a group may take more than one row, so it loads the next row's
// vectors into registers before it reduces the current one; without TWO
// each group takes at most one row and holds no second buffer.
template <typename T, int G, int NV, bool TWO>
__global__ void __launch_bounds__(kNormThreads, NV <= 3 ? 4 : 2) layer_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ y, int rows, int C, float inv_c, float eps) {
  extern __shared__ __align__(16) float s_affine[];
  // group g of CTA b takes rows g * grid + b, then every (256 / G) * grid-th;
  // a warp walks while its first group has a row, so its lanes stay together
  const int stride = (kNormThreads / G) * static_cast<int>(gridDim.x);
  const int nvec = C / Vec<T>::VE;
  const int lane = threadIdx.x % G;
  int row = static_cast<int>(threadIdx.x / G * gridDim.x + blockIdx.x);
  int warp_row = static_cast<int>(threadIdx.x / 32 * (32 / G) * gridDim.x + blockIdx.x);
  uint4 cur[NV];
  // the first row's loads go out before the CTA waits for scale and bias
  load_row<T, G, NV>(cur, x + static_cast<long long>(row) * C, row < rows, lane, nvec);
  const float* sc = nullptr;
  if (scale != nullptr) {
    for (int i = threadIdx.x; i < C / 4; i += kNormThreads) {
      reinterpret_cast<float4*>(s_affine)[i] = reinterpret_cast<const float4*>(scale)[i];
      reinterpret_cast<float4*>(s_affine + C)[i] = reinterpret_cast<const float4*>(bias)[i];
    }
    __syncthreads();
    sc = s_affine;
  }
  const float* bi = s_affine + C;
  if constexpr (!TWO) {
    if (warp_row < rows)
      normalise_row<T, G, NV>(cur, y + static_cast<long long>(row) * C, row < rows, lane, nvec,
                              inv_c, eps, sc, bi);
  } else {
#pragma unroll 1
    for (; warp_row < rows; warp_row += stride, row += stride) {
      uint4 nxt[NV];
      load_row<T, G, NV>(nxt, x + static_cast<long long>(row + stride) * C, row + stride < rows,
                         lane, nvec);
      normalise_row<T, G, NV>(cur, y + static_cast<long long>(row) * C, row < rows, lane, nvec,
                              inv_c, eps, sc, bi);
#pragma unroll
      for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
    }
  }
}

template <typename T, int G, int NV, bool TWO>
int launch_ln(const void* x, const float* scale, const float* bias, void* y, int rows, int C,
              float eps, int grid, cudaStream_t stream) {
  layer_norm_kernel<T, G, NV, TWO><<<grid, kNormThreads, scale ? 8 * C : 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, C,
      1.f / static_cast<float>(C), eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int NV, bool TWO>
int resident_ln(int C, int affine) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, layer_norm_kernel<T, G, NV, TWO>,
                                                       kNormThreads, affine ? 8 * C : 0) ==
                 cudaSuccess
             ? n
             : -1;
}

// Calls f.template operator()<G, NV, TWO>() for the plan's group and rows
// per group, and the vectors a lane of the group holds at width C, or
// returns -1 for a plan or width the kernel does not take.
template <typename T, typename F>
int with_instance(int C, int G, int two, F f) {
  if (C < 8 || C % 8 != 0 || C > kMaxC || (G != 16 && G != 32)) return -1;
  const int nv = (C / Vec<T>::VE + G - 1) / G;
#define COMET_LN_CASE(g, n)                                                   \
  if (G == g && nv == n)                                                      \
    return two ? f.template operator()<g, n, true>() : f.template operator()<g, n, false>();
  COMET_LN_CASE(16, 1) COMET_LN_CASE(16, 2) COMET_LN_CASE(16, 3) COMET_LN_CASE(16, 4)
  COMET_LN_CASE(16, 5) COMET_LN_CASE(16, 6) COMET_LN_CASE(16, 7) COMET_LN_CASE(16, 8)
  COMET_LN_CASE(32, 2) COMET_LN_CASE(32, 3) COMET_LN_CASE(32, 4)
  COMET_LN_CASE(32, 5) COMET_LN_CASE(32, 6) COMET_LN_CASE(32, 7) COMET_LN_CASE(32, 8)
#undef COMET_LN_CASE
  return -1;
}

template <typename T>
struct Launch {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  int rows, C;
  float eps;
  int grid;
  cudaStream_t stream;
  template <int G, int NV, bool TWO>
  int operator()() const {
    return launch_ln<T, G, NV, TWO>(x, scale, bias, y, rows, C, eps, grid, stream);
  }
};

template <typename T>
struct Resident {
  int C, affine;
  template <int G, int NV, bool TWO>
  int operator()() const {
    return resident_ln<T, G, NV, TWO>(C, affine);
  }
};

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for a plan, width or dtype the kernel does not
// take, else the CUDA error code of the launch. x and y are contiguous
// [rows, C] of one dtype (is_bf16: bf16, else f32); scale and bias are f32
// [C], both or neither; every pointer is 16-byte aligned. group (lanes per
// row, 16 or 32), two (whether a group may take more than one row) and grid
// come from ops/norm.py::norm_plan.
extern "C" int comet_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                    int rows, int C, int is_bf16, float eps, int group, int two,
                                    int grid, void* stream) {
  if ((scale == nullptr) != (bias == nullptr) || grid < 1 || grid > rows) return -1;
  // without two, every row must have a group of its own
  if (!two && static_cast<long long>(grid) * (comet::kNormThreads / (group > 0 ? group : 1)) < rows)
    return -1;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return comet::with_instance<comet::bf16>(
        C, group, two, comet::Launch<comet::bf16>{x, s, b, y, rows, C, eps, grid, st});
  return comet::with_instance<float>(C, group, two,
                                     comet::Launch<float>{x, s, b, y, rows, C, eps, grid, st});
}

// How many CTAs of the kernel for (C, dtype, group, two, affine) one SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
extern "C" int comet_layer_norm_resident(int C, int is_bf16, int group, int two, int affine) {
  if (is_bf16)
    return comet::with_instance<comet::bf16>(C, group, two,
                                             comet::Resident<comet::bf16>{C, affine});
  return comet::with_instance<float>(C, group, two, comet::Resident<float>{C, affine});
}

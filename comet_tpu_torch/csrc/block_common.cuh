// Pieces shared by the whole-block kernels K2 (block.cu) and K4
// (cross_block.cu): a CTA of 8 warps owns 64 rows in shared memory, streams
// each weight through a two-stage cp.async ring of 32-column k-slices, and
// multiplies on bf16 mma.sync with f32 accumulators.
//
// Rounding points are the TPU kernels' own: LayerNorms take f32 statistics
// and write bf16; each product is rounded to bf16 before its bias add, and
// the sum is rounded again; GELU is the tanh form on bf16 values.
#pragma once

#include "mma.cuh"

namespace comet {
namespace {

constexpr int kRows = 64;      // rows per CTA
constexpr int kThreads = 256;  // 8 warps: 4 row tiles x 2 column halves
constexpr int kKC = 32;        // k-slice of a streamed weight tile
constexpr int kLDW = kKC + 8;  // padded row of a weight tile
constexpr int kHC = 128;       // hidden chunk of the MLP
constexpr int kLDH = kHC + 8;

// acc[16 x NT*8 per warp] += A[64 x K] W^T, with A in shared memory (row
// stride lda) and W a row-major [N, K] weight in global memory whose row n
// lives at global row seg[n / seg_len] + n % seg_len (column offset already
// applied to W). N = 16 * NT: warp (wm, wn) owns rows 16*wm and columns
// wn*NT*8 .. +NT*8.
template <int NT>
__device__ __forceinline__ void gemm_awt(const bf16* sA, int lda, int K, const bf16* __restrict__ W,
                                         int ldw, int seg_len, int seg0, int seg1, int seg2,
                                         bf16* sW, float (&acc)[NT][4]) {
  constexpr int N = NT * 16;
  constexpr int CPR = kKC / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int nslices = K / kKC;
  auto load = [&](int slice, int stage) {
    bf16* dst = sW + stage * N * kLDW;
    for (int i = tid; i < N * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int sg = r / seg_len;
      const int grow = (sg == 0 ? seg0 : (sg == 1 ? seg1 : seg2)) + r % seg_len;
      cp_async16(dst + r * kLDW + c, W + (long long)grow * ldw + slice * kKC + c, true);
    }
  };
  load(0, 0);
  cp_async_commit();
  for (int sl = 0; sl < nslices; ++sl) {
    if (sl + 1 < nslices) {
      load(sl + 1, (sl + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ws = sW + (sl & 1) * N * kLDW + (wn * NT * 8) * kLDW;
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sA + (wm * 16 + (lane & 15)) * lda + sl * kKC + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, ws + (p * 16 + (lane & 7) + (lane >> 4) * 8) * kLDW + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
      if (NT & 1) {
        uint32_t b[2];
        ldmatrix_x2(b, ws + ((NT - 1) * 8 + (lane & 7)) * kLDW + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[NT - 1], a, b[0], b[1]);
      }
    }
    __syncthreads();
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Scale-free LayerNorm (eps 1e-6, f32 statistics) of 64 rows of width C,
// from src to dst in shared memory (dst may equal src). One warp per 8 rows.
template <int C>
__device__ __forceinline__ void layer_norm_rows(const bf16* src, bf16* dst, int ld) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = __bfloat162float(src[r * ld + lane + 32 * i]);
      s += v[i];
    }
    const float mu = warp_sum(s) * (1.f / C);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] -= mu;
      ss += v[i] * v[i];
    }
    const float rstd = rsqrtf(warp_sum(ss) * (1.f / C) + 1e-6f);
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[r * ld + lane + 32 * i] = __float2bfloat16(v[i] * rstd);
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

// The second half of a block, the same in K2 and K4. On entry sX holds the
// normalized input xn and sA the attention output a (both 64 x C, row
// stride C + 8). x1 = xn + (round(a Wout^T) + bout) goes to sX, ln2(x1) to
// sA, then out = x1 + mlp(ln2(x1)) is written for the rows below `rows`.
// sH (64 x kLDH) holds one MLP hidden chunk; the fc2 accumulators stay in
// registers across chunks.
template <int C>
__device__ __forceinline__ void block_tail(bf16* sX, bf16* sA, bf16* sW, bf16* sH,
                                           const bf16* __restrict__ wout,
                                           const bf16* __restrict__ bout,
                                           const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                                           const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                                           bf16* __restrict__ out, int row0, int rows, int hidden) {
  constexpr int LDX = C + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  // x1 = ln1(x) + (round(a Wout^T) + bout), in place in sX.
  {
    constexpr int NT = C / 16;
    float acc[NT][4];
    zero_acc(acc);
    gemm_awt<NT>(sA, LDX, C, wout, C, C, 0, 0, 0, sW, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn * NT * 8 + j * 8 + t2;
      const float bb0 = __bfloat162float(bout[n]), bb1 = __bfloat162float(bout[n + 1]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wm * 16 + g + hr * 8;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(sX + r * LDX + n);
        const float2 xn = __bfloat1622float2(*p);
        const float y0 = round_bf16(round_bf16(acc[j][2 * hr]) + bb0);
        const float y1 = round_bf16(round_bf16(acc[j][2 * hr + 1]) + bb1);
        *p = __floats2bfloat162_rn(xn.x + y0, xn.y + y1);
      }
    }
  }
  __syncthreads();
  layer_norm_rows<C>(sX, sA, LDX);
  __syncthreads();

  // MLP over hidden chunks; fc2 accumulates in registers across chunks.
  constexpr int NT2 = C / 16;
  float acc2[NT2][4];
  zero_acc(acc2);
  for (int c0 = 0; c0 < hidden; c0 += kHC) {
    {
      constexpr int NT1 = kHC / 16;
      float acc1[NT1][4];
      zero_acc(acc1);
      gemm_awt<NT1>(sA, LDX, C, w1, C, kHC, c0, 0, 0, sW, acc1);
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int n = wn * NT1 * 8 + j * 8 + t2;
        const float bb0 = __bfloat162float(b1[c0 + n]), bb1 = __bfloat162float(b1[c0 + n + 1]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm * 16 + g + hr * 8;
          const float h0 = round_bf16(round_bf16(acc1[j][2 * hr]) + bb0);
          const float h1 = round_bf16(round_bf16(acc1[j][2 * hr + 1]) + bb1);
          *reinterpret_cast<__nv_bfloat162*>(sH + r * kLDH + n) =
              __floats2bfloat162_rn(gelu_tanh(h0), gelu_tanh(h1));
        }
      }
    }
    __syncthreads();
    gemm_awt<NT2>(sH, kLDH, kHC, w2 + c0, hidden, C, 0, 0, 0, sW, acc2);
  }

  // out = x1 + (round(h W2^T) + b2)
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    const int n = wn * NT2 * 8 + j * 8 + t2;
    const float bb0 = __bfloat162float(b2[n]), bb1 = __bfloat162float(b2[n + 1]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * 16 + g + hr * 8;
      if (row0 + r < rows) {
        const float2 x1 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sX + r * LDX + n));
        const float y0 = round_bf16(round_bf16(acc2[j][2 * hr]) + bb0);
        const float y1 = round_bf16(round_bf16(acc2[j][2 * hr + 1]) + bb1);
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + r) * C + n) =
            __floats2bfloat162_rn(x1.x + y0, x1.y + y1);
      }
    }
  }
}

}  // namespace
}  // namespace comet

// K2: one whole AttnBlock (LN -> qkv -> attention -> out-proj -> residual ->
// LN -> MLP -> residual) over many short sequences, in one launch.
//
// Replaces comet_tpu/ops/pallas_block.py::_fused_kernel (with its helpers
// _lane_packed_attend and pallas_attn.py::_heads_attend). Same function and
// the same bf16 rounding points as the TPU kernel: LayerNorms are scale-free
// with eps 1e-6 and f32 statistics; each matmul accumulates in f32 and is
// rounded to bf16 before its bias add; attention logits and softmax are f32
// with a plain per-(sequence, head) softmax (the TPU's lane packing and its
// 1e-30 denominator clamp were layout devices of that chip); GELU is the tanh
// form on bf16 values; the residual stream is re-based on the normalized
// input: x1 = ln1(x) + attn(ln1(x)); out = x1 + mlp(ln2(x1)).
//
// What bounds it on the H100: the matmuls. Per row it does 2*C*(3C + C + 8C)
// FLOPs (33 GFLOP for the coarse time block's 9216 rows at C 384) against
// 4*C bytes of activations in and out, so it is bound by tensor-core
// operations as long as the weights (3.5 MB bf16 at C 384) come from L2.
//
// What the design does about it: one CTA of 8 warps takes 64 rows (whole
// sequences: 4 of 16 or 1 of 64) and keeps every intermediate on chip; only
// x is read and the block's output written. The weights stream through L2
// into a two-stage cp.async ring in shared memory in 32-column k-slices; all
// products run on bf16 mma.sync with f32 accumulators. Attention is done one
// head at a time (q, k, v of one head: 64 x 3D) and the MLP one 128-column
// hidden chunk at a time, with the fc2 accumulators held in registers across
// chunks, so the working set fits the 227 KB of shared memory.
#include <cmath>

#include "mma.cuh"

namespace comet {
namespace {

constexpr int kRows = 64;      // rows per CTA
constexpr int kThreads = 256;  // 8 warps: 4 row tiles x 2 column halves
constexpr int kKC = 32;        // k-slice of a streamed weight tile
constexpr int kLDW = kKC + 8;  // padded row of a weight tile
constexpr int kHC = 128;       // hidden chunk of the MLP
constexpr int kLDH = kHC + 8;

template <int C, int D>
struct BlockSmem {
  static constexpr int LDX = C + 8;
  static constexpr int LDQ = D + 8;
  static constexpr int x_elems = kRows * LDX;          // x -> ln1(x) -> x1
  static constexpr int a_elems = kRows * LDX;          // attention out -> ln2(x1)
  static constexpr int w_elems = 2 * C * kLDW;         // weight ring, N <= C rows
  static constexpr int qkv_elems = 3 * kRows * LDQ;    // q, k, v of one head
  static constexpr int h_elems = kRows * kLDH;         // one MLP hidden chunk
  static constexpr int u_elems = qkv_elems > h_elems ? qkv_elems : h_elems;
  static constexpr int bytes =
      (x_elems + a_elems + w_elems + u_elems) * static_cast<int>(sizeof(bf16));
};

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

template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1) attn_block_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
    const bf16* __restrict__ wout, const bf16* __restrict__ bout, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int rows, int L, int hidden, float scale) {
  using S = BlockSmem<C, D>;
  constexpr int H = C / D;
  constexpr int LDX = S::LDX, LDQ = S::LDQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);
  bf16* sA = sX + S::x_elems;
  bf16* sW = sA + S::a_elems;
  bf16* sU = sW + S::w_elems;  // q/k/v of one head, later one MLP hidden chunk
  bf16* sQ = sU;
  bf16* sK = sU + kRows * LDQ;
  bf16* sV = sU + 2 * kRows * LDQ;
  bf16* sH = sU;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int row0 = blockIdx.x * kRows;
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  // x -> sX (rows past the end are zero), then ln1 in place.
  for (int i = tid; i < kRows * (C / 8); i += kThreads) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(sX + r * LDX + c, x + (ok ? (long long)(row0 + r) * C : 0) + c, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows<C>(sX, sX, LDX);
  __syncthreads();

  // Attention, one head at a time; the result goes to sA[:, h*D:(h+1)*D].
  for (int h = 0; h < H; ++h) {
    {
      constexpr int NT = 3 * D / 16;
      float acc[NT][4];
      zero_acc(acc);
      gemm_awt<NT>(sX, LDX, C, wqkv, C, D, h * D, C + h * D, 2 * C + h * D, sW, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * NT * 8 + j * 8 + t2;
        const int which = n / D, d = n % D;
        const float bb0 = __bfloat162float(bqkv[which * C + h * D + d]);
        const float bb1 = __bfloat162float(bqkv[which * C + h * D + d + 1]);
        bf16* dst = sU + which * kRows * LDQ + d;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm * 16 + g + hr * 8;
          *reinterpret_cast<__nv_bfloat162*>(dst + r * LDQ) = __floats2bfloat162_rn(
              round_bf16(acc[j][2 * hr]) + bb0, round_bf16(acc[j][2 * hr + 1]) + bb1);
        }
      }
    }
    __syncthreads();
    if (warp < 4) {
      // Warp w: query rows 16w..16w+15 against the keys of their sequences.
      const int lr = L > 16 ? L : 16;  // key span that covers the 16 rows
      const int ks = (warp * 16 / lr) * lr;
      const int nkt = lr / 8;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (2 * p < nkt) {
            uint32_t b[4];
            ldmatrix_x4(b, sK + (ks + p * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kk * 16 +
                               ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * p], a, b[0], b[1]);
            mma_bf16(s[2 * p + 1], a, b[2], b[3]);
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ks + j * 8 + t2 + (e & 1);
          const int qrow = warp * 16 + g + (e >> 1) * 8;
          const bool ok = j < nkt && key / L == qrow / L;
          s[j][e] = ok ? s[j][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
      }
      const float inv0 = 1.f / quad_sum(sum[0]);
      const float inv1 = 1.f / quad_sum(sum[1]);
      float o[D / 8][4];
      zero_acc(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (2 * kk < nkt) {
          uint32_t pa[4];
          pa[0] = pack_bf16(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
          pa[1] = pack_bf16(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
          pa[2] = pack_bf16(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
          pa[3] = pack_bf16(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, sV + (ks + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ +
                                     dp * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dp], pa, b[0], b[1]);
            mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        bf16* dst = sA + h * D + j * 8 + t2;
        const int r = warp * 16 + g;
        *reinterpret_cast<__nv_bfloat162*>(dst + r * LDX) =
            __floats2bfloat162_rn(o[j][0], o[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * LDX) =
            __floats2bfloat162_rn(o[j][2], o[j][3]);
      }
    }
    __syncthreads();
  }

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
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sX + r * LDX + n));
        const float y0 = round_bf16(round_bf16(acc2[j][2 * hr]) + bb0);
        const float y1 = round_bf16(round_bf16(acc2[j][2 * hr + 1]) + bb1);
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + r) * C + n) =
            __floats2bfloat162_rn(x1.x + y0, x1.y + y1);
      }
    }
  }
}

template <int C, int D>
int launch_block(const bf16* x, const bf16* wqkv, const bf16* bqkv, const bf16* wout,
                 const bf16* bout, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                 bf16* out, int rows, int L, int hidden, cudaStream_t stream) {
  constexpr int smem = BlockSmem<C, D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_block_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int grid = (rows + kRows - 1) / kRows;
  attn_block_kernel<C, D><<<grid, kThreads, smem, stream>>>(
      x, wqkv, bqkv, wout, bout, w1, b1, w2, b2, out, rows, L, hidden,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for an unsupported (C, H, L, hidden), else the
// CUDA error code of the launch. x and out are contiguous [rows, C]; weights
// are in the [out_features, in_features] layout: wqkv [3C, C], wout [C, C],
// w1 [hidden, C], w2 [C, hidden].
extern "C" int comet_attn_block_fwd(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wout, const void* bout, const void* w1,
                                    const void* b1, const void* w2, const void* b2, void* out,
                                    int rows, int L, int C, int H, int hidden, void* stream) {
  using comet::bf16;
  if (L < 1 || 64 % L != 0 || hidden % 128 != 0) return -1;
  const bf16* a[9] = {static_cast<const bf16*>(x),    static_cast<const bf16*>(wqkv),
                      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wout),
                      static_cast<const bf16*>(bout), static_cast<const bf16*>(w1),
                      static_cast<const bf16*>(b1),   static_cast<const bf16*>(w2),
                      static_cast<const bf16*>(b2)};
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 384 && H == 8)
    return comet::launch_block<384, 48>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o,
                                        rows, L, hidden, s);
  if (C == 256 && H == 8)
    return comet::launch_block<256, 32>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o,
                                        rows, L, hidden, s);
  return -1;
}

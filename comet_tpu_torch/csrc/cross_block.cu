// K4: one whole CrossAttnBlock (scale-free LN on x, affine LN on the
// context, q and packed-kv projections, cross-attention, out-projection plus
// the normalized-query residual, LN, MLP, residual), as two launches that
// together are one kernel.
//
// Replaces comet_tpu/ops/pallas_block.py::_cross_kernel (spec
// _cross_reference, inner loop pallas_attn.py::_heads_attend). Same function
// and the same bf16 rounding points as the TPU kernel: the context LN is
// rounded to bf16 before its affine, and the affine runs in bf16
// (cn = round(round(ln(ctx) * gamma) + beta)); each product is rounded to
// bf16 before its bias add; logits and softmax are f32 with the scale on the
// f32 logits; the residual is re-based on the normalized query; GELU is the
// tanh form on bf16 values.
//
// What bounds it on the H100: the matmuls. FLOPs = 2C*(Rq*(2C + 2*hidden) +
// Rk*2C) + 4*Rq*Lk*C for Rq = B*Lq query rows and Rk = B*Lk context rows,
// against 2*(2*Rq*C + Rk*C + 4C^2 + 2C*hidden) bytes.
//
// What the design does about it: one sequence's normalized context (512 x
// 384 bf16 = 384 KB for virtual<-point) does not fit the 227 KB of shared
// memory, so the kernel runs in two launches on one stream:
//  1. cross_kv_kernel: LN_ctx with its affine, then the kv projection, over
//     64-row tiles of all context rows; K and V go to a bf16 [Rk, 2C]
//     scratch in global memory (the TPU kernel's own rounding point). This
//     also keeps point<-virtual from recomputing one sequence's 64-row kv
//     projection in each of its 8 query CTAs.
//  2. cross_block_kernel: per 64 query rows, K2's layout and weight ring
//     (block_common.cuh): LN1, the q projection one head at a time,
//     attention over 64-key K/V tiles streamed through a two-stage cp.async
//     ring with an online f32 softmax, then K2's tail (out-projection plus
//     residual, LN2, MLP, residual).
// All products run on bf16 mma.sync m16n8k16 with f32 accumulators.
#include <cmath>

#include "block_common.cuh"

namespace comet {
namespace {

constexpr int kBK = 64;  // keys per K/V tile

// ---- launch 1: LN_ctx (affine) + kv projection ----------------------------

template <int C>
constexpr int kv_smem_bytes() {
  return (kRows * (C + 8) + 2 * C * kLDW) * static_cast<int>(sizeof(bf16));
}

// grid (ceil(Rk / 64), 2): blockIdx.y = 0 writes K, 1 writes V.
template <int C>
__global__ void __launch_bounds__(kThreads, 1) cross_kv_kernel(
    const bf16* __restrict__ ctx, const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
    const bf16* __restrict__ wkv, const bf16* __restrict__ bkv, bf16* __restrict__ kv, int rk) {
  constexpr int LDX = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sX + kRows * LDX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int row0 = blockIdx.x * kRows;
  const int which = blockIdx.y;

  for (int i = tid; i < kRows * (C / 8); i += kThreads) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    const bool ok = row0 + r < rk;
    cp_async16(sX + r * LDX + c, ctx + (ok ? (long long)(row0 + r) * C : 0) + c, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows<C>(sX, sX, LDX);
  __syncthreads();
  // the affine in bf16, as the TPU kernel: round(round(ln * gamma) + beta)
  for (int i = tid; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const float y = round_bf16(__bfloat162float(sX[r * LDX + c]) * __bfloat162float(gamma[c]));
    sX[r * LDX + c] = __float2bfloat16(y + __bfloat162float(beta[c]));
  }
  __syncthreads();

  constexpr int NT = C / 16;
  float acc[NT][4];
  zero_acc(acc);
  gemm_awt<NT>(sX, LDX, C, wkv, C, C, which * C, 0, 0, sW, acc);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = wn * NT * 8 + j * 8 + t2;
    const float bb0 = __bfloat162float(bkv[which * C + n]);
    const float bb1 = __bfloat162float(bkv[which * C + n + 1]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * 16 + g + hr * 8;
      if (row0 + r < rk)
        *reinterpret_cast<__nv_bfloat162*>(kv + (long long)(row0 + r) * 2 * C + which * C + n) =
            __floats2bfloat162_rn(round_bf16(acc[j][2 * hr]) + bb0,
                                  round_bf16(acc[j][2 * hr + 1]) + bb1);
    }
  }
}

// ---- launch 2: the query side and the rest of the block --------------------

template <int C, int D>
struct CrossSmem {
  static constexpr int LDX = C + 8;
  static constexpr int LDQ = D + 8;
  static constexpr int x_elems = kRows * LDX;           // x -> ln1(x) -> x1
  static constexpr int a_elems = kRows * LDX;           // attention out -> ln2(x1)
  static constexpr int w_elems = 2 * C * kLDW;          // weight ring, N <= C rows
  static constexpr int att_elems = (kRows + 4 * kBK) * LDQ;  // q of one head, K/V ring
  static constexpr int h_elems = kRows * kLDH;          // one MLP hidden chunk
  static constexpr int u_elems = att_elems > h_elems ? att_elems : h_elems;
  static constexpr int bytes =
      (x_elems + a_elems + w_elems + u_elems) * static_cast<int>(sizeof(bf16));
};

template <int C, int D>
__global__ void __launch_bounds__(kThreads, 1) cross_block_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ kv, const bf16* __restrict__ wq,
    const bf16* __restrict__ bq, const bf16* __restrict__ wout, const bf16* __restrict__ bout,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out, int rows, int Lq, int Lk, int hidden,
    float scale_log2) {
  using S = CrossSmem<C, D>;
  constexpr int H = C / D;
  constexpr int LDX = S::LDX, LDQ = S::LDQ;
  constexpr int CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);
  bf16* sA = sX + S::x_elems;
  bf16* sW = sA + S::a_elems;
  bf16* sU = sW + S::w_elems;  // q of one head and the K/V ring, later an MLP chunk
  bf16* sQ = sU;
  bf16* sK = sQ + kRows * LDQ;  // [2][kBK][LDQ]
  bf16* sV = sK + 2 * kBK * LDQ;
  bf16* sH = sU;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int row0 = blockIdx.x * kRows;
  const int ntiles = (Lk + kBK - 1) / kBK;
  const int seq_first = row0 / Lq;
  const int seq_last = ((row0 + kRows < rows ? row0 + kRows : rows) - 1) / Lq;

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

  for (int h = 0; h < H; ++h) {
    // q of head h: round(ln1(x) Wq_h^T) + bq_h -> sQ
    {
      constexpr int NT = D / 16;
      float acc[NT][4];
      zero_acc(acc);
      gemm_awt<NT>(sX, LDX, C, wq, C, D, h * D, 0, 0, sW, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * NT * 8 + j * 8 + t2;
        const float bb0 = __bfloat162float(bq[h * D + n]);
        const float bb1 = __bfloat162float(bq[h * D + n + 1]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm * 16 + g + hr * 8;
          *reinterpret_cast<__nv_bfloat162*>(sQ + r * LDQ + n) = __floats2bfloat162_rn(
              round_bf16(acc[j][2 * hr]) + bb0, round_bf16(acc[j][2 * hr + 1]) + bb1);
        }
      }
    }
    __syncthreads();

    // The CTA's rows cover one sequence or a few whole ones (Lq % 16 == 0,
    // so each warp's 16 rows lie in one). For each sequence the whole CTA
    // streams its K/V tiles; the warps whose rows belong to it attend.
    for (int seq = seq_first; seq <= seq_last; ++seq) {
      const int wrow = row0 + warp * 16;
      const bool active = warp < 4 && wrow < rows && wrow / Lq == seq;
      const bf16* kg = kv + (long long)seq * Lk * 2 * C + h * D;
      const bf16* vg = kg + C;
      auto load_kv = [&](int tile, int stage) {
        bf16* dk = sK + stage * kBK * LDQ;
        bf16* dv = sV + stage * kBK * LDQ;
        for (int i = tid; i < kBK * CPR; i += kThreads) {
          const int r = i / CPR, c = (i % CPR) * 8;
          const int key = tile * kBK + r;
          const bool ok = key < Lk;
          const long long off = ok ? (long long)key * 2 * C : 0;
          cp_async16(dk + r * LDQ + c, kg + off + c, ok);
          cp_async16(dv + r * LDQ + c, vg + off + c, ok);
        }
      };
      load_kv(0, 0);
      cp_async_commit();

      uint32_t qf[D / 16][4];
      if (active) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
      }
      float o[D / 8][4];
      zero_acc(o);
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};

      for (int t = 0; t < ntiles; ++t) {
        if (t + 1 < ntiles) {
          load_kv(t + 1, (t + 1) & 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
          const bf16* cK = sK + (t & 1) * kBK * LDQ;
          const bf16* cV = sV + (t & 1) * kBK * LDQ;
          float s[8][4];
          zero_acc(s);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              uint32_t bk[4];
              ldmatrix_x4(bk, cK + (p * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
              mma_bf16(s[2 * p], qf[kk], bk[0], bk[1]);
              mma_bf16(s[2 * p + 1], qf[kk], bk[2], bk[3]);
            }
          }
          // online softmax in the log2 domain; keys past Lk get -inf
          float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = t * kBK + j * 8 + t2 + (e & 1);
              s[j][e] = key < Lk ? s[j][e] * scale_log2 : -INFINITY;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
            }
          }
          float alpha[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = quad_max(mx[r]);
            alpha[r] = exp2f(m_run[r] - mx[r]);
            m_run[r] = mx[r];
            l_run[r] *= alpha[r];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[j][e] = exp2f(s[j][e] - m_run[e >> 1]);
              l_run[e >> 1] += s[j][e];
            }
          }
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
              uint32_t bv[4];
              ldmatrix_x4_trans(bv, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDQ +
                                        dp * 16 + (lane >> 4) * 8);
              mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
              mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
            }
          }
        }
        __syncthreads();
      }

      if (active) {
        const float inv0 = 1.f / quad_sum(l_run[0]);
        const float inv1 = 1.f / quad_sum(l_run[1]);
        const int r = warp * 16 + g;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          bf16* dst = sA + h * D + j * 8 + t2;
          *reinterpret_cast<__nv_bfloat162*>(dst + r * LDX) =
              __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
          *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * LDX) =
              __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
        }
      }
    }
    __syncthreads();
  }

  block_tail<C>(sX, sA, sW, sH, wout, bout, w1, b1, w2, b2, out, row0, rows, hidden);
}

template <int C, int D>
int launch_cross(const bf16* x, const bf16* ctx, const bf16* gamma, const bf16* beta,
                 const bf16* wq, const bf16* bq, const bf16* wkv, const bf16* bkv,
                 const bf16* wout, const bf16* bout, const bf16* w1, const bf16* b1,
                 const bf16* w2, const bf16* b2, bf16* kv, bf16* out, int B, int Lq, int Lk,
                 int hidden, cudaStream_t stream) {
  constexpr int smem_kv = kv_smem_bytes<C>();
  constexpr int smem_q = CrossSmem<C, D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_kv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        cross_block_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int rk = B * Lk, rq = B * Lq;
  cross_kv_kernel<C><<<dim3((rk + kRows - 1) / kRows, 2), kThreads, smem_kv, stream>>>(
      ctx, gamma, beta, wkv, bkv, kv, rk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cross_block_kernel<C, D><<<(rq + kRows - 1) / kRows, kThreads, smem_q, stream>>>(
      x, kv, wq, bq, wout, bout, w1, b1, w2, b2, out, rq, Lq, Lk, hidden,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for an unsupported (C, H, Lq, hidden), else the
// CUDA error code of a launch. x and out are contiguous [B*Lq, C], ctx is
// contiguous [B*Lk, C]; kv is a [B*Lk, 2C] bf16 scratch; weights are in the
// [out_features, in_features] layout: wq [C, C], wkv [2C, C], wout [C, C],
// w1 [hidden, C], w2 [C, hidden]; gamma, beta and every bias are bf16.
extern "C" int comet_cross_block_fwd(const void* x, const void* ctx, const void* gamma,
                                     const void* beta, const void* wq, const void* bq,
                                     const void* wkv, const void* bkv, const void* wout,
                                     const void* bout, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* kv, void* out, int B,
                                     int Lq, int Lk, int C, int H, int hidden, void* stream) {
  using comet::bf16;
  if (Lq < 1 || Lq % 16 != 0 || Lk < 1 || hidden % 128 != 0) return -1;
  const bf16* a[14] = {
      static_cast<const bf16*>(x),    static_cast<const bf16*>(ctx),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<const bf16*>(wq),   static_cast<const bf16*>(bq),
      static_cast<const bf16*>(wkv),  static_cast<const bf16*>(bkv),
      static_cast<const bf16*>(wout), static_cast<const bf16*>(bout),
      static_cast<const bf16*>(w1),   static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2),   static_cast<const bf16*>(b2)};
  bf16* k = static_cast<bf16*>(kv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 384 && H == 8)
    return comet::launch_cross<384, 48>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8],
                                        a[9], a[10], a[11], a[12], a[13], k, o, B, Lq, Lk, hidden,
                                        s);
  if (C == 256 && H == 8)
    return comet::launch_cross<256, 32>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8],
                                        a[9], a[10], a[11], a[12], a[13], k, o, B, Lq, Lk, hidden,
                                        s);
  return -1;
}

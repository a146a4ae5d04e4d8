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

#include "block_common.cuh"

namespace comet {
namespace {

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

  block_tail<C>(sX, sA, sW, sH, wout, bout, w1, b1, w2, b2, out, row0, rows, hidden);
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

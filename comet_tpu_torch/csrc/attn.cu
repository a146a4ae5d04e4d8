// K1: multi-head attention forward on the [B, L, H*D] projection layout.
//
// Replaces comet_tpu/ops/pallas_attn.py::_blocked_kernel (the TPU kernel that
// serves the ViT, the camera aggregator and the update-former's cross
// attention). Same function: out[b, q, h*D:(h+1)*D] = softmax(scale *
// Q_h K_h^T) V_h with f32 logits and softmax, keys past Lk masked, output in
// bf16 in the input layout.
//
// What bounds it on the H100: at the main path's shapes (Lk 16..577, D 32..96)
// the logits are 4*Lk*D FLOPs per query row against 4*D bytes of Q and O, so
// with Lk >= 128 the work is bound by tensor-core operations, and the short
// calls (trunk, point<-virtual) by launch and memory latency.
//
// What the design does about it: FlashAttention-style tiling. One CTA of 4
// warps takes one (batch, head, 64-query tile); each warp owns 16 query rows.
// Q, K and V are read straight from the projection layout by column slice
// (row and batch strides are arguments, so slices of a packed qkv tensor need
// no copy). K/V tiles of 64 keys stream through a two-stage cp.async ring in
// shared memory; QK^T and PV run on bf16 mma.sync with f32 accumulators; the
// softmax is online in f32 registers, so the [Lq, Lk] logits never exist in
// memory. The ragged Lk tail is masked in registers (zero-filled loads, -inf
// logits), never padded with copies. Rows are padded by 8 elements in shared
// memory so ldmatrix reads are free of bank conflicts.
#include "mma.cuh"

namespace comet {
namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows

template <int D>
constexpr int attn_smem_bytes() {
  return (kBQ + 4 * kBK) * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int Lq, int Lk, int C, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale_log2) {
  constexpr int LDS = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int KS = D / 16;  // k16 steps over the head dimension
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LDS;  // [2][kBK][LDS]
  bf16* sV = sK + 2 * kBK * LDS;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qg = q + b * q_bs + h * D;
  const bf16* kg = k + b * k_bs + h * D;
  const bf16* vg = v + b * v_bs + h * D;
  const int q0 = qt * kBQ;
  const int ntiles = (Lk + kBK - 1) / kBK;

  for (int i = tid; i < kBQ * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = q0 + r < Lq;
    cp_async16(sQ + r * LDS + c, qg + (ok ? (long long)(q0 + r) * q_rs : 0) + c, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    bf16* dk = sK + stage * kBK * LDS;
    bf16* dv = sV + stage * kBK * LDS;
    for (int i = tid; i < kBK * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int key = tile * kBK + r;
      const bool ok = key < Lk;
      cp_async16(dk + r * LDS + c, kg + (ok ? (long long)key * k_rs : 0) + c, ok);
      cp_async16(dv + r * LDS + c, vg + (ok ? (long long)key * v_rs : 0) + c, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
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
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* cK = sK + (t & 1) * kBK * LDS;
    const bf16* cV = sV + (t & 1) * kBK * LDS;

    // S = Q K^T for this warp's 16 rows against 64 keys (8 tiles of 8).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bk[4];
        ldmatrix_x4(bk, cK + (p * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * p + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // Online softmax in the log2 domain; masked keys get -inf.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * kBK + j * 8 + (lane & 3) * 2 + (e & 1);
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
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V; P is reused from the S accumulators as A fragments.
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
        ldmatrix_x4_trans(bv, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  const float inv0 = 1.f / quad_sum(l_run[0]);
  const float inv1 = 1.f / quad_sum(l_run[1]);
  const int r0 = q0 + warp * 16 + (lane >> 2);
  bf16* og = o + (long long)b * Lq * C + h * D + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r0 * C + j * 8) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r0 + 8 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)(r0 + 8) * C + j * 8) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int D>
int launch_attn(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Lq,
                int Lk, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                long long v_bs, long long v_rs, float scale, cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Lq, Lk, H * D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for an unsupported head dimension, else the CUDA
// error code of the launch. Strides are in elements; the output is a
// contiguous [B, Lq, H*D] tensor.
extern "C" int comet_attn_fwd(const void* q, const void* k, const void* v, void* o, int B,
                              int H, int D, int Lq, int Lk, long long q_bs, long long q_rs,
                              long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                              float scale, void* stream) {
  using comet::bf16;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return comet::launch_attn<32>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs,
                                    v_rs, scale, s);
    case 48:
      return comet::launch_attn<48>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs,
                                    v_rs, scale, s);
    case 64:
      return comet::launch_attn<64>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs,
                                    v_rs, scale, s);
    case 96:
      return comet::launch_attn<96>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs, v_bs,
                                    v_rs, scale, s);
    default:
      return -1;
  }
}

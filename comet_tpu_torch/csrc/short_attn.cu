// K3: multi-head attention over many short sequences (Lq, Lk <= 64) on the
// [B, L, H*D] projection layout.
//
// Replaces comet_tpu/ops/pallas_attn.py::_packed_kernel (with its inner loop
// _heads_attend). Same function, per sequence and head: logits Q_h K_h^T in
// f32, times scale on the f32 logits, f32 softmax, the weights rounded to
// bf16, P V accumulated in f32 and rounded to bf16.
//
// What bounds it on the H100: memory. At L = 16 one (sequence, head) pair
// reads 3*16*D and writes 16*D bf16 values for 4*16*16*D FLOPs, about 8
// FLOPs per byte against the card's ~295, so the bound is the bytes:
// 2*(3*B*L*C + B*L*C).
//
// What the design does about it: the TPU kernel packed 512/L sequences
// under a block-diagonal mask because its matrix unit wanted 512-wide dots;
// here each (sequence, head) pair is computed directly, with no mask and no
// padding copies. A CTA of 4 warps holds up to 4 pairs: warp w takes 16
// query rows of one pair (one m16 tile covers all the queries at L <= 16;
// at L = 64 four warps share one pair's K and V). Q, K and V are read once
// by column slice of the packed projection, with row and batch strides as
// arguments, into shared memory with cp.async (zero fill past L); QK^T and
// PV run on bf16 mma.sync m16n8k16 with f32 accumulators, and the whole
// row of <= 64 logits stays in registers, so the softmax is exact, not
// online. Thousands of small CTAs fill the 132 SMs.
#include <cmath>

#include "mma.cuh"

namespace comet {
namespace {

constexpr int kShortThreads = 128;  // 4 warps
constexpr int kMaxL = 64;

template <int D>
constexpr int short_attn_max_smem() {
  // 4 pairs of 16 queries and 64 keys is the largest working set
  return 4 * (16 + 2 * kMaxL) * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kShortThreads) short_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int pairs, int H, int Lq, int Lk, int LqP, int LkP, int pairs_per_cta,
    int nslices, long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, float scale) {
  constexpr int LDS = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  const int pair_elems = (LqP + 2 * LkP) * LDS;
  const int pair0 = blockIdx.x * pairs_per_cta;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int p = 0; p < pairs_per_cta && pair0 + p < pairs; ++p) {
    const int b = (pair0 + p) / H, h = (pair0 + p) % H;
    bf16* sQ = base + p * pair_elems;
    bf16* sK = sQ + LqP * LDS;
    bf16* sV = sK + LkP * LDS;
    const bf16* qg = q + b * q_bs + h * D;
    const bf16* kg = k + b * k_bs + h * D;
    const bf16* vg = v + b * v_bs + h * D;
    for (int i = tid; i < LqP * CPR; i += kShortThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = r < Lq;
      cp_async16(sQ + r * LDS + c, qg + (ok ? r * q_rs : 0) + c, ok);
    }
    for (int i = tid; i < LkP * CPR; i += kShortThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = r < Lk;
      cp_async16(sK + r * LDS + c, kg + (ok ? r * k_rs : 0) + c, ok);
      cp_async16(sV + r * LDS + c, vg + (ok ? r * v_rs : 0) + c, ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p = warp / nslices, sl = warp % nslices;
  if (p >= pairs_per_cta || pair0 + p >= pairs) return;
  const int b = (pair0 + p) / H, h = (pair0 + p) % H;
  const bf16* sQ = base + p * pair_elems;
  const bf16* sK = sQ + LqP * LDS;
  const bf16* sV = sK + LkP * LDS;
  const int nkg = LkP / 16;  // 16-key groups, at most 4
  const int t2 = (lane & 3) * 2;

  // S = Q K^T for this warp's 16 query rows against all the keys.
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sQ + (sl * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int kb = 0; kb < kMaxL / 16; ++kb) {
      if (kb < nkg) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sK + (kb * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * kb], a, bk[0], bk[1]);
        mma_bf16(s[2 * kb + 1], a, bk[2], bk[3]);
      }
    }
  }

  // Exact softmax over the row: scale on the f32 logits, masked keys -inf.
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + t2 + (e & 1);
      s[j][e] = key < Lk ? s[j][e] * scale : -INFINITY;
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
      s[j][e] = expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
  const float inv0 = 1.f / quad_sum(sum[0]);
  const float inv1 = 1.f / quad_sum(sum[1]);

  // O = round_bf16(P) V, P reused from the S accumulators as A fragments.
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kb = 0; kb < kMaxL / 16; ++kb) {
    if (kb < nkg) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kb][0] * inv0, s[2 * kb][1] * inv0);
      pa[1] = pack_bf16(s[2 * kb][2] * inv1, s[2 * kb][3] * inv1);
      pa[2] = pack_bf16(s[2 * kb + 1][0] * inv0, s[2 * kb + 1][1] * inv0);
      pa[3] = pack_bf16(s[2 * kb + 1][2] * inv1, s[2 * kb + 1][3] * inv1);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  const int C = H * D;
  const int r0 = sl * 16 + (lane >> 2);
  bf16* og = o + (long long)b * Lq * C + h * D + t2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r0 * C + j * 8) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r0 + 8 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)(r0 + 8) * C + j * 8) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <int D>
int launch_short_attn(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Lq,
                      int Lk, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                      long long v_bs, long long v_rs, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(short_attn_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           short_attn_max_smem<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nslices = (Lq + 15) / 16;
  const int pairs_per_cta = 4 / nslices > 1 ? 4 / nslices : 1;
  const int LqP = nslices * 16, LkP = (Lk + 15) / 16 * 16;
  const int smem = pairs_per_cta * (LqP + 2 * LkP) * (D + 8) * static_cast<int>(sizeof(bf16));
  const int pairs = B * H;
  const int grid = (pairs + pairs_per_cta - 1) / pairs_per_cta;
  short_attn_kernel<D><<<grid, kShortThreads, smem, stream>>>(
      q, k, v, o, pairs, H, Lq, Lk, LqP, LkP, pairs_per_cta, nslices, q_bs, q_rs, k_bs, k_rs,
      v_bs, v_rs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for an unsupported head dimension or length, else
// the CUDA error code of the launch. Strides are in elements; the output is
// a contiguous [B, Lq, H*D] tensor.
extern "C" int comet_short_attn_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int D, int Lq, int Lk, long long q_bs, long long q_rs,
                                    long long k_bs, long long k_rs, long long v_bs,
                                    long long v_rs, float scale, void* stream) {
  using comet::bf16;
  if (Lq < 1 || Lq > comet::kMaxL || Lk < 1 || Lk > comet::kMaxL) return -1;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return comet::launch_short_attn<32>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, s);
    case 48:
      return comet::launch_short_attn<48>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, s);
    case 64:
      return comet::launch_short_attn<64>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, s);
    case 96:
      return comet::launch_short_attn<96>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, s);
    default:
      return -1;
  }
}

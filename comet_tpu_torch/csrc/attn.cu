// K1: multi-head attention forward on the [B, L, H*D] projection layout.
//
// Replaces comet_tpu/ops/pallas_attn.py::_blocked_kernel (the TPU kernel that
// serves the ViT, the camera aggregator and the update-former's cross
// attention). Same function: out[b, q, h*D:(h+1)*D] = softmax(scale *
// Q_h K_h^T) V_h with f32 logits and softmax, keys past Lk masked, output in
// bf16 in the input layout. The unnormalized exponentials are rounded to
// bf16 for the P V product and the row sum divides the f32 result at the end.
//
// What bounds it on the H100: at the main path's long shapes (Lq >= 64, Lk
// 64..577, D 48..96) the logits are 4*Lk*D FLOPs per query row against 4*D
// bytes of Q and O, so the work is bound by tensor-core operations; the short
// calls (trunk, trajectory cross) by launch and memory latency.
//
// The design, a FlashAttention-3-style forward for every shape. A CTA takes
// 128 query rows of one (batch, head): two consumer warpgroups of 64 rows
// each and one producer warp; a warpgroup whose 64 rows all lie past Lq
// (Lq <= 64, or a last query tile of <= 64 rows) leaves at once and the ring
// waits only for the other. The producer brings Q once and then K and V
// tiles of 64 keys into a 4-stage mbarrier ring by TMA, from tensor maps
// over the strided [B, L, C] layout (a column slice of a packed projection
// is a base pointer and a row stride; rows past Lq or Lk load as zeros). A
// head of D columns is read as D / W boxes of W columns (W = 64, 32 or 16,
// the widest that divides D, with the matching 128B / 64B / 32B swizzle), so
// no column of another head is read and no box is partial. S = Q K^T runs on
// wgmma with both operands in shared memory (D / 16 k-steps); the online
// softmax runs in f32 registers in the log2 domain, overlapped with the
// products; O += P V runs on wgmma with P from registers and V as an
// MN-major operand of N = D. The softmax is the ALU's work between the
// products, so it is kept short: only the last key tile is masked, and the
// scale is folded into one FMA per exponent. Each consumer warp releases a
// stage after its products have read it.
#include <cmath>

#include "hopper.cuh"

namespace comet {
namespace {

constexpr int kRows = 128;     // query rows per CTA: 2 consumer warpgroups x 64
constexpr int kKeys = 64;      // keys per tile
constexpr int kStages = 4;     // K/V ring depth
constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 producer warp

template <int D>
struct AttnTiles {
  static constexpr int W = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);  // box columns
  static constexpr int NCH = D / W;                                      // boxes per head
  static constexpr int q_bytes = kRows * D * 2;
  static constexpr int kv_bytes = kKeys * D * 2;  // one of K or V in one stage
  static constexpr int bar_offset = q_bytes + 2 * kStages * kv_bytes;
  // 1024 bytes of slack to align the tiles, then the barriers
  static constexpr int smem = 1024 + bar_offset + (1 + 2 * kStages) * 8;
};

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  if constexpr (N == 48) wgmma_rs_n48(d, a, db, 1);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  if constexpr (N == 96) wgmma_rs_n96(d, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) attn_fwd_kernel(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int Lq, int Lk, int C,
    float scale_log2) {
  using P = AttnTiles<D>;
  constexpr int W = P::W, NCH = P::NCH, S = kStages;
  constexpr uint32_t SBO = 8 * W * 2;  // bytes between 8-row groups of a box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* sQ = reinterpret_cast<bf16*>(base);                // [NCH][kRows][W]
  bf16* sK = reinterpret_cast<bf16*>(base + P::q_bytes);   // [S][NCH][kKeys][W]
  bf16* sV = sK + S * kKeys * D;                         // [S][NCH][kKeys][W]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + P::bar_offset);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (Lk + kKeys - 1) / kKeys;
  const int nwg = Lq - q0 > 64 ? 2 : 1;  // consumer warpgroups with a query row
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * nwg);  // one arrival per working consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      mbar_expect_tx(qbar, P::q_bytes);
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_3d(sQ + ch * kRows * W, &mq, qbar, h * D + ch * W, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + s, ((t / S) - 1) & 1);
        mbar_expect_tx(full + s, 2 * P::kv_bytes);
        bf16* dk = sK + s * kKeys * D;
        bf16* dv = sV + s * kKeys * D;
        for (int ch = 0; ch < NCH; ++ch) {
          tma_load_3d(dk + ch * kKeys * W, &mk, full + s, h * D + ch * W, t * kKeys, b);
          tma_load_3d(dv + ch * kKeys * W, &mv, full + s, h * D + ch * W, t * kKeys, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = warp >> 2;
  if (wg >= nwg) return;
  const int t4 = lane & 3;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const bf16* qw = sQ + wg * 64 * W;
  float sacc[32];  // S of the current tile, later its exponentials
  uint32_t pa[4][4];  // P of the current tile as bf16 A fragments

  // S = Q K^T of tile t: 64 rows x 64 keys, contraction over D in k-steps of 16.
  auto issue_s = [&](int t) {
    const int s = t % S;
    mbar_wait(full + s, (t / S) & 1);
    const bf16* cK = sK + s * kKeys * D;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ch = kk * 16 / W, off = kk * 16 % W;
      wgmma_ss_n64(sacc, make_desc<W>(qw + ch * kRows * W + off, 16, SBO),
                   make_desc<W>(cK + ch * kKeys * W + off, 16, SBO), kk > 0);
    }
    wgmma_commit();
  };

  // The loop overlaps the tensor cores with the softmax: tile t's softmax
  // runs while P V of tile t - 1 is in flight, and S of tile t + 1 is
  // issued before P V of tile t, so at most two wgmma groups are pending.
  mbar_wait(qbar, 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sacc);
  for (int t = 0; t < ntiles; ++t) {
    // Online softmax of tile t in the log2 domain. Only the last tile can
    // hold keys past Lk (they get -inf); the running maximum is kept in
    // unscaled logits and the scale is folded into one FMA per exponent.
    if ((t + 1) * kKeys > Lk) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t * kKeys + (i >> 2) * 8 + t4 * 2 + (i & 1);
        if (key >= Lk) sacc[i] = -INFINITY;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
    float alpha[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m_run[r] - mx[r]) * scale_log2);
      m_run[r] = mx[r];
      msc[r] = mx[r] * scale_log2;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = exp2f(fmaf(sacc[i], scale_log2, -msc[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += sacc[i];
    }

    // P V of tile t - 1 is done: its stage is free, and O and P may change.
    wgmma_wait<0>();
    fence_regs(oacc);
    if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % S);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    if (t + 1 < ntiles) issue_s(t + 1);
    // O += P V: P from registers (the S layout is the A fragment layout),
    // V MN-major: N = D over NCH boxes, k-steps of 16 keys.
    const bf16* cV = sV + (t % S) * kKeys * D;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(oacc, pa[kk], make_desc<W>(cV + kk * 16 * W, kKeys * W * 2, SBO));
    wgmma_commit();
    wgmma_wait<1>();  // S of tile t + 1 (committed first) is done
    fence_regs(sacc);
  }
  wgmma_wait<0>();
  fence_regs(oacc);

  const float inv0 = 1.f / quad_sum(l_run[0]);
  const float inv1 = 1.f / quad_sum(l_run[1]);
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  bf16* og = o + (long long)b * Lq * C + h * D + t4 * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r0 * C + j * 8) =
          __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    if (r0 + 8 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)(r0 + 8) * C + j * 8) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
  }
}

// The tensor map of one operand: dims (C, L, B), rows of `rows` by W columns.
// A size-1 dimension may report stride 0; any valid stride serves it.
template <int W>
bool operand_map(CUtensorMap* map, const bf16* p, int B, int L, int C, long long bs,
                 long long rs, int rows) {
  if (rs == 0) rs = C;
  if (bs == 0) bs = static_cast<long long>(L) * rs;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(rs) * 2, static_cast<cuuint64_t>(bs) * 2};
  const cuuint32_t box[3] = {W, static_cast<cuuint32_t>(rows), 1};
  return make_tensor_map<W>(map, p, 3, dims, strides, box);
}

template <int D>
int launch_attn(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Lq,
                int Lk, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                long long v_bs, long long v_rs, float scale, cudaStream_t stream) {
  using P = AttnTiles<D>;
  const int C = H * D;
  // a stride of 0 on a dimension longer than 1 (an expanded tensor) would
  // make the tensor map step past the allocation
  if ((q_rs == 0 && Lq > 1) || ((k_rs == 0 || v_rs == 0) && Lk > 1) ||
      ((q_bs == 0 || k_bs == 0 || v_bs == 0) && B > 1))
    return -1;
  CUtensorMap mq, mk, mv;
  if (!operand_map<P::W>(&mq, q, B, Lq, C, q_bs, q_rs, kRows) ||
      !operand_map<P::W>(&mk, k, B, Lk, C, k_bs, k_rs, kKeys) ||
      !operand_map<P::W>(&mv, v, B, Lk, C, v_bs, v_rs, kKeys))
    return -2;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Lq + kRows - 1) / kRows, H, B);
  attn_fwd_kernel<D><<<grid, kThreads, P::smem, stream>>>(mq, mk, mv, o, Lq, Lk, C,
                                                           scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for arguments the kernel does not take (a head
// dimension, or stride 0 on a dimension longer than 1: an expanded tensor),
// -2 if cuTensorMapEncodeTiled refuses a tensor map, else the CUDA error code
// of the launch. Strides are in elements; a dimension of size 1 may report
// stride 0. The output is a contiguous [B, Lq, H*D] tensor.
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

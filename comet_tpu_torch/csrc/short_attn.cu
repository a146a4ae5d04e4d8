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
// 2*(3*B*L*C + B*L*C). The tensor cores are not the limit, so the products
// stay on mma.sync m16n8k16 (wgmma wants 64 rows: four sequences of 16
// under a block-diagonal mask, the TPU's packing, at 4x the logits).
//
// The design (ops/attn.py::short_plan picks the numbers):
// - A unit of work is Hg heads of one sequence: the whole sequence (Hg = H)
//   where the units still fill the card, as at L 16, else fewer heads (at L
//   64, 16 sequences would give 16 CTAs). Warp w takes head w / S and query
//   rows 16 (w % S) .. + 15, S = ceil(Lq / 16), so a CTA has Hg * S warps.
// - Its q, k and v are column slices [g Hg D, (g + 1) Hg D) of whole rows,
//   read by TMA from 3D tensor maps over the strided [B, L, C] layout (a
//   column slice of a packed projection is a base pointer and a row
//   stride), as boxes of 64 columns by ceil(L / 16) * 16 rows with the 128B
//   swizzle, so ldmatrix reads them without bank conflicts. Rows past L and
//   columns past C load as zeros; where Hg D is not a multiple of 64 the
//   last box also reads the next head's first columns, unused (narrower
//   boxes cost the TMA unit more: it walks a box row by row).
// - A persistent grid: at most as many CTAs as the card holds at once, unit
//   u going to CTA u % grid, and a ring of 1 to 3 stages, each one unit's q,
//   k and v completed on one mbarrier: the units after the current one are
//   in flight while it is computed, so the CTAs do not load, compute and
//   store in lockstep.
// - The output goes through shared memory in swizzled boxes of exactly the
//   unit's columns, W = 64, 32 or 16 wide (the widest dividing Hg D), and
//   out by TMA stores of whole [L, W] boxes (rows past Lq are not written),
//   which overlap the next unit's products: one output tile suffices, since
//   its stores have read it long before the next unit's are written.
// - Instances per head dimension and per 16-key groups of Lk, so that at L
//   16 a row's logits take 8 registers, not the 32 of L 64.
// - The whole row of <= 64 logits stays in registers, so the softmax is
//   exact, not online, in the log2 domain (log2 e folded into the scale).
#include <cmath>

#include "hopper.cuh"

namespace comet {
namespace {

constexpr int kMaxL = 64;
constexpr int kMaxStages = 3;

// The most warps a CTA has: 16, or 8 at D 96 and at D 64 with more than 48
// keys,
// whose output fragments, logits and hoisted tile addresses need more than
// the 128 registers a thread of a 512-thread CTA may have
// (ops/attn.py::short_max_warps).
template <int D, int NKG>
constexpr int max_warps() {
  return D == 96 || (D == 64 && NKG == 4) ? 8 : 16;
}

// The launch bounds' minimum CTAs per SM: none at L <= 16, where ptxas's own
// choice keeps D 32 small enough for four 8-warp CTAs per SM without
// spilling; else one, which lets a thread have all 128 registers of a
// 512-thread CTA (without it ptxas held D 32 with 32 keys to fewer, and
// spilled).
template <int D, int NKG>
constexpr int min_ctas() {
  return NKG == 1 ? 0 : 1;
}

constexpr int kInBox = 64;  // columns of an input box (128B swizzle)

// Shared memory of one launch: 1024 bytes of slack to align the tiles, the
// ring of q, k, v tiles (CW columns read as whole 64-column boxes), the
// output tile, then the barriers.
int short_smem(int LqP, int LkP, int CW, int stages) {
  const int CWP = (CW + kInBox - 1) / kInBox * kInBox;
  return 1024 + stages * (LqP + 2 * LkP) * CWP * 2 + LqP * CW * 2 + 8 * kMaxStages;
}

// Byte offset of element (r, col) of a tile stored as boxes of R rows by
// W = 1 << wl columns, each swizzled as TMA writes it (CUTLASS's
// Swizzle<wl - 3, 4, 3>); col is even.
__device__ __forceinline__ uint32_t swz(int r, int col, int R, int wl) {
  const int box = col >> wl, cc = col & ((1 << wl) - 1);
  uint32_t o = (r << (wl + 1)) + ((cc >> 3) << 4);
  o ^= ((o >> 7) & ((1u << (wl - 3)) - 1)) << 4;
  return box * (R << (wl + 1)) + o + ((cc & 7) << 1);
}

// NKG: groups of 16 keys (ceil(Lk / 16)), so that the logits of a row take
// 8 NKG registers and not the 32 of the longest keys.
template <int D, int NKG>
__global__ void __launch_bounds__(max_warps<D, NKG>() * 32, min_ctas<D, NKG>()) short_attn_kernel(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo, int units,
    int gps, int Lk, int LqP, int LkP, int CW, int wl, int stages, float scale_log2) {
  // wl: log2 of the output boxes' columns; the input boxes have 64 (wl 6)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nbi = (CW + kInBox - 1) / kInBox;  // input boxes per operand
  const int q_bytes = LqP * nbi * kInBox * 2, k_bytes = LkP * nbi * kInBox * 2;
  const int stage_bytes = q_bytes + 2 * k_bytes;
  const int o_bytes = LqP * CW * 2;
  unsigned char* ob = base + stages * stage_bytes;  // the output tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ob + o_bytes);
  const int nbo = CW >> wl;  // output boxes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsl = LqP >> 4;
  const int hc = (warp / nsl) * D;  // this warp's head, as a column of the tile
  const int sl = warp % nsl;        // and its 16 query rows
  const int mine = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // units of this CTA

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Warp 0 brings unit i of this CTA into its stage: 3 * nbi TMA boxes.
  auto issue_loads = [&](int i) {
    const int u = blockIdx.x + i * gridDim.x;
    const int b = u / gps, col0 = (u % gps) * CW, st = i % stages;
    unsigned char* sq = base + st * stage_bytes;
    if (lane == 0) mbar_expect_tx(&full[st], stage_bytes);
    __syncwarp();
    for (int j = lane; j < 3 * nbi; j += 32) {
      const int op = j / nbi, bx = j % nbi;
      if (op == 0)
        tma_load_3d(sq + bx * LqP * kInBox * 2, &mq, &full[st], col0 + bx * kInBox, 0, b);
      else
        tma_load_3d(sq + q_bytes + (op - 1) * k_bytes + bx * LkP * kInBox * 2,
                    op == 1 ? &mk : &mv, &full[st], col0 + bx * kInBox, 0, b);
    }
  };
  if (warp == 0)
    for (int i = 0; i < stages && i < mine; ++i) issue_loads(i);

  const int t2 = (lane & 3) * 2;
  for (int i = 0; i < mine; ++i) {
    const int u = blockIdx.x + i * gridDim.x;
    const int st = i % stages;
    const unsigned char* sq = base + st * stage_bytes;
    const unsigned char* sk = sq + q_bytes;
    const unsigned char* sv = sk + k_bytes;
    mbar_wait(&full[st], (i / stages) & 1);

    // S = Q K^T for this warp's 16 query rows against all the keys.
    float s[2 * NKG][4];
#pragma unroll
    for (int j = 0; j < 2 * NKG; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sq + swz(sl * 16 + (lane & 15), hc + kk * 16 + (lane >> 4) * 8, LqP, 6));
#pragma unroll
      for (int kb = 0; kb < NKG; ++kb) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sk + swz(kb * 16 + (lane & 7) + (lane >> 4) * 8,
                                 hc + kk * 16 + ((lane >> 3) & 1) * 8, LkP, 6));
        mma_bf16(s[2 * kb], a, bk[0], bk[1]);
        mma_bf16(s[2 * kb + 1], a, bk[2], bk[3]);
      }
    }

    // Exact softmax over the row, in the log2 domain: masked keys -inf.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * NKG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + t2 + (e & 1);
        s[j][e] = key < Lk ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
    for (int j = 0; j < 2 * NKG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
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
    for (int kb = 0; kb < NKG; ++kb) {
      {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kb][0] * inv0, s[2 * kb][1] * inv0);
        pa[1] = pack_bf16(s[2 * kb][2] * inv1, s[2 * kb][3] * inv1);
        pa[2] = pack_bf16(s[2 * kb + 1][0] * inv0, s[2 * kb + 1][1] * inv0);
        pa[3] = pack_bf16(s[2 * kb + 1][2] * inv1, s[2 * kb + 1][3] * inv1);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sv + swz(kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                         hc + dp * 16 + (lane >> 4) * 8, LkP, 6));
          mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }

    // Warp 0's stores of the last unit have read the output tile (long
    // since: they were issued before this unit's products).
    if (warp == 0) bulk_wait_read<0>();
    __syncthreads();  // every warp has read stage st, and the output tile is free
    if (warp == 0 && i + stages < mine) issue_loads(i + stages);
    const int r0 = sl * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = hc + j * 8 + t2;
      *reinterpret_cast<uint32_t*>(ob + swz(r0, col, LqP, wl)) = pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(ob + swz(r0 + 8, col, LqP, wl)) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    fence_proxy_async();
    __syncthreads();
    if (warp == 0) {
      const int b = u / gps, col0 = (u % gps) * CW;
      for (int j = lane; j < nbo; j += 32)
        tma_store_3d(&mo, ob + j * (LqP << (wl + 1)), col0 + (j << wl), 0, b);
      bulk_commit();
    }
  }
  if (warp == 0) bulk_wait_read<0>();
}

// The tensor map of one operand: dims (C, L, B), boxes of `rows` rows by W
// columns. A size-1 dimension may report stride 0; any valid stride serves
// it.
bool operand_map(CUtensorMap* map, const bf16* p, int B, int L, int C, long long bs,
                 long long rs, int rows, int W) {
  if (rs == 0) rs = C;
  if (bs == 0) bs = static_cast<long long>(L) * rs;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(rs) * 2, static_cast<cuuint64_t>(bs) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(W), static_cast<cuuint32_t>(rows), 1};
  switch (W) {
    case 64: return make_tensor_map<64>(map, p, 3, dims, strides, box);
    case 32: return make_tensor_map<32>(map, p, 3, dims, strides, box);
    case 16: return make_tensor_map<16>(map, p, 3, dims, strides, box);
    default: return false;
  }
}

template <int D, int NKG>
int set_max_smem() {
  static cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(short_attn_kernel<D, NKG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return e;
  }();
  return static_cast<int>(err);
}

struct ShortArgs {
  CUtensorMap mq, mk, mv, mo;
  int units, gps, Lk, LqP, LkP, CW, wl, stages;
  float scale_log2;
};

template <int D, int NKG>
int launch_instance(const ShortArgs& a, int grid, int threads, int smem, cudaStream_t stream) {
  const int err = set_max_smem<D, NKG>();
  if (err != 0) return err;
  short_attn_kernel<D, NKG><<<grid, threads, smem, stream>>>(
      a.mq, a.mk, a.mv, a.mo, a.units, a.gps, a.Lk, a.LqP, a.LkP, a.CW, a.wl, a.stages,
      a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NKG>
int resident_instance(int threads, int smem) {
  if (set_max_smem<D, NKG>() != 0) return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, short_attn_kernel<D, NKG>, threads,
                                                       smem) == cudaSuccess
             ? n
             : -1;
}

template <int D>
int launch_short_attn(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Lq,
                      int Lk, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                      long long v_bs, long long v_rs, float scale, int hg, int stages, int grid,
                      cudaStream_t stream) {
  const int nsl = (Lq + 15) / 16, nkg = (Lk + 15) / 16;
  const int most = nkg == 4 ? max_warps<D, 4>() : max_warps<D, 1>();
  if (hg < 1 || H % hg != 0 || hg * nsl > most || stages < 1 || stages > kMaxStages || grid < 1)
    return -1;
  // a stride of 0 on a dimension longer than 1 (an expanded tensor) would
  // make the tensor map step past the allocation
  if ((q_rs == 0 && Lq > 1) || ((k_rs == 0 || v_rs == 0) && Lk > 1) ||
      ((q_bs == 0 || k_bs == 0 || v_bs == 0) && B > 1))
    return -1;
  const int C = H * D, CW = hg * D;
  const int W = CW % 64 == 0 ? 64 : (CW % 32 == 0 ? 32 : 16);
  const int wl = W == 64 ? 6 : (W == 32 ? 5 : 4);
  const int LqP = nsl * 16, LkP = (Lk + 15) / 16 * 16;
  CUtensorMap mq, mk, mv, mo;
  if (!operand_map(&mq, q, B, Lq, C, q_bs, q_rs, LqP, kInBox) ||
      !operand_map(&mk, k, B, Lk, C, k_bs, k_rs, LkP, kInBox) ||
      !operand_map(&mv, v, B, Lk, C, v_bs, v_rs, LkP, kInBox) ||
      !operand_map(&mo, o, B, Lq, C, static_cast<long long>(Lq) * C, C, LqP, W))
    return -2;
  const ShortArgs a{mq, mk, mv, mo, B * (H / hg), H / hg, Lk, LqP, LkP, CW, wl, stages,
                    scale * 1.4426950408889634f};
  const int threads = hg * nsl * 32, smem = short_smem(LqP, LkP, CW, stages);
  switch (LkP / 16) {
    case 1: return launch_instance<D, 1>(a, grid, threads, smem, stream);
    case 2: return launch_instance<D, 2>(a, grid, threads, smem, stream);
    case 3: return launch_instance<D, 3>(a, grid, threads, smem, stream);
    default: return launch_instance<D, 4>(a, grid, threads, smem, stream);
  }
}

template <int D>
int resident_short_attn(int Lk, int threads, int smem) {
  switch ((Lk + 15) / 16) {
    case 1: return resident_instance<D, 1>(threads, smem);
    case 2: return resident_instance<D, 2>(threads, smem);
    case 3: return resident_instance<D, 3>(threads, smem);
    default: return resident_instance<D, 4>(threads, smem);
  }
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for arguments the kernel does not take (a head
// dimension or length, a plan, or stride 0 on a dimension longer than 1: an
// expanded tensor), -2 if cuTensorMapEncodeTiled refuses a tensor map, else
// the CUDA error code of the launch. Strides are in elements; a dimension of
// size 1 may report stride 0. The output is a contiguous [B, Lq, H*D]
// tensor. heads (per unit), stages and grid come from ops/attn.py::short_plan.
extern "C" int comet_short_attn_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int D, int Lq, int Lk, long long q_bs, long long q_rs,
                                    long long k_bs, long long k_rs, long long v_bs,
                                    long long v_rs, float scale, int heads, int stages, int grid,
                                    void* stream) {
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
                                          v_bs, v_rs, scale, heads, stages, grid, s);
    case 48:
      return comet::launch_short_attn<48>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, heads, stages, grid, s);
    case 64:
      return comet::launch_short_attn<64>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, heads, stages, grid, s);
    case 96:
      return comet::launch_short_attn<96>(qp, kp, vp, op, B, H, Lq, Lk, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, heads, stages, grid, s);
    default:
      return -1;
  }
}

// How many CTAs of K3 at head dimension D and Lk keys, of `threads`
// threads and `smem` bytes of dynamic shared memory, one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
extern "C" int comet_short_attn_resident(int D, int Lk, int threads, int smem) {
  if (Lk < 1 || Lk > comet::kMaxL) return -1;
  switch (D) {
    case 32: return comet::resident_short_attn<32>(Lk, threads, smem);
    case 48: return comet::resident_short_attn<48>(Lk, threads, smem);
    case 64: return comet::resident_short_attn<64>(Lk, threads, smem);
    case 96: return comet::resident_short_attn<96>(Lk, threads, smem);
    default: return -1;
  }
}

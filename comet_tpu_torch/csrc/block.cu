// K2: one whole AttnBlock (LN -> qkv -> attention -> out-proj -> residual ->
// LN -> MLP -> residual) over many short sequences, in one launch.
//
// Replaces comet_tpu/ops/pallas_block.py::_fused_kernel (with its helpers
// _lane_packed_attend and pallas_attn.py::_heads_attend). Same function and
// the same bf16 rounding points as the TPU kernel: LayerNorms are scale-free
// with eps 1e-6 and f32 statistics; each matmul accumulates in f32 and is
// rounded to bf16 before its bias add, and the sum is rounded again;
// attention logits and softmax are f32 with a plain per-(sequence, head)
// softmax (the TPU's lane packing and its 1e-30 denominator clamp were layout
// devices of that chip); GELU is the tanh form on bf16 values; the residual
// stream is re-based on the normalized input: x1 = ln1(x) + attn(ln1(x));
// out = x1 + mlp(ln2(x1)).
//
// What bounds it on the H100: the matmuls. Per row it does 2*C*(3C + C + 8C)
// FLOPs (33 GFLOP for the coarse time block's 9216 rows at C 384) against
// 4*C bytes of activations in and out, so it is bound by tensor-core
// operations; in practice a CTA of 64 rows also reads every weight (3.5 MB at
// C 384) from L2, so L2 bandwidth is the next limit.
//
// What the design does about it: one CTA takes 64 rows (whole sequences: 4
// of 16 or 1 of 64) and keeps every intermediate on chip; only x is read and
// the block's output written. Two consumer warpgroups and a producer
// warpgroup, whose registers move to the consumers (setmaxnreg 40 / 232): one
// producer thread brings every weight tile by TMA (64-column k-tiles,
// 128-byte swizzle) into a 4-stage mbarrier ring, in one fixed order in
// which the tiles alternate between the two warpgroups; each warpgroup runs
// its half of every product on wgmma with the activations (ln1(x), the
// attention output, ln2(x1), one GELU'd MLP chunk) as K-major A operands in
// shared memory, written by the kernel in the 128-byte swizzled layout. The
// halves: for qkv and attention one head each (warpgroup w takes head 2p + w
// of head pair p, N = 3D), for the out-projection and fc2 one half of the
// output columns (two passes of N = C/4), for fc1 one half of each 128-wide
// hidden chunk (N = 64); the fc2 accumulators stay in registers across
// chunks. Attention within the block is < 3 % of its FLOPs and stays on
// mma.sync, one warp per 16 query rows. The weight ring, the product chain
// and the block's second half (out-projection to output) are
// block_common.cuh's, shared with K4; each warpgroup waits on every weight
// tile's wgmma group before the next (with two groups in flight the 4-stage
// ring runs dry and K2 was slower, PERF.md).
//
// Where too few 64-row tiles exist to fill the card (the coarse virtual
// blocks: 16 tiles for 132 SMs), a cluster of `split` CTAs shares each tile
// (ops/block.py::block_split): every CTA of the cluster runs the block up to
// ln2(x1), then only the hidden chunks c with c % split == its rank; the
// CTAs' f32 fc2 partial sums meet in distributed shared memory, where each
// CTA adds up one slice of the tile (in rank order) and writes its output.
//
// The kernel is instantiated three times per width: kSplit false for
// split 1 (the split folds away), kSplit true for a cluster, and kTimed for
// measurement: given a `clocks` buffer, CTA 0 records where its time goes,
// in SM clock cycles (see comet_attn_block_fwd); the kernels the forward
// runs carry none of it.
#include <cmath>

#include "block_common.cuh"

namespace comet {
namespace {

constexpr int kBlkStages = 4;  // weight ring depth
constexpr int kInFlight = 1;   // wgmma groups in flight per warpgroup in the weight products

template <int C>
struct BlockPlan {
  static constexpr int D = C / 8;
  static constexpr int NQKV = 3 * D;  // one head's q, k and v columns
  static constexpr int NQ = C / 4;    // one pass of a warpgroup's output half
  static constexpr int LDQ = D + 8;   // padded row of the per-head q/k/v scratch
  static constexpr int x_bytes = kBlkRows * C * 2;
  static constexpr int qkv_bytes = 2 * 3 * kBlkRows * LDQ * 2;
  static constexpr int h_bytes = kBlkRows * kHid * 2;  // one GELU'd hidden chunk
  static constexpr int u_bytes =
      ((qkv_bytes > h_bytes ? qkv_bytes : h_bytes) + 1023) / 1024 * 1024;
  static constexpr int stage_rows = NQKV > kHid / 2 ? NQKV : kHid / 2;
  static_assert(stage_rows >= NQ, "a stage holds every tile of the ring");
  static constexpr int stage_bytes = stage_rows * 128;
  static constexpr int ring_offset = 2 * x_bytes + u_bytes;
  static constexpr int bar_offset = ring_offset + kBlkStages * stage_bytes;
  static constexpr int smem = 1024 + bar_offset + 2 * kBlkStages * 8;
  // the f32 fc2 partial sums of a split tile, [64][C + 8], over sU and the ring
  static_assert(kBlkRows * (C + 8) * 4 <= u_bytes + kBlkStages * stage_bytes, "partials fit");
};

template <int C, bool kSplit, bool kTimed>
__global__ void __launch_bounds__(kBlkThreads, 1) attn_block_kernel(
    const __grid_constant__ CUtensorMap m_qkv, const __grid_constant__ CUtensorMap m_out,
    const __grid_constant__ CUtensorMap m_w1, const __grid_constant__ CUtensorMap m_w2,
    const bf16* __restrict__ x, const bf16* __restrict__ bqkv, const bf16* __restrict__ bout,
    const bf16* __restrict__ b1, const bf16* __restrict__ b2, bf16* __restrict__ out, int rows,
    int L, int hidden, float scale, int split_arg, long long* __restrict__ clocks) {
  using P = BlockPlan<C>;
  constexpr int D = P::D, NQKV = P::NQKV, LDQ = P::LDQ, S = kBlkStages;
  constexpr int KT = C / 64;  // k-tiles of a product over C
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* sX = reinterpret_cast<bf16*>(base);                 // ln1(x), then x1
  bf16* sA = reinterpret_cast<bf16*>(base + P::x_bytes);    // attention out, then ln2(x1)
  bf16* sU = reinterpret_cast<bf16*>(base + 2 * P::x_bytes);  // q/k/v scratch, later sH
  bf16* ring = reinterpret_cast<bf16*>(base + P::ring_offset);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::bar_offset);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = kSplit ? split_arg : 1;
  const int rank = kSplit ? blockIdx.x % split : 0;  // rank in the cluster that shares the tile
  const int row0 = blockIdx.x / split * kBlkRows;
  const int nchunks = hidden / kHid;
  const bool timed = kTimed && blockIdx.x == 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // the owning warpgroup's 4 warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const uint32_t t_start = kTimed ? clock32() : 0;

  if (warp >= 8) {  // producer: one thread issues every weight tile, in the consumers' order
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      RingProducer<S> pr{ring, full, empty, P::stage_bytes / 2, 0, 0, timed};
      uint64_t* bar;
      for (int p = 0; p < 4; ++p)
        for (int kt = 0; kt < KT; ++kt)
          for (int w = 0; w < 2; ++w) {
            bf16* dst = pr.acquire(NQKV * 128, &bar);
            for (int seg = 0; seg < 3; ++seg)
              tma_load_2d(dst + seg * D * 64, &m_qkv, bar, kt * 64, seg * C + (2 * p + w) * D);
          }
      produce_out_projection<C>(pr, &m_out);
      produce_mlp<C>(pr, &m_w1, &m_w2, rank, split, nchunks);
      if (timed) {
        clocks[16] = pr.waited;
        clocks[17] = clock32() - t_start;
      }
    }
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumers: warpgroup w, its warp lw owns rows 16 lw .. 16 lw + 15 of every
  // 64-row accumulator
  setmaxnreg_inc<232>();
  const int w = warp >> 2, lw = warp & 3;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  RingConsumer<S> rc{ring, full, empty, P::stage_bytes / 2, w, w, 0, 0, timed};
  const bool stamps = timed && tid % 128 == 0;
  auto stamp = [&](int at) {
    if (stamps) clocks[8 * w + at] = clock32() - t_start;
  };

  // ln1(x) -> sX (rows past the end are zero and stay finite)
  layer_norm_swizzled<C, 4>(
      [&](int r, int col) {
        return row0 + r < rows ? __bfloat162float(x[(long long)(row0 + r) * C + col]) : 0.f;
      },
      sX);
  fence_proxy_async();
  named_barrier(1, 256);
  stamp(0);

  // qkv and attention, warpgroup w on head 2p + w
  bf16* sQ = sU + w * 3 * kBlkRows * LDQ;
  bf16* sK = sQ + kBlkRows * LDQ;
  bf16* sV = sK + kBlkRows * LDQ;
  for (int p = 0; p < 4; ++p) {
    const int h = 2 * p + w;
    float acc[NQKV / 2];
#pragma unroll
    for (int i = 0; i < NQKV / 2; ++i) acc[i] = 0.f;
    ring_product<NQKV, kInFlight>(acc, sX, KT, rc);
    named_barrier(2 + w, 128);  // the previous head's attention is done with the scratch
#pragma unroll
    for (int j = 0; j < NQKV / 8; ++j) {
      const int n = j * 8 + t2;
      const int which = n / D, d = n % D;
      const float bb0 = __bfloat162float(bqkv[which * C + h * D + d]);
      const float bb1 = __bfloat162float(bqkv[which * C + h * D + d + 1]);
      bf16* dst = sQ + which * kBlkRows * LDQ + d;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = lw * 16 + g + hr * 8;
        *reinterpret_cast<__nv_bfloat162*>(dst + r * LDQ) = __floats2bfloat162_rn(
            round_bf16(acc[4 * j + 2 * hr]) + bb0, round_bf16(acc[4 * j + 2 * hr + 1]) + bb1);
      }
    }
    named_barrier(2 + w, 128);

    // Warp lw: query rows 16 lw .. 16 lw + 15 against the keys of their sequences.
    {
      const int lr = L > 16 ? L : 16;  // key span that covers the 16 rows
      const int lsh = __ffs(L) - 1;    // L is a power of two (it divides 64)
      const int ks = (lw * 16 / lr) * lr;
      const int nkt = lr / 8;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sQ + (lw * 16 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (2 * pp < nkt) {
            uint32_t b[4];
            ldmatrix_x4(b, sK + (ks + pp * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kk * 16 +
                               ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * pp], a, b[0], b[1]);
            mma_bf16(s[2 * pp + 1], a, b[2], b[3]);
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ks + j * 8 + t2 + (e & 1);
          const int qrow = lw * 16 + g + (e >> 1) * 8;
          const bool ok = j < nkt && (key >> lsh) == (qrow >> lsh);
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
      const int r = lw * 16 + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = h * D + j * 8 + t2;
        *reinterpret_cast<__nv_bfloat162*>(sA + swz(r, col)) =
            __floats2bfloat162_rn(o[j][0], o[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(sA + swz(r + 8, col)) =
            __floats2bfloat162_rn(o[j][2], o[j][3]);
      }
    }
  }
  fence_proxy_async();
  named_barrier(1, 256);
  stamp(1);

  tail_out_projection<C, kInFlight>(sX, sA, bout, rc);
  stamp(2);
  tail_ln2<C>(sX, sA);
  stamp(3);
  float acc2[2][C / 8];
  tail_mlp<C, kInFlight>(sA, sU, b1, acc2, rank, split, nchunks, rc);
  stamp(4);
  tail_output<C, kSplit>(acc2, sX, reinterpret_cast<float*>(sU), b2, out, row0, rows, rank,
                         split);
  stamp(5);
  if (stamps) {
    clocks[8 * w + 6] = rc.waited;
    clocks[8 * w + 7] = rc.taken;
  }
}

template <int C>
int launch_block(const bf16* x, const bf16* wqkv, const bf16* bqkv, const bf16* wout,
                 const bf16* bout, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                 bf16* out, int rows, int L, int hidden, int split, long long* clocks,
                 cudaStream_t stream) {
  using P = BlockPlan<C>;
  using Kernel = decltype(&attn_block_kernel<C, false, false>);
  CUtensorMap m_qkv, m_out, m_w1, m_w2;
  if (!matrix_map(&m_qkv, wqkv, 3 * C, C, P::D) || !matrix_map(&m_out, wout, C, C, P::NQ) ||
      !matrix_map(&m_w1, w1, hidden, C, kHid / 2) || !matrix_map(&m_w2, w2, C, hidden, P::NQ))
    return -2;
  static bool configured = false;
  if (!configured) {
    const Kernel kernels[3] = {&attn_block_kernel<C, false, false>,
                               &attn_block_kernel<C, true, false>, &attn_block_kernel<C, true, true>};
    for (Kernel kernel : kernels) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    configured = true;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kBlkRows - 1) / kBlkRows * split);
  cfg.blockDim = dim3(kBlkThreads);
  cfg.dynamicSmemBytes = P::smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(P::D)));
  const Kernel kernel = clocks      ? &attn_block_kernel<C, true, true>
                       : split > 1 ? &attn_block_kernel<C, true, false>
                                   : &attn_block_kernel<C, false, false>;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, m_qkv, m_out, m_w1, m_w2, x, bqkv, bout,
                                             b1, b2, out, rows, L, hidden, scale, split, clocks));
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for arguments the kernel does not take (C, H, L,
// hidden, or a split that is not 1..8 or does not divide the hidden
// chunks), -2 if cuTensorMapEncodeTiled refuses a tensor map, else the CUDA
// error code of the launch. x and out are contiguous [rows, C]; weights are
// in the [out_features, in_features] layout: wqkv [3C, C], wout [C, C], w1
// [hidden, C], w2 [C, hidden]. `split` CTAs share each 64-row tile
// (ops/block.py::block_split). `clocks` is null, or 18 int64 that receive,
// from the timed instantiation, CTA 0's SM cycles since its start: for
// consumer warpgroup w at 8 w +
// 0..5 the ends of ln1, qkv and attention, the out-projection, ln2, the MLP
// and the output, at 8 w + 6 the cycles it waited for weight tiles and at
// 8 w + 7 the tiles it took; at 16 the producer's cycles waiting for a free
// stage and at 17 the end of its last issue.
extern "C" int comet_attn_block_fwd(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wout, const void* bout, const void* w1,
                                    const void* b1, const void* w2, const void* b2, void* out,
                                    int rows, int L, int C, int H, int hidden, int split,
                                    void* clocks, void* stream) {
  using comet::bf16;
  if (L < 1 || comet::kBlkRows % L != 0 || hidden % comet::kHid != 0 || split < 1 || split > 8 ||
      (hidden / comet::kHid) % split != 0)
    return -1;
  const bf16* a[9] = {static_cast<const bf16*>(x),    static_cast<const bf16*>(wqkv),
                      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wout),
                      static_cast<const bf16*>(bout), static_cast<const bf16*>(w1),
                      static_cast<const bf16*>(b1),   static_cast<const bf16*>(w2),
                      static_cast<const bf16*>(b2)};
  bf16* o = static_cast<bf16*>(out);
  long long* t = static_cast<long long*>(clocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 384 && H == 8)
    return comet::launch_block<384>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o, rows,
                                    L, hidden, split, t, s);
  if (C == 256 && H == 8)
    return comet::launch_block<256>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o, rows,
                                    L, hidden, split, t, s);
  return -1;
}

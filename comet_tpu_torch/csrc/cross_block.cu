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
// bf16 before its bias add, and the sum is rounded again; logits and softmax
// are f32 with the scale on the f32 logits; the residual is re-based on the
// normalized query; GELU is the tanh form on bf16 values.
//
// What bounds it on the H100: the matmuls. FLOPs = 2C*(Rq*(2C + 2*hidden) +
// Rk*2C) + 4*Rq*Lk*C for Rq = B*Lq query rows and Rk = B*Lk context rows,
// against 2*(2*Rq*C + Rk*C + 4C^2 + 2C*hidden) bytes. At the update-former's
// shapes a CTA's chain of wgmma groups sets the time, and at virtual<-point
// (16 query tiles) so does the number of SMs the tiles can reach.
//
// The design. One sequence's normalized context (512 x 384 bf16 = 384 KB
// for virtual<-point) does not fit the 227 KB of shared memory, so the block
// runs in two launches on one stream; both are built like K2 (block.cu): two
// consumer warpgroups run every product on wgmma from a ring of tiles that
// one producer thread fills by TMA, with the activations as 128-byte
// swizzled K-major operands in shared memory.
//  1. cross_kv_kernel: per 64 context rows (TMA), LN_ctx with its affine
//     once, then K and V (N = 2C) in passes of C/4 columns; K and V go to a
//     bf16 [Rk, 2C] scratch in global memory (the TPU kernel's own rounding
//     point). Where the row tiles cannot fill the card, gridDim.y splits the
//     passes into column groups (ops/block.py::cross_kv_groups), each of
//     which recomputes the LN.
//  2. cross_block_kernel: per 64 query rows (TMA), ln1; then per head the q
//     projection (N = D) into registers, which are the A operand of S = Q K^T
//     on wgmma over 64-key tiles brought by TMA from the kv scratch through a
//     3D tensor map (columns, Lk, B: keys past Lk load as zero, in D / W
//     boxes of W columns as K1 reads a head); the online f32 softmax in the
//     log2 domain, masked only on the last key tile; P V on the register-A
//     wgmma. The two warpgroups take one head each; then K2's tail
//     (block_common.cuh). Weight and K/V tiles share one ring, in the order
//     the consumers take them.
// Where Lq < 64 or Lq % 64 != 0 a tile holds rows of several sequences: the
// attention runs once per sequence in the tile over all 64 rows (every row
// sees a valid key, so no row is all masked), and each row keeps the pass of
// its own sequence; rows past B*Lq take the last sequence's and are not
// written out.
//
// Where too few 64-row tiles exist to fill the card (virtual<-point: 16), a
// cluster of `split` CTAs shares each tile (ops/block.py::cross_split):
// rank r computes q and attention only for the heads h with h % split == r
// (at split 8 one head, its keys halved between the warpgroups and the two
// online-softmax states merged), and sends its attention columns into every
// peer's sA through distributed shared memory (st.async, counted in bytes on
// the peer's mbarrier); then it computes columns r C / split .. of the
// out-projection plus residual and sends that part of x1 to its peers the
// same way; every CTA runs ln2, and only the hidden chunks c with
// c % split == r, the fc2 partial sums meeting in distributed shared memory
// as in K2. The split is one whose clusters the card holds all at once (at
// 214 KB of shared memory per CTA an H100 holds 15 clusters of 8, so
// virtual<-point takes 4).
//
// Instances per width: launch 2 with kSplit false (split 1), kSplit true (a
// cluster) and kTimed, launch 1 with and without kTimed; the timed ones
// record where their CTA 0 spends its cycles (see comet_cross_block_fwd),
// and the forward's instances carry no counters.
#include <cmath>

#include "block_common.cuh"

namespace comet {
namespace {

constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kKvStages = 12;    // ring depth of launch 1
constexpr int kCrossStages = 8;  // ring depth of launch 2
constexpr int kInFlight = 2;     // wgmma groups in flight per warpgroup in the weight products

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  if constexpr (N == 48) wgmma_rs_n48(d, a, db, 1);
}

template <int C>
struct CrossPlan {
  static constexpr int H = 8;
  static constexpr int D = C / H;
  static constexpr int NQ = C / 4;  // columns of one product pass
  static constexpr int W = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);  // K/V box columns
  static constexpr int NCH = D / W;                                      // boxes per head
  static constexpr int x_bytes = kBlkRows * C * 2;
  static constexpr int h_bytes = kBlkRows * kHid * 2;  // one GELU'd hidden chunk
  static constexpr int kv_bytes = 2 * kKeys * D * 2;   // K and V of one head's key tile
  static constexpr int stage_bytes = NQ * 128 > kv_bytes ? NQ * 128 : kv_bytes;
  static_assert(stage_bytes % 1024 == 0 && D * 128 <= stage_bytes, "ring stages");
  // launch 1: LN_ctx, then its ring
  static constexpr int kv_bar_offset = x_bytes + kKvStages * stage_bytes;
  static constexpr int kv_smem = 1024 + kv_bar_offset + (1 + 2 * kKvStages) * 8;
  // launch 2: sX, sA, sH, then its ring
  static constexpr int ring_offset = 2 * x_bytes + h_bytes;
  static constexpr int bar_offset = ring_offset + kCrossStages * stage_bytes;
  static constexpr int smem = 1024 + bar_offset + (3 + 2 * kCrossStages) * 8;
  static_assert(kBlkRows * (C + 8) * 4 <= h_bytes + kCrossStages * stage_bytes, "partials fit");
  static_assert(128 * (D / 2 + 4) * 4 <= h_bytes, "a warpgroup's softmax state fits sH");
};

// ---- launch 1: LN_ctx (affine) + kv projection -----------------------------

// grid (ceil(Rk / 64), groups): CTA (x, y) takes context rows 64 x .. and the
// passes y * 8 / groups .. of the 8 passes of C/4 columns that make up K and
// V; warpgroup w takes every other one.
template <int C, bool kTimed>
__global__ void __launch_bounds__(kBlkThreads, 1) cross_kv_kernel(
    const __grid_constant__ CUtensorMap m_ctx, const __grid_constant__ CUtensorMap m_wkv,
    const bf16* __restrict__ gamma, const bf16* __restrict__ beta, const bf16* __restrict__ bkv,
    bf16* __restrict__ kv, int rk, int groups, long long* __restrict__ clocks) {
  using P = CrossPlan<C>;
  constexpr int NQ = P::NQ, KT = C / 64, S = kKvStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* sA = reinterpret_cast<bf16*>(base);  // ctx, then LN_ctx(ctx)
  bf16* ring = reinterpret_cast<bf16*>(base + P::x_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::kv_bar_offset);
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBlkRows;
  const int npass = 8 / groups, pass0 = blockIdx.y * npass;
  const bool timed = kTimed && blockIdx.x == 0 && blockIdx.y == 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const uint32_t t_start = kTimed ? clock32() : 0;

  if (warp >= 8) {
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(xbar, P::x_bytes);
      for (int kt = 0; kt < KT; ++kt) tma_load_2d(sA + kt * kTile, &m_ctx, xbar, kt * 64, row0);
      RingProducer<S> pr{ring, full, empty, P::stage_bytes / 2, 0, 0, false};
      uint64_t* bar;
      for (int p = 0; p < npass; p += 2)
        for (int kt = 0; kt < KT; ++kt)
          for (int w = 0; w < 2; ++w) {
            bf16* dst = pr.acquire(NQ * 128, &bar);
            tma_load_2d(dst, &m_wkv, bar, kt * 64, (pass0 + p + w) * NQ);
          }
    }
    return;
  }

  const int w = warp >> 2, lw = warp & 3;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  RingConsumer<S> rc{ring, full, empty, P::stage_bytes / 2, w, w, 0, 0, timed};
  mbar_wait(xbar, 0);
  layer_norm_swizzled<C, 4>([&](int r, int col) { return __bfloat162float(sA[swz(r, col)]); }, sA,
                         gamma, beta);
  fence_proxy_async();
  named_barrier(1, 256);
  if (timed && tid == 0) clocks[26] = clock32() - t_start;

  for (int p = w; p < npass; p += 2) {
    float acc[NQ / 2];
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
    ring_product<NQ, kInFlight>(acc, sA, KT, rc);
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      const int n = (pass0 + p) * NQ + j * 8 + t2;
      const float bb0 = __bfloat162float(bkv[n]), bb1 = __bfloat162float(bkv[n + 1]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = lw * 16 + g + hr * 8;
        if (row0 + r < rk)
          *reinterpret_cast<__nv_bfloat162*>(kv + (long long)(row0 + r) * 2 * C + n) =
              __floats2bfloat162_rn(round_bf16(acc[4 * j + 2 * hr]) + bb0,
                                    round_bf16(acc[4 * j + 2 * hr + 1]) + bb1);
      }
    }
  }
  if (timed && tid == 0) {
    clocks[27] = clock32() - t_start;
    clocks[28] = rc.waited;
    clocks[29] = rc.taken;
  }
}

// ---- launch 2: the query side and the rest of the block --------------------

// x1 = xn + (round(a Wout^T) + bout) for columns col0 + w NS .. + NS of
// warpgroup w, in place in sX.
template <int C, int NS, int G, int S>
__device__ __forceinline__ void out_projection_columns(bf16* sX, const bf16* sA,
                                                       const bf16* __restrict__ bout, int col0,
                                                       RingConsumer<S>& ring) {
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  float acc[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
  ring_product<NS, G>(acc, sA, C / 64, ring);
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {
    const int n = col0 + ring.w * NS + j * 8 + t2;
    const float bb0 = __bfloat162float(bout[n]), bb1 = __bfloat162float(bout[n + 1]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = lw * 16 + g + hr * 8;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(sX + swz(r, n));
      const float2 xn = __bfloat1622float2(*p);
      const float y0 = round_bf16(round_bf16(acc[4 * j + 2 * hr]) + bb0);
      const float y1 = round_bf16(round_bf16(acc[4 * j + 2 * hr + 1]) + bb1);
      *p = __floats2bfloat162_rn(xn.x + y0, xn.y + y1);
    }
  }
}

// The same for the D columns col0 .. at split 8: warpgroup w sums over
// k-tiles w KT/2 .., and warpgroup 1's f32 sums reach warpgroup 0 through
// `part` ([D / 2][128] f32), which adds them and writes x1.
template <int C, int G, int S>
__device__ __forceinline__ void out_projection_halves(bf16* sX, const bf16* sA,
                                                      const bf16* __restrict__ bout, int col0,
                                                      float* part, RingConsumer<S>& ring) {
  constexpr int D = C / 8, KT = C / 64;
  const int t = threadIdx.x & 127, lane = t & 31, lw = t >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  ring_product<D, G>(acc, sA + ring.w * (KT / 2) * kTile, KT / 2, ring);
  if (ring.w == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[i * 128 + t] = acc[i];
  }
  named_barrier(1, 256);
  if (ring.w == 1) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int n = col0 + j * 8 + t2;
    const float bb0 = __bfloat162float(bout[n]), bb1 = __bfloat162float(bout[n + 1]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = lw * 16 + g + hr * 8, i = 4 * j + 2 * hr;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(sX + swz(r, n));
      const float2 xn = __bfloat1622float2(*p);
      const float y0 = round_bf16(round_bf16(acc[i] + part[i * 128 + t]) + bb0);
      const float y1 = round_bf16(round_bf16(acc[i + 1] + part[(i + 1) * 128 + t]) + bb1);
      *p = __floats2bfloat162_rn(xn.x + y0, xn.y + y1);
    }
  }
}

template <int C, bool kSplit, bool kTimed>
__global__ void __launch_bounds__(kBlkThreads, 1) cross_block_kernel(
    const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_kv,
    const __grid_constant__ CUtensorMap m_q, const __grid_constant__ CUtensorMap m_out,
    const __grid_constant__ CUtensorMap m_outd, const __grid_constant__ CUtensorMap m_w1,
    const __grid_constant__ CUtensorMap m_w2, const bf16* __restrict__ bq,
    const bf16* __restrict__ bout, const bf16* __restrict__ b1, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int rows, int Lq, int Lk, int hidden,
    float scale_log2, int split_arg, long long* __restrict__ clocks) {
  using P = CrossPlan<C>;
  constexpr int D = P::D, H = P::H, W = P::W, NCH = P::NCH, KT = C / 64, S = kCrossStages;
  constexpr uint32_t SBO = 8 * W * 2;  // bytes between 8-row groups of a K/V box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* sX = reinterpret_cast<bf16*>(base);                   // x, ln1(x), then x1
  bf16* sA = reinterpret_cast<bf16*>(base + P::x_bytes);      // attention out, then ln2(x1)
  bf16* sH = reinterpret_cast<bf16*>(base + 2 * P::x_bytes);  // an MLP chunk
  bf16* ring = reinterpret_cast<bf16*>(base + P::ring_offset);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::bar_offset);
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;  // the x tile has landed
  uint64_t* xchg = xbar + 1;   // the other ranks' attention columns have landed
  uint64_t* xchg2 = xchg + 1;  // the other ranks' out-projection columns have landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = kSplit ? split_arg : 1;
  const int rank = kSplit ? blockIdx.x % split : 0;  // rank in the cluster that shares the tile
  const int row0 = blockIdx.x / split * kBlkRows;
  const int nchunks = hidden / kHid;
  const int ntiles = (Lk + kKeys - 1) / kKeys;
  const int seq_first = row0 / Lq;
  const int seq_last = (min(row0 + kBlkRows, rows) - 1) / Lq;
  // this rank's heads rank, rank + split, ...; with one head (split == H)
  // both warpgroups take it, each one half of its key tiles
  const int nh = H / split;
  const bool halves = nh == 1;
  const int half = (ntiles + 1) / 2;
  const int out0 = rank * (C / split);  // this rank's out-projection columns, if split
  const bool timed = kTimed && blockIdx.x == 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // the owning warpgroup's 4 warps
    }
    mbar_init(xbar, 1);
    if (split > 1) {
      mbar_init(xchg, 1);  // the other ranks' heads: 64 rows x D columns each
      mbar_expect_tx(xchg, (H - nh) * kBlkRows * D * 2);
      mbar_init(xchg2, 1);  // the other ranks' x1 columns
      mbar_expect_tx(xchg2, (C - C / split) * kBlkRows * 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (kSplit) cluster_sync();  // every CTA of the cluster has started, its barriers initialised
  const uint32_t t_start = kTimed ? clock32() : 0;

  if (warp >= 8) {  // producer: one thread issues every tile, in the consumers' order
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(xbar, P::x_bytes);
      for (int kt = 0; kt < KT; ++kt) tma_load_2d(sX + kt * kTile, &m_x, xbar, kt * 64, row0);
      RingProducer<S> pr{ring, full, empty, P::stage_bytes / 2, 0, 0, timed};
      uint64_t* bar;
      auto kv_tile = [&](int h, int seq, int t) {
        bf16* dst = pr.acquire(P::kv_bytes, &bar);
        for (int ch = 0; ch < NCH; ++ch) {
          tma_load_3d(dst + ch * kKeys * W, &m_kv, bar, h * D + ch * W, t * kKeys, seq);
          tma_load_3d(dst + kKeys * D + ch * kKeys * W, &m_kv, bar, C + h * D + ch * W,
                      t * kKeys, seq);
        }
      };
      for (int p = 0; p < (halves ? 1 : nh / 2); ++p) {
        const int h0 = rank + (halves ? 0 : 2 * p * split);
        const int h1 = halves ? h0 : h0 + split;
        for (int kt = 0; kt < KT; ++kt)
          for (int w = 0; w < 2; ++w) {
            bf16* dst = pr.acquire(D * 128, &bar);
            tma_load_2d(dst, &m_q, bar, kt * 64, (w ? h1 : h0) * D);
          }
        for (int seq = seq_first; seq <= seq_last; ++seq) {
          if (halves) {
            for (int j = 0; j < half; ++j) {
              kv_tile(h0, seq, j);
              if (half + j < ntiles) kv_tile(h0, seq, half + j);
            }
          } else {
            for (int t = 0; t < ntiles; ++t) {
              kv_tile(h0, seq, t);
              kv_tile(h1, seq, t);
            }
          }
        }
      }
      if (split > 1 && split < H) {
        const int ns = C / split / 2;  // a warpgroup's columns, in boxes of D rows
        for (int kt = 0; kt < KT; ++kt)
          for (int w = 0; w < 2; ++w) {
            bf16* dst = pr.acquire(ns * 128, &bar);
            for (int seg = 0; seg < ns / D; ++seg)
              tma_load_2d(dst + seg * D * 64, &m_outd, bar, kt * 64, out0 + w * ns + seg * D);
          }
      } else if (split > 1) {  // D columns, warpgroup w over k-tiles w KT/2 ..
        for (int kt = 0; kt < KT / 2; ++kt)
          for (int w = 0; w < 2; ++w) {
            bf16* dst = pr.acquire(D * 128, &bar);
            tma_load_2d(dst, &m_outd, bar, (w * (KT / 2) + kt) * 64, out0);
          }
      } else {
        produce_out_projection<C>(pr, &m_out);
      }
      produce_mlp<C>(pr, &m_w1, &m_w2, rank, split, nchunks);
      if (timed) {
        clocks[24] = pr.waited;
        clocks[25] = clock32() - t_start;
      }
    }
    if (split > 1) {  // the consumers' two cluster barriers in tail_output
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumers: warpgroup w, its warp lw owns rows 16 lw .. 16 lw + 15 of every
  // 64-row accumulator
  setmaxnreg_inc<232>();
  const int w = warp >> 2, lw = warp & 3;
  const int g = lane >> 2, t4 = lane & 3, t2 = t4 * 2;
  RingConsumer<S> rc{ring, full, empty, P::stage_bytes / 2, w, w, 0, 0, timed};
  const bool stamps = timed && tid % 128 == 0;
  auto stamp = [&](int at) {
    if (stamps) clocks[12 * w + at] = clock32() - t_start;
  };
  // the sequence whose attention row r keeps (rows past the end: the last)
  auto row_seq = [&](int r) { return min(row0 + r, rows - 1) / Lq; };

  // ln1(x) -> sX, in place (rows past the end are zero and stay finite)
  mbar_wait(xbar, 0);
  layer_norm_swizzled<C, 4>([&](int r, int col) { return __bfloat162float(sX[swz(r, col)]); }, sX);
  fence_proxy_async();
  named_barrier(1, 256);
  stamp(0);
  const uint32_t waited_before = rc.waited;

  float* state = reinterpret_cast<float*>(sH);  // warpgroup 1's softmax state, [D/2 + 4][128]
  for (int p = 0; p < (halves ? 1 : nh / 2); ++p) {
    const int h = rank + (halves ? 0 : (2 * p + w) * split);
    // q of head h: round(round(ln1(x) Wq_h^T) + bq_h), kept as bf16 A fragments
    uint32_t qa[D / 16][4];
    {
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      ring_product<D, kInFlight>(acc, sX, KT, rc);
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int n = h * D + 8 * (i >> 2) + t2;
        acc[i] = round_bf16(acc[i]) + __bfloat162float(bq[n]);
        acc[i + 1] = round_bf16(acc[i + 1]) + __bfloat162float(bq[n + 1]);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qa[kk][e] = pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
      }
    }

    for (int seq = seq_first; seq <= seq_last; ++seq) {
      // this warpgroup's key tiles t_lo .. t_lo + n - 1 of the sequence; its
      // j-th is ring tile first + 2 j + w
      const int t_lo = halves && w ? half : 0;
      const int n = halves ? (w ? ntiles - half : half) : ntiles;
      const int first = rc.next - w;
      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};
      float sacc[32];     // S of the current tile, later its exponentials
      uint32_t pa[4][4];  // P of the current tile as bf16 A fragments
      auto issue_s = [&](int j) {
        const bf16* cK = rc.wait(first + 2 * j + w);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ch = kk * 16 / W, off = kk * 16 % W;
          wgmma_rs_n64_kmajor(sacc, qa[kk], make_desc<W>(cK + ch * kKeys * W + off, 16, SBO),
                              kk > 0);
        }
        wgmma_commit();
      };
      if (n > 0) {
        // K1's loop: tile j's softmax runs while P V of tile j - 1 is in
        // flight, and S of tile j + 1 is issued before P V of tile j.
        issue_s(0);
        wgmma_wait<0>();
        fence_regs(sacc);
        for (int j = 0; j < n; ++j) {
          const int t = t_lo + j;
          if ((t + 1) * kKeys > Lk) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int key = t * kKeys + (i >> 2) * 8 + t2 + (i & 1);
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
          wgmma_wait<0>();  // P V of tile j - 1 is done: its stage is free
          fence_regs(oacc);
          if (j > 0) rc.release(first + 2 * (j - 1) + w);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pa[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
          if (j + 1 < n) issue_s(j + 1);
          const bf16* cV = ring + ((first + 2 * j + w) % S) * (P::stage_bytes / 2) + kKeys * D;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<D>(oacc, pa[kk], make_desc<W>(cV + kk * 16 * W, kKeys * W * 2, SBO));
          wgmma_commit();
          wgmma_wait<1>();  // S of tile j + 1 (committed first) is done
          fence_regs(sacc);
        }
        wgmma_wait<0>();
        fence_regs(oacc);
        rc.release(first + 2 * (n - 1) + w);
      }
      rc.next = first + (halves ? ntiles : 2 * ntiles) + w;

      if (halves) {
        // merge warpgroup 1's state into warpgroup 0's (thread t of either
        // holds the same rows and columns)
        const int t = tid & 127;
        if (w == 1) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) state[i * 128 + t] = oacc[i];
          state[(D / 2) * 128 + t] = m_run[0];
          state[(D / 2 + 1) * 128 + t] = m_run[1];
          state[(D / 2 + 2) * 128 + t] = l_run[0];
          state[(D / 2 + 3) * 128 + t] = l_run[1];
        }
        named_barrier(1, 256);
        if (w == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m1 = state[(D / 2 + r) * 128 + t];
            const float m = fmaxf(m_run[r], m1);  // m_run is finite: tile 0 has key 0
            const float a0 = exp2f((m_run[r] - m) * scale_log2);
            const float a1 = exp2f((m1 - m) * scale_log2);  // 0 for an empty half
            l_run[r] = l_run[r] * a0 + state[(D / 2 + 2 + r) * 128 + t] * a1;
#pragma unroll
            for (int i = 0; i < D / 2; ++i)
              if (((i >> 1) & 1) == r) oacc[i] = oacc[i] * a0 + state[i * 128 + t] * a1;
          }
        }
        named_barrier(1, 256);
      }
      if (!halves || w == 0) {
        const float inv0 = 1.f / quad_sum(l_run[0]);
        const float inv1 = 1.f / quad_sum(l_run[1]);
        const int r = lw * 16 + g;
        const bool keep0 = row_seq(r) == seq, keep1 = row_seq(r + 8) == seq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = h * D + j * 8 + t2;
          if (keep0)
            *reinterpret_cast<__nv_bfloat162*>(sA + swz(r, col)) =
                __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
          if (keep1)
            *reinterpret_cast<__nv_bfloat162*>(sA + swz(r + 8, col)) =
                __floats2bfloat162_rn(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
        }
      }
    }
  }
  fence_proxy_async();
  named_barrier(1, 256);
  stamp(1);
  if (stamps) clocks[12 * w + 10] = rc.waited - waited_before;

  if (split > 1) {
    // Send this rank's head columns to every peer's sA (16-byte chunks at the
    // same swizzled offsets), counted in bytes on the peer's exchange
    // barrier; wait until the peers' columns have landed in this CTA's.
    constexpr int per_head = kBlkRows * D / 8;
    for (int i = 1; i < split; ++i) {
      const int peer = (rank + i) % split;
      const uint32_t remote = cluster_addr(sA, peer), bar = cluster_addr(xchg, peer);
      for (int e = tid; e < nh * per_head; e += 256) {
        const int h = rank + e / per_head * split;
        const int off = swz(e % per_head / (D / 8), h * D + e % (D / 8) * 8);
        st_async_v4(remote + off * 2, *reinterpret_cast<const uint4*>(sA + off), bar);
      }
    }
    stamp(7);
    mbar_wait_cluster(xchg, 0);
    fence_proxy_async();
  }
  stamp(2);

  if (split > 1) {
    // x1 columns out0 + w ns .. + ns, then every rank's to every rank
    if (split == 2)
      out_projection_columns<C, C / 4, kInFlight>(sX, sA, bout, out0, rc);
    else if (split == 4)
      out_projection_columns<C, C / 8, kInFlight>(sX, sA, bout, out0, rc);
    else
      out_projection_halves<C, kInFlight>(sX, sA, bout, out0, reinterpret_cast<float*>(sH), rc);
    named_barrier(1, 256);
    const int chunks = C / split / 8;  // 16-byte chunks of a row
    for (int i = 1; i < split; ++i) {
      const int peer = (rank + i) % split;
      const uint32_t remote = cluster_addr(sX, peer), bar = cluster_addr(xchg2, peer);
      for (int e = tid; e < kBlkRows * chunks; e += 256) {
        const int off = swz(e / chunks, out0 + e % chunks * 8);
        st_async_v4(remote + off * 2, *reinterpret_cast<const uint4*>(sX + off), bar);
      }
    }
    mbar_wait_cluster(xchg2, 0);
  } else {
    tail_out_projection<C, kInFlight>(sX, sA, bout, rc);
  }
  stamp(3);
  tail_ln2<C>(sX, sA);
  stamp(4);
  float acc2[2][C / 8];
  tail_mlp<C, kInFlight>(sA, sH, b1, acc2, rank, split, nchunks, rc);
  stamp(5);
  tail_output<C, kSplit>(acc2, sX, reinterpret_cast<float*>(sH), b2, out, row0, rows, rank,
                         split);
  stamp(6);
  if (stamps) {
    clocks[12 * w + 8] = rc.waited;
    clocks[12 * w + 9] = rc.taken;
  }
}

template <int C>
int launch_cross(const bf16* x, const bf16* ctx, const bf16* gamma, const bf16* beta,
                 const bf16* wq, const bf16* bq, const bf16* wkv, const bf16* bkv,
                 const bf16* wout, const bf16* bout, const bf16* w1, const bf16* b1,
                 const bf16* w2, const bf16* b2, bf16* kv, bf16* out, int B, int Lq, int Lk,
                 int hidden, int split, int groups, long long* clocks, cudaStream_t stream) {
  using P = CrossPlan<C>;
  using KvKernel = decltype(&cross_kv_kernel<C, false>);
  using Kernel = decltype(&cross_block_kernel<C, false, false>);
  const int rk = B * Lk, rq = B * Lq;
  CUtensorMap m_ctx, m_wkv, m_x, m_kv, m_q, m_out, m_outd, m_w1, m_w2;
  const cuuint64_t kv_dims[3] = {static_cast<cuuint64_t>(2 * C), static_cast<cuuint64_t>(Lk),
                                 static_cast<cuuint64_t>(B)};
  const cuuint64_t kv_strides[2] = {static_cast<cuuint64_t>(2 * C) * 2,
                                    static_cast<cuuint64_t>(Lk) * 2 * C * 2};
  const cuuint32_t kv_box[3] = {P::W, kKeys, 1};
  if (!matrix_map(&m_ctx, ctx, rk, C, kBlkRows) || !matrix_map(&m_wkv, wkv, 2 * C, C, P::NQ) ||
      !matrix_map(&m_x, x, rq, C, kBlkRows) ||
      !make_tensor_map<P::W>(&m_kv, kv, 3, kv_dims, kv_strides, kv_box) ||
      !matrix_map(&m_q, wq, C, C, P::D) || !matrix_map(&m_out, wout, C, C, P::NQ) ||
      !matrix_map(&m_outd, wout, C, C, P::D) ||
      !matrix_map(&m_w1, w1, hidden, C, kHid / 2) || !matrix_map(&m_w2, w2, C, hidden, P::NQ))
    return -2;
  static bool configured = false;
  if (!configured) {
    const KvKernel kv_kernels[2] = {&cross_kv_kernel<C, false>, &cross_kv_kernel<C, true>};
    for (KvKernel k : kv_kernels) {
      cudaError_t err =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kv_smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const Kernel kernels[3] = {&cross_block_kernel<C, false, false>,
                               &cross_block_kernel<C, true, false>,
                               &cross_block_kernel<C, true, true>};
    for (Kernel k : kernels) {
      cudaError_t err =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    configured = true;
  }
  const KvKernel kv_kernel = clocks ? &cross_kv_kernel<C, true> : &cross_kv_kernel<C, false>;
  kv_kernel<<<dim3((rk + kBlkRows - 1) / kBlkRows, groups), kBlkThreads, P::kv_smem, stream>>>(
      m_ctx, m_wkv, gamma, beta, bkv, kv, rk, groups, clocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rq + kBlkRows - 1) / kBlkRows * split);
  cfg.blockDim = dim3(kBlkThreads);
  cfg.dynamicSmemBytes = P::smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(P::D)));
  const Kernel kernel = clocks      ? &cross_block_kernel<C, true, true>
                       : split > 1 ? &cross_block_kernel<C, true, false>
                                   : &cross_block_kernel<C, false, false>;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, m_x, m_kv, m_q, m_out, m_outd, m_w1,
                                             m_w2, bq, bout, b1, b2, out, rq, Lq, Lk, hidden,
                                             scale_log2, split, clocks));
}

}  // namespace
}  // namespace comet

// Returns 0 on success, -1 for arguments the kernel does not take (C, H, Lq
// not a multiple of 16, hidden, a split that is not 1, 2, 4 or 8, or a
// number of column groups that is not 1, 2 or 4), -2 if
// cuTensorMapEncodeTiled refuses a tensor map, else the CUDA error code of a
// launch. x and out are contiguous [B*Lq, C], ctx is contiguous [B*Lk, C];
// kv is a [B*Lk, 2C] bf16 scratch; weights are in the [out_features,
// in_features] layout: wq [C, C], wkv [2C, C], wout [C, C], w1 [hidden, C],
// w2 [C, hidden]; gamma, beta and every bias are bf16. `split` CTAs share
// each 64-row query tile (ops/block.py::cross_split) and `groups` CTAs each
// 64-row context tile (ops/block.py::cross_kv_groups). `clocks` is null, or
// 30 int64 that receive, from the timed instances, SM cycles since the
// CTA's start: for launch 2's CTA 0, consumer warpgroup w, at 12 w + 0..6
// the ends of ln1, q and attention, the exchange of attention columns, the
// out-projection, ln2, the MLP and the output; at 12 w + 7 the end of its
// pushes to the peers (before it waits for theirs), at 12 w + 8 the cycles
// it waited for ring tiles, at 12 w + 9 the tiles it took, at 12 w + 10 the
// cycles of those waits in q and attention; at 24 the producer's cycles
// waiting for a free stage and at 25 the end of its last issue; at 26 and 27
// the ends of LN_ctx and of the whole of launch 1's CTA 0, at 28 and 29 the
// cycles its warpgroup 0 waited for weight tiles and the tiles it took.
extern "C" int comet_cross_block_fwd(const void* x, const void* ctx, const void* gamma,
                                     const void* beta, const void* wq, const void* bq,
                                     const void* wkv, const void* bkv, const void* wout,
                                     const void* bout, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* kv, void* out, int B,
                                     int Lq, int Lk, int C, int H, int hidden, int split,
                                     int groups, void* clocks, void* stream) {
  using comet::bf16;
  if (Lq < 1 || Lq % 16 != 0 || Lk < 1 || hidden % comet::kHid != 0 || H != 8 ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      (groups != 1 && groups != 2 && groups != 4))
    return -1;
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
  long long* t = static_cast<long long*>(clocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 384)
    return comet::launch_cross<384>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9],
                                    a[10], a[11], a[12], a[13], k, o, B, Lq, Lk, hidden, split,
                                    groups, t, s);
  if (C == 256)
    return comet::launch_cross<256>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9],
                                    a[10], a[11], a[12], a[13], k, o, B, Lq, Lk, hidden, split,
                                    groups, t, s);
  return -1;
}

// How many clusters of `split` CTAs of launch 2 the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int comet_cross_block_clusters(int C, int split) {
  auto query = [&](auto kernel, int smem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = split;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split * 256);
    cfg.blockDim = dim3(comet::kBlkThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
  };
  if (C == 384)
    return query(comet::cross_block_kernel<384, true, false>, comet::CrossPlan<384>::smem);
  if (C == 256)
    return query(comet::cross_block_kernel<256, true, false>, comet::CrossPlan<256>::smem);
  return -1;
}

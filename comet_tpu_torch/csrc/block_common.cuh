// Pieces shared by the whole-block kernels K2 (block.cu) and K4
// (cross_block.cu) on Hopper: a CTA of 384 threads owns 64 rows, two
// consumer warpgroups run every weight product on wgmma from a ring of
// 64-column weight tiles that one producer thread fills by TMA, and the
// activations live in shared memory as K-major A operands in the 128-byte
// swizzled layout. The second half of a block, the same in K2 and K4
// (out-projection plus residual, LayerNorm, MLP, residual, and the cluster
// reduction of fc2's partial sums where a cluster shares a tile), is here
// once, as device functions on both sides of the ring.
//
// Rounding points are the TPU kernels' own: LayerNorms take f32 statistics
// and write bf16; each product is rounded to bf16 before its bias add, and
// the sum is rounded again; GELU is the tanh form on bf16 values.
#pragma once

#include "hopper.cuh"

namespace comet {
namespace {

constexpr int kBlkRows = 64;      // rows per CTA
constexpr int kBlkThreads = 384;  // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kHid = 128;         // MLP hidden columns per chunk (64 per warpgroup)
constexpr int kTile = 64 * 64;    // elements of one 64 x 64 swizzled A k-tile

// Element offset of (r, c) in a [K / 64][64 rows][64] buffer in the 128-byte
// swizzled layout (the 16-byte chunk c / 8 of row r moves to chunk (c / 8) ^
// (r % 8)): the K-major operand layout wgmma reads with a 128B descriptor,
// and the layout a TMA load of 64 x 64 boxes with the 128B swizzle writes.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kTile + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// GELU's tanh form, 0.5 x (1 + tanh(u)), written as x / (1 + exp(-2u)): the
// same function without the cancellation of 1 + tanh(u) at negative x, so
// the SFU's exponential keeps a small relative error over the whole range
// (tests/test_torch_port_cuda.py holds it to the exact form on every bf16
// value in [-8, 8]). Where exp(-2u) overflows the result is -0.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.f + __expf(-2.f * u));
}

// The SM's 32-bit cycle counter (differences are exact below 2^32 cycles).
__device__ __forceinline__ uint32_t clock32() {
  uint32_t c;
  asm volatile("mov.u32 %0, %%clock;\n" : "=r"(c));
  return c;
}

// Scale-free LayerNorm (eps 1e-6, f32 statistics) of 64 rows of width C by
// the 8 consumer warps, 8 rows each, R at a time (their loads and
// reductions overlap; R 4 is faster for rows from global memory and in
// place, R 1 from one buffer to another, in phase 3's cycle counts). Source
// row r comes from load(r, col), the result goes to dst in the swizzled
// layout (dst may be the source: a row is read whole before it is written).
// With gamma and beta, the affine of K4's context norm follows in bf16:
// round(round(ln * gamma) + beta).
template <int C, int R, typename Load>
__device__ __forceinline__ void layer_norm_swizzled(Load load, bf16* dst,
                                                    const bf16* __restrict__ gamma = nullptr,
                                                    const bf16* __restrict__ beta = nullptr) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp * 8; r0 < warp * 8 + 8; r0 += R) {
    float v[R][PER], mu[R], rstd[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      mu[q] = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[q][i] = load(r0 + q, lane + 32 * i);
        mu[q] += v[q][i];
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) mu[q] = warp_sum(mu[q]) * (1.f / C);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      rstd[q] = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[q][i] -= mu[q];
        rstd[q] += v[q][i] * v[q][i];
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) rstd[q] = rsqrtf(warp_sum(rstd[q]) * (1.f / C) + 1e-6f);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int col = lane + 32 * i;
      float ga = 1.f, be = 0.f;
      if (gamma != nullptr) ga = __bfloat162float(gamma[col]), be = __bfloat162float(beta[col]);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float y = v[q][i] * rstd[q];
        if (gamma != nullptr) y = round_bf16(round_bf16(y) * ga) + be;
        dst[swz(r0 + q, col)] = __float2bfloat16(y);
      }
    }
  }
}

// ---- the weight ring --------------------------------------------------------
//
// S stages of `stage_elems` bf16 each; stage s is filled when full[s]
// completes (the producer's expect_tx) and freed by 4 arrivals on empty[s]
// (the 4 warps of the warpgroup that took it). Tiles are numbered in the
// order the producer issues them; within a run of alternating tiles, a
// warpgroup's j-th tile is base + 2 j + its index.

// The producer thread's side.
template <int S>
struct RingProducer {
  bf16* tiles;
  uint64_t* full;
  uint64_t* empty;
  int stage_elems;
  int i;            // tiles issued
  uint32_t waited;  // cycles spent waiting for a free stage (timed instance)
  bool timed;

  // The stage of the next tile, once free, armed for `bytes`.
  __device__ __forceinline__ bf16* acquire(uint32_t bytes, uint64_t** bar) {
    const int s = i % S;
    if (i >= S) {
      const uint32_t t0 = timed ? clock32() : 0;
      mbar_wait(empty + s, ((i / S) - 1) & 1);
      if (timed) waited += clock32() - t0;
    }
    mbar_expect_tx(full + s, bytes);
    ++i;
    *bar = full + s;
    return tiles + s * stage_elems;
  }
};

// A consumer warpgroup's side.
template <int S>
struct RingConsumer {
  bf16* tiles;
  uint64_t* full;
  uint64_t* empty;
  int stage_elems;
  int w;            // the warpgroup, 0 or 1
  int next;         // ring index of its next tile of an alternating run
  int taken;        // tiles it has taken
  uint32_t waited;  // cycles spent waiting for a tile (timed instance)
  bool timed;

  __device__ __forceinline__ const bf16* wait(int i) {
    const uint32_t t0 = timed ? clock32() : 0;
    mbar_wait(full + i % S, (i / S) & 1);
    if (timed) waited += clock32() - t0;
    return tiles + (i % S) * stage_elems;
  }
  // After the warpgroup's products on tile i have retired.
  __device__ __forceinline__ void release(int i) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + i % S);
    ++taken;
  }
};

template <int N>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, 1);
  if constexpr (N == 48) wgmma_ss_n48(d, da, db, 1);
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, 1);
  if constexpr (N == 96) wgmma_ss_n96(d, da, db, 1);
  if constexpr (N == 144) wgmma_ss_n144(d, da, db, 1);
}

// Issues acc[64 x N] += A[64 x 64] B^T for one k-tile as one wgmma group: A
// a 64 x 64 swizzled tile, B an N-row weight tile of the ring (both
// K-major, 128B swizzle).
template <int N>
__device__ __forceinline__ void ktile_issue(float (&acc)[N / 2], const bf16* a, const bf16* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_kmajor<N>(acc, make_desc<64>(a + kk * 16, 16, 1024),
                    make_desc<64>(b + kk * 16, 16, 1024));
  wgmma_commit();
}

// acc[64 x N] += A B^T over the warpgroup's next nk ring tiles (one per
// k-tile of A, a swizzled [nk][64][64] buffer), with G (1 or 2) wgmma
// groups in flight: at 2, tile k + 1 is issued before tile k is waited for.
// A stage is released once its group has retired.
template <int N, int G, int S>
__device__ __forceinline__ void ring_product(float (&acc)[N / 2], const bf16* a, int nk,
                                             RingConsumer<S>& ring) {
  static_assert(G == 1 || G == 2, "one or two groups in flight");
  fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    ktile_issue<N>(acc, a + kt * kTile, ring.wait(ring.next + 2 * kt));
    if (G == 1) {
      wgmma_wait<0>();
      ring.release(ring.next + 2 * kt);
    } else if (kt > 0) {
      wgmma_wait<1>();
      ring.release(ring.next + 2 * (kt - 1));
    }
  }
  if (G == 2) {
    wgmma_wait<0>();
    ring.release(ring.next + 2 * (nk - 1));
  }
  fence_regs(acc);
  ring.next += 2 * nk;
}

// ---- the second half of a block ---------------------------------------------
//
// On entry sX holds the block's normalized input xn and sA the attention
// output a (both 64 x C, swizzled). Warpgroup w computes output columns
// w C/2 .. + C/2 of the out-projection and fc2 in two passes of C/4, and
// one half of each 128-wide hidden chunk of fc1. The producer issues the
// same tiles in the same order (produce_out_projection, produce_mlp).

// The producer's tiles for the out-projection, in the consumers' order.
template <int C, int S>
__device__ __forceinline__ void produce_out_projection(RingProducer<S>& ring,
                                                       const CUtensorMap* m_out) {
  constexpr int KT = C / 64, NQ = C / 4;
  uint64_t* bar;
  for (int q = 0; q < 2; ++q)
    for (int kt = 0; kt < KT; ++kt)
      for (int w = 0; w < 2; ++w) {
        bf16* dst = ring.acquire(NQ * 128, &bar);
        tma_load_2d(dst, m_out, bar, kt * 64, w * (C / 2) + q * NQ);
      }
}

// The producer's tiles for the MLP: for each hidden chunk c = rank, rank +
// split, ... fc1's k-tiles and fc2's, in the consumers' order.
template <int C, int S>
__device__ __forceinline__ void produce_mlp(RingProducer<S>& ring, const CUtensorMap* m_w1,
                                            const CUtensorMap* m_w2, int rank, int split,
                                            int nchunks) {
  constexpr int KT = C / 64, NQ = C / 4;
  uint64_t* bar;
  for (int c = rank; c < nchunks; c += split) {
    for (int kt = 0; kt < KT; ++kt)
      for (int w = 0; w < 2; ++w) {
        bf16* dst = ring.acquire(kHid / 2 * 128, &bar);
        tma_load_2d(dst, m_w1, bar, kt * 64, c * kHid + w * (kHid / 2));
      }
    for (int kt = 0; kt < kHid / 64; ++kt)
      for (int q = 0; q < 2; ++q)
        for (int w = 0; w < 2; ++w) {
          bf16* dst = ring.acquire(NQ * 128, &bar);
          tma_load_2d(dst, m_w2, bar, c * kHid + kt * 64, w * (C / 2) + q * NQ);
        }
  }
}

// x1 = xn + (round(a Wout^T) + bout), in place in sX.
template <int C, int G, int S>
__device__ __forceinline__ void tail_out_projection(bf16* sX, const bf16* sA,
                                                    const bf16* __restrict__ bout,
                                                    RingConsumer<S>& ring) {
  constexpr int KT = C / 64, NQ = C / 4;
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3, w = ring.w;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float acc[NQ / 2];
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
    ring_product<NQ, G>(acc, sA, KT, ring);
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      const int n = w * (C / 2) + q * NQ + j * 8 + t2;
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
  named_barrier(1, 256);
}

// ln2(x1) -> sA
template <int C>
__device__ __forceinline__ void tail_ln2(const bf16* sX, bf16* sA) {
  layer_norm_swizzled<C, 1>([&](int r, int col) { return __bfloat162float(sX[swz(r, col)]); },
                            sA);
  fence_proxy_async();
  named_barrier(1, 256);
}

// The MLP over the hidden chunks c = rank, rank + split, ... of kHid: fc1
// and GELU into sH (a [2][64][64] swizzled chunk), then fc2 into acc2,
// which stays in registers across chunks.
template <int C, int G, int S>
__device__ __forceinline__ void tail_mlp(const bf16* sA, bf16* sH, const bf16* __restrict__ b1,
                                         float (&acc2)[2][C / 8], int rank, int split,
                                         int nchunks, RingConsumer<S>& ring) {
  constexpr int KT = C / 64, NQ = C / 4;
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3, w = ring.w;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) acc2[q][i] = 0.f;
  }
  for (int c = rank; c < nchunks; c += split) {
    {
      float acc1[kHid / 4];
#pragma unroll
      for (int i = 0; i < kHid / 4; ++i) acc1[i] = 0.f;
      ring_product<kHid / 2, G>(acc1, sA, KT, ring);
      if (c > rank) named_barrier(1, 256);  // both warpgroups' fc2 is done with sH
#pragma unroll
      for (int j = 0; j < kHid / 16; ++j) {
        const int n = w * (kHid / 2) + j * 8 + t2;  // column within the chunk
        const float bb0 = __bfloat162float(b1[c * kHid + n]);
        const float bb1 = __bfloat162float(b1[c * kHid + n + 1]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = lw * 16 + g + hr * 8;
          const float h0 = round_bf16(round_bf16(acc1[4 * j + 2 * hr]) + bb0);
          const float h1 = round_bf16(round_bf16(acc1[4 * j + 2 * hr + 1]) + bb1);
          *reinterpret_cast<__nv_bfloat162*>(sH + swz(r, n)) =
              __floats2bfloat162_rn(gelu_tanh(h0), gelu_tanh(h1));
        }
      }
    }
    fence_proxy_async();
    named_barrier(1, 256);  // both halves of the chunk are in sH
    // fc2: k-tiles x passes (at G 2, consecutive groups accumulate into
    // different passes)
    fence_regs(acc2[0]);
    fence_regs(acc2[1]);
#pragma unroll
    for (int st = 0; st < 2 * (kHid / 64); ++st) {
      ktile_issue<NQ>(acc2[st & 1], sH + (st >> 1) * kTile, ring.wait(ring.next + 2 * st));
      if (G == 1) {
        wgmma_wait<0>();
        ring.release(ring.next + 2 * st);
      } else if (st > 0) {
        wgmma_wait<1>();
        ring.release(ring.next + 2 * (st - 1));
      }
    }
    if (G == 2) {
      wgmma_wait<0>();
      ring.release(ring.next + 2 * (2 * (kHid / 64) - 1));
    }
    fence_regs(acc2[0]);
    fence_regs(acc2[1]);
    ring.next += 2 * 2 * (kHid / 64);
  }
}

// out = x1 + (round(h W2^T) + b2) for the rows below `rows`. Where a
// cluster of `split` CTAs shares the tile, the f32 partial sums go to `red`
// ([64][C + 8] f32 in shared memory that no product reads any more); after a
// cluster barrier each CTA adds up one slice of the tile's column pairs over
// the cluster, in rank order, and writes it. The producer warpgroup of each
// CTA must meet the two cluster barriers.
template <int C, bool kSplit>
__device__ __forceinline__ void tail_output(const float (&acc2)[2][C / 8], const bf16* sX,
                                            float* red, const bf16* __restrict__ b2,
                                            bf16* __restrict__ out, int row0, int rows, int rank,
                                            int split) {
  constexpr int NQ = C / 4, LDR = C + 8;
  const int tid = threadIdx.x, lane = tid & 31, lw = (tid >> 5) & 3, w = tid >> 7;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  // the bias is read once per column pair, before any store
  auto put = [&](int r, int n, float s0, float s1, float bb0, float bb1) {
    if (row0 + r >= rows) return;
    const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sX + swz(r, n)));
    const float y0 = round_bf16(round_bf16(s0) + bb0);
    const float y1 = round_bf16(round_bf16(s1) + bb1);
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + r) * C + n) =
        __floats2bfloat162_rn(x1.x + y0, x1.y + y1);
  };
  if constexpr (!kSplit) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const int n = w * (C / 2) + q * NQ + j * 8 + t2;
        const float bb0 = __bfloat162float(b2[n]), bb1 = __bfloat162float(b2[n + 1]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          put(lw * 16 + g + hr * 8, n, acc2[q][4 * j + 2 * hr], acc2[q][4 * j + 2 * hr + 1], bb0,
              bb1);
      }
    }
  } else {
    named_barrier(1, 256);  // both warpgroups are past their last product
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const int n = w * (C / 2) + q * NQ + j * 8 + t2;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = lw * 16 + g + hr * 8;
          *reinterpret_cast<float2*>(red + r * LDR + n) =
              make_float2(acc2[q][4 * j + 2 * hr], acc2[q][4 * j + 2 * hr + 1]);
        }
      }
    }
    cluster_sync();
    constexpr int kPairs = kBlkRows * C / 2;
    const int per = (kPairs + split - 1) / split;
    const int stop = min(kPairs, (rank + 1) * per);
    for (int pr = rank * per + tid; pr < stop; pr += 256) {
      const int r = pr / (C / 2), n = pr % (C / 2) * 2;
      float2 v[8];  // every rank's partial, loaded before any is added
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < split) v[j] = ld_cluster_f2(red + r * LDR + n, j);
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < split) {
          sum.x += v[j].x;
          sum.y += v[j].y;
        }
      }
      put(r, n, sum.x, sum.y, __bfloat162float(b2[n]), __bfloat162float(b2[n + 1]));
    }
    cluster_sync();  // no CTA leaves while another still reads its partials
  }
}

// A [rows_, cols] row-major bf16 matrix as a 2D tensor map of 64-column,
// box_rows-row boxes with the 128B swizzle.
inline bool matrix_map(CUtensorMap* map, const bf16* p, int rows_, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows_)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return make_tensor_map<64>(map, p, 2, dims, strides, box);
}

}  // namespace
}  // namespace comet

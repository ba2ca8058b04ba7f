// The bf16 attention forward for Hopper (sm_90a) shared by two front-ends:
// B5, the generic flash forward (flash_attention.cu), and the fused MMDiT
// attention behind B1, B2 and B3 (mmdit_attention.cu). FlashAttention-3's
// forward for head_dim 128, on the primitives of hopper.cuh.
//
// Math per (batch*head, block of 128 q rows), bf16 in, f32 accumulate:
//   s = q k^T in the exp2 domain (q arrives prescaled by log2(e)/sqrt(128),
//       or, with FE::SCALE_S, the f32 scores are multiplied by s_scale);
//   online softmax per 128-key tile with an f32 running max m and sum l;
//   P rounded to bf16 against the running max for P.V; o / max(l, 1e-30).
// Masks apply only on tiles that need one (FE::valid(t) < 128 real keys:
// the ragged tail, kv_valid, the stream gap; or, with causal, keys past a
// row of the warpgroup); whole tiles skip them. A masked key's p is set
// to 0 explicitly, so a row with no real key in a tile adds nothing.
//
// Design.
//  * A block of 3 warpgroups owns 128 q rows. Warpgroup 0 is the producer
//    (setmaxnreg down to 24 registers): one thread TMA-loads the Q tile
//    once, then the K and V tiles of 128 keys into a ring of 2 stages (64
//    KB each; Q 32 KB; 160 KB in all; a third stage measured no faster,
//    fwd_variants.py) with separate mbarriers for K and V, so that a K
//    stage is refilled as soon as its QK^T is done and a V stage once its
//    P.V is. Every tile is two TMA boxes of 64 lanes x 128
//    rows in the 128-byte swizzle; rows past the tensor's extent read
//    zeros. Warpgroups 1 and 2 (240 registers) take 64 q rows each.
//  * S = Q K^T: wgmma m64n128k16 .f32.bf16.bf16 with Q and K K-major from
//    shared memory. O += P V: m64n128k16 with P from registers (the f32
//    score accumulator's pairs are the bf16 A fragment as they are) and V
//    MN-major (head dims contiguous).
//  * Overlap, as B7 (int8_attention.cu): the two consumers take turns at
//    the tensor cores (named barriers 1 and 2), one issuing its QK^T while
//    the other runs its softmax. Within a warpgroup each step waits once
//    for its QK^T and the last step's P.V, and issues the next QK^T as soon
//    as the scores are read (after the max, before the exponentials), so
//    that product runs under this step's exponentials and P.V. The last
//    step reissues its own QK^T (an unconditional issue keeps ptxas from
//    serialising the wgmmas).
//  * 2^x is ex2.approx.ftz: P is rounded to bf16 and summed beside the row
//    max's 1, where a term below 2^-126 changes nothing.
//
// A front-end FE (passed by value as a __grid_constant__, its tensor maps
// in parameter memory) provides: SCALE_S, s_scale, causal; q0() (the
// block's first q row), tiles(q0) (K/V tiles the block visits, from 0),
// valid(t) (leading real keys of tile t), load_q / load_k / load_v (the
// producer's TMA loads) and store(row, hr, o, l, m, tig) (the epilogue of
// one row half of a thread; l already >= 1e-30).

#pragma once

#include "hopper.cuh"

namespace {
namespace fwd {

constexpr int D = 128;             // head_dim
constexpr int BM = 128;            // q rows per block (2 x 64)
constexpr int BN = 128;            // keys per K/V tile
constexpr int THREADS = 384;       // producer + 2 consumer warpgroups
constexpr int STAGES = 2;          // K/V ring depth
constexpr int BOX = BN * 64 * 2;   // bytes of one box: 128 rows x 64 lanes
constexpr int TILE = 2 * BOX;      // bytes of a Q, K or V tile
constexpr int SMEM = 1024 + TILE + STAGES * 2 * TILE;
constexpr int BAR_PP = 1;          // named barriers 1, 2: the ping-pong
constexpr float NEG_BIG = -1e30f;  // the running max's start
constexpr float LN_2 = 0.6931471805599453f;

// Rows [row, row + 128) of lanes [lane0, lane0 + 128) as two boxes into a
// tile; completion counted on *bar.
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map, int lane0,
                                          int row, int z, uint64_t* bar) {
  tma_3d(dst, map, lane0, row, z, bar);
  tma_3d(dst + BOX, map, lane0 + 64, row, z, bar);
}

// The K-major descriptor of k-step kk (16 lanes) of a tile, from row row0.
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile,
                                          int row0, int kk) {
  return smem_desc(tile + (kk >> 2) * BOX + row0 * 128, 16, 1024) +
         2 * (kk & 3);
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = Q K^T of step st (this warpgroup's 64 rows x 128 keys), on its turn
// at the tensor cores, not waited for.
__device__ __forceinline__ void issue_qk(int st, float (&s)[64],
                                         uint64_t* full_k,
                                         const unsigned char* sQ,
                                         const unsigned char* ring, int cw) {
  const int stage = st % STAGES;
  mbar_wait(&full_k[stage], (st / STAGES) & 1);
  bar_sync(BAR_PP + cw, 256);
  const unsigned char* sK = ring + stage * 2 * TILE;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_bf16_ss<0, 0>(s, kdesc(sQ, 64 * cw, kk), kdesc(sK, 0, kk), kk);
  wgmma_commit();
  bar_arrive(BAR_PP + 1 - cw, 256);
}

// The tile's scores (times s_scale with SCALE_S) into pf, the row halves'
// maxima folded into mx. MASKED: keys from nv on, and with causal keys
// past the row, are -inf.
template <bool SCALE_S, bool MASKED>
__device__ __forceinline__ void scores(const float (&s)[64], float s_scale,
                                       int tig, int nv, int causal, int key0,
                                       const int (&row)[2], float (&pf)[64],
                                       float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float v = SCALE_S ? s[i] * s_scale : s[i];
      if (MASKED) {
        const int c = 8 * j + 2 * tig + (e & 1);
        if (c >= nv || (causal && key0 + c > row[e >> 1]))
          v = __int_as_float(0xff800000);    // -inf
      }
      pf[i] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
}

// p = 2^(s - m), 0 for a masked key, summed into the row halves' l.
template <bool MASKED>
__device__ __forceinline__ void probs(float (&pf)[64], const float (&m)[2],
                                      float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = (MASKED && pf[i] == __int_as_float(0xff800000))
                        ? 0.f
                        : exp2_ftz(pf[i] - m[(i >> 1) & 1]);
    pf[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

template <class FE>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ FE fe) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_k[STAGES], full_v[STAGES],
      empty_k[STAGES], empty_v[STAGES], qbar;
  // tiles on 1024-byte boundaries: the period of the 128-byte swizzle
  unsigned char* sQ =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sQ + TILE;      // stage s: K, then V
  const int q0 = fe.q0();
  const int steps = fe.tiles(q0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);     // lane 0 of each consumer warp
      mbar_init(&empty_v[s], 8);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && steps > 0) {
      mbar_expect_tx(&qbar, TILE);
      fe.load_q(sQ, q0, &qbar);
      for (int t = 0; t < steps; ++t) {
        const int s = t % STAGES, round = t / STAGES;
        unsigned char* sK = ring + s * 2 * TILE;
        if (t >= STAGES) mbar_wait(&empty_k[s], (round - 1) & 1);
        mbar_expect_tx(&full_k[s], TILE);
        fe.load_k(sK, t, &full_k[s]);
        if (t >= STAGES) mbar_wait(&empty_v[s], (round - 1) & 1);
        mbar_expect_tx(&full_v[s], TILE);
        fe.load_v(sK + TILE, t, &full_v[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;                    // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + 64 * cw;            // the warpgroup's first row
  const int row[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};

  // accumulator element 4j + e: row g + 8 (e >> 1) of the warp's 16,
  // column (key or head dim) 8j + 2 tig + (e & 1)
  float o[64], sacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = sacc[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  // accumulators are written by plain instructions only where no product
  // is in flight, and these fences keep the compiler from moving the
  // writes into one (ptxas would then serialize every wgmma)
  fence_regs(o);
  fence_regs(sacc);

  if (cw == 1) bar_arrive(BAR_PP, 256);    // warpgroup 0 goes first
  if (steps > 0) {
    mbar_wait(&qbar, 0);
    issue_qk(0, sacc, full_k, sQ, ring, cw);
  }
  int held = -1;         // V stage read by the P.V in flight
  for (int st = 0; st < steps; ++st) {
    const int s = st % STAGES;
    const int key0 = st * BN;
    const int nv = fe.valid(st);
    const bool masked = nv < BN || (fe.causal && key0 + BN - 1 > row0);
    wgmma_wait0();
    fence_regs(sacc);
    fence_regs(o);
    if (lane == 0) {
      mbar_arrive(&empty_k[s]);
      if (held >= 0) mbar_arrive(&empty_v[held]);
    }
    held = -1;

    float pf[64];
    float mx[2] = {m[0], m[1]};
    if (masked)
      scores<FE::SCALE_S, true>(sacc, fe.s_scale, tig, nv, fe.causal, key0,
                                row, pf, mx);
    else
      scores<FE::SCALE_S, false>(sacc, fe.s_scale, tig, nv, fe.causal, key0,
                                 row, pf, mx);
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], off));
      corr[hr] = exp2f(m[hr] - mx[hr]);
      m[hr] = mx[hr];
      l[hr] *= corr[hr];
    }
    // once the row maxima settle, most tiles leave them: skip the rescale
    // (a multiply by 1) when no row of the warp moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    }
    fence_regs(o);
    // the next QK^T runs under the exponentials and this P.V (at the last
    // step it reruns this one, whose K stage no load refills any more)
    issue_qk(st + 1 < steps ? st + 1 : st, sacc, full_k, sQ, ring, cw);
    if (masked)
      probs<true>(pf, m, l);
    else
      probs<false>(pf, m, l);
    uint32_t a[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      a[kk][0] = pack_bf16(pf[8 * kk], pf[8 * kk + 1]);
      a[kk][1] = pack_bf16(pf[8 * kk + 2], pf[8 * kk + 3]);
      a[kk][2] = pack_bf16(pf[8 * kk + 4], pf[8 * kk + 5]);
      a[kk][3] = pack_bf16(pf[8 * kk + 6], pf[8 * kk + 7]);
    }
    // V tile: keys x head dims 0..63, then keys x head dims 64..127
    mbar_wait(&full_v[s], (st / STAGES) & 1);
    const uint64_t dv = smem_desc(ring + s * 2 * TILE + TILE, BOX, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_bf16_rs(o, a[kk], dv + (uint64_t)(kk * 16 * 128 >> 4));
    wgmma_commit();
    held = s;
  }
  wgmma_wait0();
  fence_regs(o);
  fence_regs(sacc);
  if (held >= 0 && lane == 0) mbar_arrive(&empty_v[held]);
  if (cw == 0) bar_sync(BAR_PP, 256);    // warpgroup 1's last hand-over

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    fe.store(row[hr], hr, o, fmaxf(lt, 1e-30f), m[hr], tig);
  }
}

// One row half (hr) of a thread's o, times inv, as bf16 pairs at dst
// (the thread's columns 8j + 2 tig).
__device__ __forceinline__ void store_row(bf16* dst, const float (&o)[64],
                                          int hr, float inv, int tig) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * tig) =
        pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
}

template <class FE>
int launch(const FE& fe, dim3 grid, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<FE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<FE><<<grid, THREADS, SMEM, st>>>(fe);
  return (int)cudaGetLastError();
}

}  // namespace fwd

}  // namespace

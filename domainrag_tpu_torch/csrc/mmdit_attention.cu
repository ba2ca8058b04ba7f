// Fused MMDiT attention for Hopper (sm_90a): the Flux attention kernels
// of domainrag_tpu/ops/mmdit_attention.py in one source.
//
// Replaces, through the one-pass entry mmdit_attention (S <= 17408):
//   _joint_kernel (ops/mmdit_attention.py:400) - double block, joint
//       [txt; img] attention over the txt and img qkv GEMM outputs;
//   _seq_kernel   (ops/mmdit_attention.py:328) - single block, one stream
//       whose first 3*H*128 lanes are q/k/v (the MLP lanes are skipped);
// and, through the multi-pass entry mmdit_attention_mp
// (17408 < S <= 49152, the >= 2048 px fill):
//   _flash_mp_kernel (ops/mmdit_attention.py:533) behind its
//       _prep_norm_rope pass (:568), both variants.
// The joint variant is the single variant with two row sources: every
// row index r of the joint sequence maps to stream a (txt, r < s_a) or to
// stream b (img). The single block passes s_b = 0.
//
// Math per (batch, head), head_dim 128, bf16 in and out:
//   q, k  <- qk-RMSNorm (f32 stats, eps 1e-6, * w in f32, round to bf16)
//            then interleaved-pair RoPE in f32 (pair (x[2i], x[2i+1])
//            rotates by cos/sin[i]), rounded to bf16;
//   s     <- q k^T in f32, in the exp2 domain: the one-pass regime scales
//            q by log2(e)/sqrt(128) before its bf16 round (the TPU
//            one-pass kernels' rounding), the multi-pass regime rounds q
//            unscaled and multiplies the f32 scores (the TPU multi-pass
//            rounding) - two template instances of one streaming kernel;
//   o     <- softmax(s) v with f32 running max and sum, P rounded to bf16
//            for the P.V product; o / max(l, 1e-30).
//
// Bound on the card: 4*B*H*S^2*128 FLOP of the two products at 989
// TFLOP/s bf16. One-pass main path (B = 1, H = 24, S = 5337): 350 GFLOP,
// 0.35 ms. Multi-pass: 3.82 TFLOP, 3.86 ms at S = 17625 (2048 px fill);
// 12.5 TFLOP, 12.6 ms at S = 31866 (2800 px cap). The bytes (q/k/v lanes
// read once, o written once; 0.78 GB per batch element at 31866) take
// 0.23 ms at 3.35 TB/s, so every call is compute-bound; its B*H*S^2 exp2
// also load the special-function units.
//
// Design.
//  * The TPU kernel norms and ropes K once per (b, h) into VMEM at the
//    first q tile and relies on the grid running q tiles in order on one
//    core. CUDA blocks run in no order, so a small prep kernel
//    (norm_rope_kernel) writes normed, roped q and k once, into
//    (B, H, S, 128) scratch, at ~0.1 GB of traffic per call. v is never
//    copied: the attention kernel reads it in place from the GEMM output
//    with the caller's row stride, and the MLP lanes are never touched.
//  * The TPU kernel holds all of K in VMEM and takes the exact row max.
//    A Hopper block has at most 227 KB of shared memory, so
//    flash_kernel streams K/V in 64-row tiles with an online softmax
//    (FlashAttention-2 order): P is rounded to bf16 against the running
//    max, not the final one. Against the dense plain version this stays
//    within |err| <= 4e-3 + 2e-2*|ref| per element and 1e-2 in relative
//    Frobenius norm (bf16 output ulp plus the P rounding; measured by
//    chip_smoke.py).
//  * The products run on the tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate): a block of 4 warps owns 128 q rows, two
//    16-row tiles per warp (the FlashAttention-2 layout for head_dim 128),
//    so every K and V fragment read from shared memory feeds two mma.
//    With one 16-row tile per warp those shared-memory reads per FLOP
//    were the limiter, not occupancy (PERF.md, PR 1). It uses all 255
//    registers with a small spill. S = Q K^T stays in registers
//    and is reused as the A operand of P.V; Q fragments are re-read from
//    shared memory. K and V tiles are double-buffered through cp.async,
//    with an XOR swizzle of the 16-byte chunks so that ldmatrix reads are
//    free of bank conflicts. No padding copies: ragged tails (1241 text
//    rows, 5337 total) are zero-filled on load and masked to -1e30 in the
//    scores. wgmma, TMA and warp specialisation are left for later work.
//  * The multi-pass regime needs no kernel of its own on this card: the
//    TPU multi-pass kernel exists because a TPU core cannot hold 31k rows
//    of K in VMEM, and flash_kernel already streams K/V at any length
//    with O(1) shared memory. What differs is the rounding, so the
//    multi-pass entry runs the prep with q unscaled and the
//    flash_kernel<true> instance, which multiplies the f32 scores before
//    the mask. The TPU path's concat of the two streams and its padding
//    to 1024-row tiles are not carried over: the two row sources and the
//    masked ragged tails do the same without copies. Grid: ceil(S/128)
//    q tiles x H x B (249 x 24 x B at 31866); no reduction across blocks.
//    Offsets: at B = 4, S = 31866 and a 21504-lane row the GEMM output
//    spans 2.7e9 elements, past 2^31, so every element offset is 64-bit.

#include "common.cuh"

namespace {

constexpr int D = 128;          // head_dim
constexpr int MT = 2;           // 16-row q tiles per warp
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16 * MT;             // q rows per block (128)
constexpr int BN = 64;                          // kv rows per tile
constexpr int NT = BN / 8;                      // 8-column score tiles
constexpr int KV_ELEMS = BN * D;
constexpr int SMEM_BYTES = (BM + 4 * BN) * D * 2;  // Q + 2 K + 2 V (96 KB)
constexpr float NEG_INF = -1e30f;
constexpr float RMS_EPS = 1e-6f;

// Two row sources of one joint sequence: rows [0, s_a) of stream a, then
// rows [0, s_b) of stream b. Strides are in elements.
struct Rows {
  const bf16* a;
  long long a_batch, a_row;
  int s_a;
  const bf16* b;
  long long b_batch, b_row;
  int s_b;
};

__device__ __forceinline__ const bf16* row_ptr(const Rows& r, int batch,
                                               int row) {
  return row < r.s_a ? r.a + batch * r.a_batch + row * r.a_row
                     : r.b + batch * r.b_batch + (row - r.s_a) * r.b_row;
}

// ---------------------------------------------------------------------------
// prep: qk-RMSNorm + RoPE (+ q prescale) for one (batch, row, head) per warp
// ---------------------------------------------------------------------------

__global__ void norm_rope_kernel(Rows src, const float* wq_a,
                                 const float* wk_a, const float* wq_b,
                                 const float* wk_b, const float* cos_t,
                                 const float* sin_t, bf16* qs, bf16* ks,
                                 int batch, int heads, float q_scale) {
  const int s_tot = src.s_a + src.s_b;
  const long long warp_id =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id >= (long long)batch * s_tot * heads) return;
  const int h = (int)(warp_id % heads);
  const int row = (int)((warp_id / heads) % s_tot);
  const int bi = (int)(warp_id / ((long long)heads * s_tot));
  const bool in_a = row < src.s_a;
  const bf16* base = row_ptr(src, bi, row) + h * D + 4 * lane;
  const float c0 = cos_t[row * (D / 2) + 2 * lane];
  const float c1 = cos_t[row * (D / 2) + 2 * lane + 1];
  const float s0 = sin_t[row * (D / 2) + 2 * lane];
  const float s1 = sin_t[row * (D / 2) + 2 * lane + 1];
  const long long dst =
      (((long long)bi * heads + h) * s_tot + row) * D + 4 * lane;

#pragma unroll
  for (int which = 0; which < 2; ++which) {   // 0 = q, 1 = k
    const float* w = which == 0 ? (in_a ? wq_a : wq_b) : (in_a ? wk_a : wk_b);
    const uint2 raw = *reinterpret_cast<const uint2*>(base + which * heads * D);
    const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    float x[4] = {__low2float(p0), __high2float(p0), __low2float(p1),
                  __high2float(p1)};
    float ss = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss * (1.0f / D) + RMS_EPS);
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = bf16_round(x[i] * inv * w[4 * lane + i]);
    float r[4] = {y[0] * c0 - y[1] * s0, y[0] * s0 + y[1] * c0,
                  y[2] * c1 - y[3] * s1, y[2] * s1 + y[3] * c1};
    if (which == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] *= q_scale;
    }
    __nv_bfloat162 o0 = __floats2bfloat162_rn(r[0], r[1]);
    __nv_bfloat162 o1 = __floats2bfloat162_rn(r[2], r[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&o0);
    packed.y = *reinterpret_cast<uint32_t*>(&o1);
    *reinterpret_cast<uint2*>((which == 0 ? qs : ks) + dst) = packed;
  }
}

// ---------------------------------------------------------------------------
// tiles (PTX helpers in common.cuh)
// ---------------------------------------------------------------------------

// Element offset of 16-byte chunk c (0..15) of row `row` in a swizzled
// (rows, 128) bf16 tile: chunk c lives at c ^ (row & 7).
__device__ __forceinline__ int swz(int row, int c) {
  return row * D + ((c ^ (row & 7)) << 3);
}

// ROWS contiguous rows of 128 (row stride D) from `base`, rows >= limit 0.
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          int row0, int limit, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 16 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 4, c = idx & 15;
    const bool ok = row0 + row < limit;
    const bf16* src = ok ? base + (long long)(row0 + row) * D + c * 8 : base;
    cp_async16(tile + swz(row, c), src, ok);
  }
}

// ROWS rows of v's head slice, read in place from the two row sources.
template <int ROWS>
__device__ __forceinline__ void load_v_tile(bf16* tile, const Rows& v,
                                           int batch, int head, int row0,
                                           int limit, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 16 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 4, c = idx & 15;
    const bool ok = row0 + row < limit;
    const bf16* src =
        ok ? row_ptr(v, batch, row0 + row) + head * D + c * 8 : v.a;
    cp_async16(tile + swz(row, c), src, ok);
  }
}

// ---------------------------------------------------------------------------
// streaming attention over the prepped q/k and in-place v; each warp owns
// MT 16-row q tiles
// ---------------------------------------------------------------------------

// SCALE_S: multiply the f32 scores by s_scale (the multi-pass rounding);
// otherwise q arrives prescaled and s_scale is unused.
template <bool SCALE_S>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const bf16* qs, const bf16* ks, Rows v, bf16* out_a,
                 bf16* out_b, int heads, float s_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * D;
  bf16* sV = sK + 2 * KV_ELEMS;

  const int s_tot = v.s_a + v.s_b;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const long long head_off = ((long long)bi * heads + h) * s_tot * D;
  const bf16* qbase = qs + head_off;
  const bf16* kbase = ks + head_off;

  load_tile<BM>(sQ, qbase, q0, s_tot, tid);
  load_tile<BN>(sK, kbase, 0, s_tot, tid);
  load_v_tile<BN>(sV, v, bi, h, 0, s_tot, tid);
  cp_async_commit();

  const int n_kv = (s_tot + BN - 1) / BN;
  float o[MT][16][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      o[mt][t][0] = o[mt][t][1] = o[mt][t][2] = o[mt][t][3] = 0.f;
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const int wrow = warp * 16 * MT;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      load_tile<BN>(sK + (buf ^ 1) * KV_ELEMS, kbase, (j + 1) * BN, s_tot,
                    tid);
      load_v_tile<BN>(sV + (buf ^ 1) * KV_ELEMS, v, bi, h, (j + 1) * BN,
                      s_tot, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tk = sK + buf * KV_ELEMS;
    const bf16* tv = sV + buf * KV_ELEMS;

    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < NT; ++t)
        s[mt][t][0] = s[mt][t][1] = s[mt][t][2] = s[mt][t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(qa[mt], sQ + swz(wrow + 16 * mt + (lane & 15),
                                     2 * kk + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        const int mi = lane >> 3;
        uint32_t kb[4];
        ldmatrix_x4(kb, tk + swz(16 * p + ((mi >> 1) << 3) + (lane & 7),
                                 2 * kk + (mi & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * p], qa[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * p + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    if (SCALE_S) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][t][e] *= s_scale;
    }

    const int kv0 = j * BN;
    if (kv0 + BN > s_tot) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int col = kv0 + 8 * t + 2 * tig;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (col >= s_tot) s[mt][t][0] = s[mt][t][2] = NEG_INF;
          if (col + 1 >= s_tot) s[mt][t][1] = s[mt][t][3] = NEG_INF;
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][t][0], s[mt][t][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][t][2], s[mt][t][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float corr0 = exp2f(m[mt][0] - mx0);
      const float corr1 = exp2f(m[mt][1] - mx1);
      m[mt][0] = mx0;
      m[mt][1] = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        s[mt][t][0] = exp2f(s[mt][t][0] - mx0);
        s[mt][t][1] = exp2f(s[mt][t][1] - mx0);
        s[mt][t][2] = exp2f(s[mt][t][2] - mx1);
        s[mt][t][3] = exp2f(s[mt][t][3] - mx1);
        ps0 += s[mt][t][0] + s[mt][t][1];
        ps1 += s[mt][t][2] + s[mt][t][3];
      }
      l[mt][0] = l[mt][0] * corr0 + ps0;
      l[mt][1] = l[mt][1] * corr1 + ps1;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        o[mt][t][0] *= corr0;
        o[mt][t][1] *= corr0;
        o[mt][t][2] *= corr1;
        o[mt][t][3] *= corr1;
      }
    }

#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * jj][0], s[mt][2 * jj][1]);
        a[mt][1] = pack_bf16(s[mt][2 * jj][2], s[mt][2 * jj][3]);
        a[mt][2] = pack_bf16(s[mt][2 * jj + 1][0], s[mt][2 * jj + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * jj + 1][2], s[mt][2 * jj + 1][3]);
      }
#pragma unroll
      for (int t2 = 0; t2 < 8; ++t2) {
        const int mi = lane >> 3;
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, tv + swz(16 * jj + ((mi & 1) << 3) + (lane & 7),
                         2 * t2 + (mi >> 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * t2], a[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * t2 + 1], a[mt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int r0 = wrow + 16 * mt + g, r1 = r0 + 8;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int col = 8 * t + 2 * tig;
      const int c = col >> 3, e = col & 7;
      *reinterpret_cast<uint32_t*>(sQ + swz(r0, c) + e) =
          pack_bf16(o[mt][t][0] * inv0, o[mt][t][1] * inv0);
      *reinterpret_cast<uint32_t*>(sQ + swz(r1, c) + e) =
          pack_bf16(o[mt][t][2] * inv1, o[mt][t][3] * inv1);
    }
  }
  __syncthreads();

  const long long hd = (long long)heads * D;
#pragma unroll
  for (int i = 0; i < BM * 16 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 4, c = idx & 15;
    const int qrow = q0 + row;
    if (qrow >= s_tot) continue;
    bf16* dst = qrow < v.s_a
                    ? out_a + ((long long)bi * v.s_a + qrow) * hd
                    : out_b + ((long long)bi * v.s_b + qrow - v.s_a) * hd;
    *reinterpret_cast<uint4*>(dst + h * D + c * 8) =
        *reinterpret_cast<const uint4*>(sQ + swz(row, c));
  }
}

// Prep, then streaming attention. q_scale multiplies q before its bf16
// round; s_scale, with SCALE_S, the f32 scores.
template <bool SCALE_S>
int launch(Rows src, const void* wq_a, const void* wk_a, const void* wq_b,
           const void* wk_b, const void* cos_t, const void* sin_t, void* qs,
           void* ks, void* out_a, void* out_b, int batch, int heads,
           float q_scale, float s_scale, cudaStream_t st) {
  const int s_tot = src.s_a + src.s_b;
  const long long warps = (long long)batch * s_tot * heads;
  const int prep_threads = 256;
  const long long prep_blocks = (warps * 32 + prep_threads - 1) / prep_threads;
  norm_rope_kernel<<<(unsigned)prep_blocks, prep_threads, 0, st>>>(
      src, static_cast<const float*>(wq_a), static_cast<const float*>(wk_a),
      static_cast<const float*>(wq_b), static_cast<const float*>(wk_b),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(qs), static_cast<bf16*>(ks), batch, heads, q_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Rows vrows = src;
  vrows.a += 2 * heads * D;
  vrows.b += 2 * heads * D;
  err = cudaFuncSetAttribute(flash_kernel<SCALE_S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_tot + BM - 1) / BM, heads, batch);
  flash_kernel<SCALE_S><<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(ks), vrows,
      static_cast<bf16*>(out_a), static_cast<bf16*>(out_b), heads, s_scale);
  return (int)cudaGetLastError();
}

Rows make_rows(const void* a, long long a_batch, long long a_row, int s_a,
               const void* b, long long b_batch, long long b_row, int s_b) {
  return Rows{static_cast<const bf16*>(a), a_batch, a_row, s_a,
              static_cast<const bf16*>(b), b_batch, b_row, s_b};
}

}  // namespace

// q/k/v of each source stream sit at lane offsets 0, H*128 and 2*H*128 of
// rows `*_row` elements apart (9216 for the double block, 21504 for the
// single block with its MLP lanes). cos/sin: (s_a + s_b, 64) f32; norm
// weights: (128,) f32. qs/ks: (B, H, s_a + s_b, 128) bf16 scratch.
// out_a/out_b: (B, s_a, H*128) / (B, s_b, H*128) bf16. Both entries return
// the CUDA error code of their launches (0 = success).

// One-pass regime: `scale` (log2(e)/sqrt(128)) multiplies q before its
// bf16 round.
extern "C" int mmdit_attention(
    const void* a, long long a_batch, long long a_row, int s_a,
    const void* b, long long b_batch, long long b_row, int s_b,
    const void* wq_a, const void* wk_a, const void* wq_b, const void* wk_b,
    const void* cos_t, const void* sin_t, void* qs, void* ks, void* out_a,
    void* out_b, int batch, int heads, float scale, void* stream) {
  return launch<false>(make_rows(a, a_batch, a_row, s_a, b, b_batch, b_row,
                                 s_b),
                       wq_a, wk_a, wq_b, wk_b, cos_t, sin_t, qs, ks, out_a,
                       out_b, batch, heads, scale, 1.0f,
                       static_cast<cudaStream_t>(stream));
}

// Multi-pass regime (replaces _flash_mp_kernel): q is rounded unscaled and
// `scale` multiplies the f32 scores.
extern "C" int mmdit_attention_mp(
    const void* a, long long a_batch, long long a_row, int s_a,
    const void* b, long long b_batch, long long b_row, int s_b,
    const void* wq_a, const void* wk_a, const void* wq_b, const void* wk_b,
    const void* cos_t, const void* sin_t, void* qs, void* ks, void* out_a,
    void* out_b, int batch, int heads, float scale, void* stream) {
  return launch<true>(make_rows(a, a_batch, a_row, s_a, b, b_batch, b_row,
                                s_b),
                      wq_a, wk_a, wq_b, wk_b, cos_t, sin_t, qs, ks, out_a,
                      out_b, batch, heads, 1.0f, scale,
                      static_cast<cudaStream_t>(stream));
}

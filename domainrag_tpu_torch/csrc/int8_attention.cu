// int8 MMDiT attention for Hopper (sm_90a): the int8 modes of the fused
// Flux attention (B7 of the port).
//
// Replaces, through one entry (mmdit_attention_i8):
//   the int8_qk / int8_pv branches of _seq_kernel and _joint_kernel
//       (domainrag_tpu/ops/mmdit_attention.py:339-397, :416-504): one
//       pass, joint length S <= 17408;
//   _flash_mp_kernel_i8 (:638) behind _prep_norm_rope, _quant_bh and
//       _quant_bh_cols (:568-613): multi-pass, 17408 < S <= 49152.
//
// Math per (batch, head), head_dim 128, bf16 in and out, as the plain
// versions in ops/mmdit_attention.py (reference_i8_*, reference_mp_i8_*):
//  one pass:  q, k <- qk-RMSNorm (f32 stats, bf16 round after the weight)
//             and interleaved RoPE in f32, not rounded; q * log2(e)/sqrt(128).
//             q quantized per row, K per (b, h) tensor and per stream (txt,
//             img), V per column and per stream (int8 P.V only).
//             Single block: p = exp2((s - m_int) * s_q s_k) with the exact
//             integer row max; joint block: p = exp2(s * s_q s_k[stream] - m)
//             with the exact row max m in the real domain over both streams.
//  multi-pass: q, k normed, roped and rounded to bf16, quantized per (b, h)
//             over the concatenated sequence, the prescale folded into q's
//             scale; V per (b, h, column); s = (q8 k8^T) * s_q s_k; the
//             running max updated once per window of 1024 keys.
//  int8 P.V:  P_q = round(127 p) as int8 against the window's max, l = the
//             integer sum of P_q, o = sum_windows(P_q V_q) * s_vcol / l (the
//             127s cancel). QK only: P rounded to bf16, bf16 V, o / max(l,
//             1e-30).
//
// Bound on the card: 4*B*H*S^2*128 int8 operations at 1979 TOP/s (int8
// P.V; with bf16 P.V half the operations run at 989 TFLOP/s): at S = 5337
// 0.18 ms (0.27 ms QK only); 17625 tokens 1.93 ms; 31866 tokens 6.3 ms.
// The bytes (q/k/v lanes read once, o written once) are ~0.1-0.8 GB.
//
// Design.
//  * Where the row max comes from decides the quantisation grid of P, and
//    with it the result: at 17625 keys a typical probability is ~2^-6 of
//    the row max and rounds to 1 or 2 of 127, so a kernel streaming tiles
//    with its own running max lands several percent away. The int8 P.V
//    instance therefore makes two sweeps per max window (the whole row in
//    one pass, 1024 keys in multi-pass): sweep A loads K only, runs the
//    int8 QK^T and keeps the integer row max per stream from the s32
//    scores (no exp2f, no V); sweep B recomputes QK^T, quantizes P against
//    that max and accumulates P_q V_q. The QK-only instance rounds P to
//    bf16, which is nearly scale-free, and streams with an online max per
//    128-key tile.
//  * K and V scales need a reduction over the whole stream before anything
//    is quantized, and CUDA blocks run in no order: a stats kernel takes
//    the per-(b, h, stream) maxima with atomicMax (after a block reduction),
//    then a quant kernel writes q8 (with its row scales), k8 and, for P.V,
//    V8 transposed (head_dim-major, so that the P.V product's B operand is
//    K-major: keys contiguous). Both recompute the same normed, roped
//    values.
//  * The scratch lives in a padded row space (ops/mmdit_attention.py
//    _i8_plan): stream b starts at the first 128-row tile boundary after
//    stream a, so that no 128-key tile mixes two K or V scales; the int8
//    P.V multi-pass keeps the concatenation contiguous instead (one scale),
//    so that its 1024-key windows (8 tiles) count from the first row. Rows
//    in the gap and the tail are zero and masked, never counted as keys.
//  * Tensor cores through wgmma (sm_90a). A block of 3 warpgroups owns 128
//    q rows: warpgroup 0 is the producer (setmaxnreg down to 24 registers),
//    whose one thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//    swizzle) of the q tile once and of each K (and V) tile into a ring of
//    stages on mbarriers (4 stages: 32 KB each with int8 V, 48 KB with
//    bf16 V); warpgroups 1 and 2 (240 registers each) take 64 q rows each.
//    QK^T is m64n128k32 .s32.s8.s8 with A (q8) and B (k8) K-major from
//    shared memory. int8 P.V is m64n128k32 .s32.s8.s8 with A = P_q from
//    registers and B = the V8^T tile (K-major). The QK-only instance's P.V
//    is m64n128k16 .f32.bf16.bf16 with A = P from registers and B = bf16 V
//    MN-major (head dims contiguous), loaded in place from the qkv rows
//    through one 3-d tensor map per stream (lanes, rows, batch) whose row
//    extent is the stream's length: TMA's zero fill covers the gap and the
//    tail, so no row is located one by one. The row pitches (3*H*128 and
//    7*H*128 bf16) and batch strides are multiples of 16 bytes, as TMA
//    requires (the wrapper checks it).
//  * Operand layout. The s32 score accumulator gives each thread the key
//    pairs 8j + 2 tig + {0, 1} (j = 0..3) of every 32-key k-step; the 8-bit
//    A fragment wants 4 consecutive keys per register (4 tig .. 4 tig + 3
//    and 16 + 4 tig .. + 3). TMA cannot permute rows, so quant_kernel
//    writes V8^T's keys permuted within each 32-key group (vperm): key c
//    sits at the position where its score lands in A, at no cost. The bf16
//    A fragment matches the accumulator pairs as they are.
//  * Overlap. The two consumer warpgroups take turns at the tensor cores
//    (ping-pong on named barriers 1 and 2): one issues its QK^T while the
//    other runs its exp2, quantisation and l update. Within a warpgroup
//    each step waits once (wgmma.wait_group 0) for its QK^T and the last
//    step's P.V, and issues the next step's QK^T as soon as the scores are
//    consumed (after the max, before the exponentials and this step's
//    P.V), so that product runs under the softmax; the stage a P.V reads
//    is released after that wait. Loads run 4 stages ahead in the ring.
//  * The softmax, not the products, bounds the kernel at these widths: it
//    runs on the quarter-rate conversion and MUFU pipes. int -> f32 and
//    f32 -> int go through the mantissa of 1.5 * 2^23 (two full-rate
//    operations each, exact for |x| < 2^22), and whole tiles skip the
//    mask. The QK-only instance takes 2^x as ex2.approx.ftz (exp2f without
//    its subnormal fix-up; a term below 2^-126 beside the row max's 1
//    changes no bf16 P.V) and skips the o rescale when no row max of the
//    warp moved.
//  * Scores are exact in int32 (|s| <= 128 * 127^2); the per-window P.V
//    sums fit int32 (one pass: 17408 * 127^2 < 2^31). Offsets are 64-bit.
//    Exactness: the int8 P.V instance quantizes P with the same f32
//    operations in the same order as the plain version (__fmul_rn,
//    __fsub_rn, exp2f, round half to even); no ex2.approx and no
//    fast-math on that path.

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int D = 128;            // head_dim
constexpr int BM = 128;           // q rows per block (2 x 64)
constexpr int BN = 128;           // keys per tile
constexpr int THREADS = 384;      // producer + 2 consumer warpgroups
constexpr int WIN_TILES = 8;      // 1024-key max window of the multi-pass
constexpr int PREP_ROWS = 64;     // padded rows per prep block
constexpr int PREP_THREADS = 256;
constexpr int AMAX_V = 3;         // amax layout: k[2], q, v[2][128]
constexpr int AMAX_N = AMAX_V + 2 * D;
constexpr float RMS_EPS = 1e-6f;
constexpr float NEG_BIG = -1e30f;     // the running max's start (NEG_INF)
constexpr int BAR_PP = 1;             // named barriers 1, 2: the ping-pong

struct Rows {
  const bf16* a;
  long long a_batch, a_row;
  int s_a;
  const bf16* b;
  long long b_batch, b_row;
  int s_b;
};

// The padded row space: stream a at rows [0, s_a), stream b at
// [b0, b0 + s_b), n_pad rows in all.
struct Layout {
  int s_a, s_b, b0, n_pad;
  bool multipass;
};

// Stream (0 or 1) of padded row r, or -1 in the gap or the tail; its row
// within the stream in *lrow and its joint position in *pos.
__device__ __forceinline__ int locate(const Layout& L, int r, int* lrow,
                                      int* pos) {
  if (r < L.s_a) {
    *lrow = r;
    *pos = r;
    return 0;
  }
  if (r >= L.b0 && r < L.b0 + L.s_b) {
    *lrow = r - L.b0;
    *pos = L.s_a + r - L.b0;
    return 1;
  }
  return -1;
}

__device__ __forceinline__ const bf16* row_ptr(const Rows& R, int stream,
                                               int batch, int row) {
  return stream == 0 ? R.a + batch * R.a_batch + row * R.a_row
                     : R.b + batch * R.b_batch + row * R.b_row;
}

// Position, within its 32-key group of V8^T, of key c: where the thread
// holding c's score puts it in the 8-bit A fragment of the P.V product
// (score column 8j + 2 tig + e -> A key 16 (j >> 1) + 4 tig + 2 (j & 1) + e).
__device__ __forceinline__ int vperm(int c) {
  return 16 * ((c >> 4) & 1) + 4 * ((c >> 1) & 3) + 2 * ((c >> 3) & 1) +
         (c & 1);
}

// ---------------------------------------------------------------------------
// prep: norm + rope of one (row, head) per warp, 4 lanes of 128 per thread
// ---------------------------------------------------------------------------

// qk-RMSNorm (f32 stats, * inv, * w, round to bf16), then the pair rotation
// in f32 with no fused multiply-add (the plain version's separate ops).
__device__ __forceinline__ void norm_rope4(const bf16* src, const float* w,
                                           const float* cos_t,
                                           const float* sin_t, int pos,
                                           int lane, float (&r)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src + 4 * lane);
  const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float x[4] = {__low2float(p0), __high2float(p0), __low2float(p1),
                      __high2float(p1)};
  float ss = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss * (1.0f / D) + RMS_EPS);
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = bf16_round(__fmul_rn(__fmul_rn(x[i], inv), w[4 * lane + i]));
  const float c0 = cos_t[pos * (D / 2) + 2 * lane];
  const float c1 = cos_t[pos * (D / 2) + 2 * lane + 1];
  const float s0 = sin_t[pos * (D / 2) + 2 * lane];
  const float s1 = sin_t[pos * (D / 2) + 2 * lane + 1];
  r[0] = __fsub_rn(__fmul_rn(y[0], c0), __fmul_rn(y[1], s0));
  r[1] = __fadd_rn(__fmul_rn(y[0], s0), __fmul_rn(y[1], c0));
  r[2] = __fsub_rn(__fmul_rn(y[2], c1), __fmul_rn(y[3], s1));
  r[3] = __fadd_rn(__fmul_rn(y[2], s1), __fmul_rn(y[3], c1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float amax4(const float (&r)[4]) {
  return fmaxf(fmaxf(fabsf(r[0]), fabsf(r[1])), fmaxf(fabsf(r[2]),
                                                      fabsf(r[3])));
}

__device__ __forceinline__ float scale_of(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
}

__device__ __forceinline__ uint32_t quant4(const float (&r)[4], float s) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(r[i], s)), -127.f), 127.f);
    out |= (uint32_t)(uint8_t)(int8_t)q << (8 * i);
  }
  return out;
}

__device__ __forceinline__ void atomic_max_pos(float* p, float v) {
  atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
}

struct Prep {
  Rows src;
  const float *wq_a, *wk_a, *wq_b, *wk_b, *cos_t, *sin_t;
  Layout L;
  int heads;
  float prescale;
};

// The normed, roped q (which = 0) or k (which = 1) of one (row, head):
// one pass f32 (q prescaled), multi-pass rounded to bf16.
__device__ __forceinline__ void qk_values(const Prep& P, int which, int st,
                                          int bi, int lrow, int pos, int h,
                                          int lane, float (&r)[4]) {
  const float* w = which == 0 ? (st == 0 ? P.wq_a : P.wq_b)
                              : (st == 0 ? P.wk_a : P.wk_b);
  norm_rope4(row_ptr(P.src, st, bi, lrow) + (which * P.heads + h) * D, w,
             P.cos_t, P.sin_t, pos, lane, r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (P.L.multipass)
      r[i] = bf16_round(r[i]);
    else if (which == 0)
      r[i] = __fmul_rn(r[i], P.prescale);
  }
}

// Per (64 padded rows, head, batch) block: the maxima the scales come from.
template <bool PV>
__global__ void __launch_bounds__(PREP_THREADS)
    stats_kernel(Prep P, float* amax) {
  __shared__ float red[PREP_THREADS / 32][2];
  __shared__ float vred[PREP_THREADS / 32][D];
  const int r0 = blockIdx.x * PREP_ROWS, h = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float kmax = 0.f, qmax = 0.f, vmax[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < PREP_ROWS / (PREP_THREADS / 32); ++i) {
    const int r = r0 + warp + i * (PREP_THREADS / 32);
    int lrow, pos;
    const int st = locate(P.L, r, &lrow, &pos);
    if (st < 0) continue;
    float v4[4];
    qk_values(P, 1, st, bi, lrow, pos, h, lane, v4);
    kmax = fmaxf(kmax, amax4(v4));
    if (P.L.multipass) {
      qk_values(P, 0, st, bi, lrow, pos, h, lane, v4);
      qmax = fmaxf(qmax, amax4(v4));
    }
    if (PV) {
      const bf16* src = row_ptr(P.src, st, bi, lrow) + (2 * P.heads + h) * D;
      const uint2 raw = *reinterpret_cast<const uint2*>(src + 4 * lane);
      const __nv_bfloat162 p0 =
          *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 p1 =
          *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      vmax[0] = fmaxf(vmax[0], fabsf(__low2float(p0)));
      vmax[1] = fmaxf(vmax[1], fabsf(__high2float(p0)));
      vmax[2] = fmaxf(vmax[2], fabsf(__low2float(p1)));
      vmax[3] = fmaxf(vmax[3], fabsf(__high2float(p1)));
    }
  }
  kmax = warp_max(kmax);
  qmax = warp_max(qmax);
  if (lane == 0) {
    red[warp][0] = kmax;
    red[warp][1] = qmax;
  }
  if (PV)
#pragma unroll
    for (int i = 0; i < 4; ++i) vred[warp][4 * lane + i] = vmax[i];
  __syncthreads();
  // one pass never mixes two streams in a block (b0 is tile-aligned), and
  // multi-pass has one slot: the block's slot is that of its first valid
  // row
  float* am = amax + ((long long)bi * P.heads + h) * AMAX_N;
  int lr, ps;
  int bslot = -1;
  for (int r = r0; r < r0 + PREP_ROWS && bslot < 0; ++r)
    bslot = locate(P.L, r, &lr, &ps);
  if (bslot < 0) return;
  if (P.L.multipass) bslot = 0;
  if (threadIdx.x == 0) {
    float k = 0.f, q = 0.f;
    for (int w = 0; w < PREP_THREADS / 32; ++w) {
      k = fmaxf(k, red[w][0]);
      q = fmaxf(q, red[w][1]);
    }
    atomic_max_pos(am + bslot, k);
    if (P.L.multipass) atomic_max_pos(am + 2, q);
  }
  if (PV && threadIdx.x < D) {
    float v = 0.f;
    for (int w = 0; w < PREP_THREADS / 32; ++w)
      v = fmaxf(v, vred[w][threadIdx.x]);
    atomic_max_pos(am + AMAX_V + bslot * D + threadIdx.x, v);
  }
}

// Per (64 padded rows, head, batch) block: q8 with its row scales, k8, and
// (PV) V8 transposed through a shared tile, each 32-key group in vperm
// order. Gap and tail rows are zero.
template <bool PV>
__global__ void __launch_bounds__(PREP_THREADS)
    quant_kernel(Prep P, const float* amax, int8_t* q8, float* qsc,
                 int8_t* k8, int8_t* v8t) {
  __shared__ __align__(16) int8_t vt[D][PREP_ROWS + 16];
  const int r0 = blockIdx.x * PREP_ROWS, h = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bh = (long long)bi * P.heads + h;
  const float* am = amax + bh * AMAX_N;
  const long long n_pad = P.L.n_pad;
  for (int i = 0; i < PREP_ROWS / (PREP_THREADS / 32); ++i) {
    const int rr = warp + i * (PREP_THREADS / 32);
    const int r = r0 + rr;
    const int vc = (rr & ~31) | vperm(rr & 31);    // V8^T key position
    const long long off = (bh * n_pad + r) * D + 4 * lane;
    int lrow, pos;
    const int st = locate(P.L, r, &lrow, &pos);
    if (st < 0) {
      *reinterpret_cast<uint32_t*>(q8 + off) = 0u;
      *reinterpret_cast<uint32_t*>(k8 + off) = 0u;
      if (lane == 0) qsc[bh * n_pad + r] = 0.f;
      if (PV)
#pragma unroll
        for (int j = 0; j < 4; ++j) vt[4 * lane + j][vc] = 0;
      continue;
    }
    const int slot = P.L.multipass ? 0 : st;
    float v4[4];
    qk_values(P, 0, st, bi, lrow, pos, h, lane, v4);
    float sq;
    if (P.L.multipass) {
      const float s = scale_of(am[2]);
      sq = __fmul_rn(s, P.prescale);
      *reinterpret_cast<uint32_t*>(q8 + off) = quant4(v4, s);
    } else {
      sq = scale_of(warp_max(amax4(v4)));
      *reinterpret_cast<uint32_t*>(q8 + off) = quant4(v4, sq);
    }
    if (lane == 0) qsc[bh * n_pad + r] = sq;
    qk_values(P, 1, st, bi, lrow, pos, h, lane, v4);
    *reinterpret_cast<uint32_t*>(k8 + off) = quant4(v4, scale_of(am[slot]));
    if (PV) {
      const bf16* src = row_ptr(P.src, st, bi, lrow) + (2 * P.heads + h) * D;
      const uint2 raw = *reinterpret_cast<const uint2*>(src + 4 * lane);
      const __nv_bfloat162 p0 =
          *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 p1 =
          *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      const float x[4] = {__low2float(p0), __high2float(p0), __low2float(p1),
                          __high2float(p1)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * lane + j;
        const float s = scale_of(am[AMAX_V + slot * D + col]);
        vt[col][vc] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x[j], s)), -127.f),
                                    127.f);
      }
    }
  }
  if (PV) {
    __syncthreads();
    // 128 rows (head dims) of 64 key bytes: 512 chunks of 16 bytes
    for (int idx = threadIdx.x; idx < D * PREP_ROWS / 16;
         idx += PREP_THREADS) {
      const int d = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(v8t + (bh * D + d) * n_pad + r0 + 16 * c) =
          *reinterpret_cast<const uint4*>(&vt[d][16 * c]);
    }
  }
}

// ---------------------------------------------------------------------------
// attention
// ---------------------------------------------------------------------------

struct Attn {
  CUtensorMap tq, tk, tv8;   // q8, k8 (rows of 128 bytes), V8^T
  CUtensorMap tva, tvb;      // bf16 V in place, per stream (QK only)
  const float* qsc;
  const float* amax;
  Layout L;
  bf16* out_a;
  bf16* out_b;
  int heads;
  bool int_max;              // one-pass single block: integer-domain max
};

template <bool PV>
struct Ring {
  static constexpr int STAGES = 4;
  static constexpr int KBYTES = BN * D;                     // int8 K tile
  static constexpr int VBYTES = PV ? BN * D : 2 * BN * D;   // V8^T / bf16 V
  static constexpr int STAGE = KBYTES + VBYTES;
  static constexpr int SMEM = 1024 + BM * D + STAGES * STAGE;
};

// The stream whose K scale the tile [key0, key0 + BN) takes, and how many
// of its leading keys are real (the rest is the gap or the tail). No tile
// mixes two scales (_i8_plan); the contiguous layout (b0 == s_a) has one.
__device__ __forceinline__ void tile_keys(const Layout& L, int key0,
                                          int* st, int* nv) {
  int n;
  if (L.b0 == L.s_a) {
    *st = key0 < L.s_a ? 0 : 1;
    n = L.s_a + L.s_b - key0;
  } else if (key0 < L.b0) {
    *st = 0;
    n = L.s_a - key0;
  } else {
    *st = 1;
    n = L.b0 + L.s_b - key0;
  }
  *nv = max(0, min(BN, n));
}

// Step -> (tile, sweep B?): per window, sweep A over its tiles, then B.
template <bool PV>
__device__ __forceinline__ int step_tile(int st, int win, int n_tiles,
                                         bool* is_b) {
  if (!PV) {
    *is_b = true;
    return st;
  }
  const int w = st / (2 * win);
  const int off = st - w * 2 * win;
  const int n = min(win, n_tiles - w * win);
  *is_b = off >= n;
  return w * win + (off >= n ? off - n : off);
}

// Four values 0..127 as the bytes of one register, a first.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The softmax runs on the quarter-rate conversion and MUFU pipes, which
// bound this kernel; these two replace a conversion by two full-rate
// operations, exactly. i2f: int x as f32 for |x| <= 2^22 (scores are below
// 128 * 127^2 < 2^21, differences of two below 2^22), x added into the
// mantissa of 1.5 * 2^23, which is then subtracted. rint_i: rintf(v) as an
// int for |v| < 2^22, round half to even (__fadd_rn rounds v into that
// mantissa).
__device__ __forceinline__ float i2f(int x) {
  return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.0f);
}

__device__ __forceinline__ int rint_i(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
}

// Sweep B of one tile: P_q = round(127 p) against the window's max (the
// integer max with int_max), packed as the 8-bit A fragments of the four
// 32-key steps (the thread's keys 8j + 2 tig + {0, 1} are its fragment's
// 4 tig.. and 16 + 4 tig..; V8^T is stored in vperm order), and the row
// halves' integer sums. MASKED: keys from nv on are not real (p = 0).
template <bool MASKED>
__device__ __forceinline__ void quant_tile(const int (&s)[64],
                                           const float (&al)[2],
                                           const float (&m)[2],
                                           const int (&mint)[2],
                                           bool int_max, int tig, int nv,
                                           uint32_t (&a)[4][4],
                                           int (&lsum)[2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    int pq[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * kk + jj, hr = e >> 1;
        const int x = s[4 * j + e];
        const float arg =
            int_max ? __fmul_rn(i2f(x - mint[hr]), al[hr])
                    : __fsub_rn(__fmul_rn(i2f(x), al[hr]), m[hr]);
        const float p =
            (MASKED && 8 * j + 2 * tig + (e & 1) >= nv) ? 0.f : exp2f(arg);
        pq[jj][e] = rint_i(__fmul_rn(p, 127.0f));
        lsum[hr] += pq[jj][e];
      }
    a[kk][0] = pack_s8(pq[0][0], pq[0][1], pq[1][0], pq[1][1]);
    a[kk][1] = pack_s8(pq[0][2], pq[0][3], pq[1][2], pq[1][3]);
    a[kk][2] = pack_s8(pq[2][0], pq[2][1], pq[3][0], pq[3][1]);
    a[kk][3] = pack_s8(pq[2][2], pq[2][3], pq[3][2], pq[3][3]);
  }
}

// 2^x on the MUFU unit, results below 2^-126 flushed to zero: exp2f
// without its subnormal fix-up. Only for the QK-only instance, whose P is
// rounded to bf16 and summed beside the row max's 1, where a term below
// 2^-126 changes nothing; the int8 P.V instance keeps exp2f.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// QK only: the tile's scores in the real domain (keys from nv on -inf when
// MASKED), the row halves' maxima folded into mx.
template <bool MASKED>
__device__ __forceinline__ void real_scores(const int (&s)[64],
                                            const float (&al)[2], int tig,
                                            int nv, float (&pf)[64],
                                            float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = __fmul_rn(i2f(s[4 * j + e]), al[e >> 1]);
      if (MASKED && 8 * j + 2 * tig + (e & 1) >= nv)
        v = __int_as_float(0xff800000);    // -inf
      pf[4 * j + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
}

// s = q8 k8^T of step st (64 rows x 128 keys) into s, on this warpgroup's
// turn at the tensor cores (named barriers BAR_PP + cw), not waited for.
template <int STAGES, int STAGE>
__device__ __forceinline__ void issue_qk(int st, int (&s)[64],
                                         uint64_t* full,
                                         const unsigned char* ring,
                                         uint64_t dq, int cw) {
  const int stage = st % STAGES;
  mbar_wait(&full[stage], (st / STAGES) & 1);
  bar_sync(BAR_PP + cw, 256);
  const uint64_t dk = smem_desc(ring + stage * STAGE, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    wgmma_s8_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
  bar_arrive(BAR_PP + 1 - cw, 256);
}

// The int8 P.V instance at the end of a window or of a stream's keys: the
// integer sums folded into o (times the V column scales vs) and l.
__device__ __forceinline__ void fold_in(float (&o)[64], int (&oi)[64],
                                        float (&l)[2], int (&lsum)[2],
                                        const float* vs, int tig) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sv = vs[8 * j + 2 * tig + (e & 1)];
      o[4 * j + e] =
          __fadd_rn(o[4 * j + e], __fmul_rn(__int2float_rn(oi[4 * j + e]), sv));
      oi[4 * j + e] = 0;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] = __fadd_rn(l[hr], __int2float_rn(lsum[hr]));
    lsum[hr] = 0;
  }
}

// Sweep A: the row halves' integer maxima over the tile's real keys.
template <bool MASKED>
__device__ __forceinline__ void int_max_tile(const int (&s)[64], int tig,
                                             int nv, int (&tm)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!MASKED || 8 * j + 2 * tig + (e & 1) < nv)
        tm[e >> 1] = max(tm[e >> 1], s[4 * j + e]);
}

template <bool PV>
__global__ void __launch_bounds__(THREADS, 1)
    attn_kernel(const __grid_constant__ Attn A) {
  using R = Ring<PV>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[R::STAGES], empty[R::STAGES], qbar;
  __shared__ float vsc[2][D];
  // tiles on 1024-byte boundaries: the period of the 128-byte swizzle
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* sQ = reinterpret_cast<int8_t*>(smem);
  unsigned char* ring = smem + BM * D;

  const Layout L = A.L;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, bi = blockIdx.z;
  const long long bh = (long long)bi * A.heads + h;
  const long long n_pad = L.n_pad;
  const int n_tiles = L.n_pad / BN;
  const int win = (PV && L.multipass) ? WIN_TILES : n_tiles;
  const int steps = PV ? 2 * n_tiles : n_tiles;
  const float* am = A.amax + bh * AMAX_N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (PV) {
    for (int i = threadIdx.x; i < 2 * D; i += THREADS) {
      const int slot = L.multipass ? 0 : i / D;
      vsc[i / D][i % D] = scale_of(am[AMAX_V + slot * D + i % D]);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&qbar, BM * D);
      tma_2d(sQ, &A.tq, 0, (int)(bh * n_pad + q0), &qbar);
      for (int st = 0; st < steps; ++st) {
        const int s = st % R::STAGES;
        if (st >= R::STAGES) mbar_wait(&empty[s], (st / R::STAGES - 1) & 1);
        bool is_b;
        const int key0 = step_tile<PV>(st, win, n_tiles, &is_b) * BN;
        unsigned char* sK = ring + s * R::STAGE;
        unsigned char* sV = sK + R::KBYTES;
        mbar_expect_tx(&full[s], R::KBYTES + (is_b ? R::VBYTES : 0));
        tma_2d(sK, &A.tk, 0, (int)(bh * n_pad + key0), &full[s]);
        if (is_b) {
          if (PV) {
            tma_2d(sV, &A.tv8, key0, (int)(bh * D), &full[s]);
          } else {
            // bf16 V in place; stream b's rows start at b0 (a tile
            // boundary for this instance), zero past each stream's end
            const bool sb = key0 >= L.b0;
            const CUtensorMap* map = sb ? &A.tvb : &A.tva;
            const int row = sb ? key0 - L.b0 : key0;
            tma_3d(sV, map, h * D, row, bi, &full[s]);
            tma_3d(sV + BN * 128, map, h * D + 64, row, bi, &full[s]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;                    // consumer warpgroup 0 or 1
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const float ks[2] = {scale_of(am[0]),
                         scale_of(am[L.multipass ? 0 : 1])};
    float alpha[2][2];     // [row half][key stream]
    int mrow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + 64 * cw + 16 * warp + g + 8 * hr;
      mrow[hr] = r;
      const float sq = A.qsc[bh * n_pad + r];
      alpha[hr][0] = __fmul_rn(sq, ks[0]);
      alpha[hr][1] = __fmul_rn(sq, ks[1]);
    }
    const int b_tile = L.b0 / BN;      // first tile of stream b (one pass)
    const bool split = !L.multipass && L.s_b > 0;

    // accumulator element 4j + e: row g + 8 (e >> 1), column (key or head
    // dim) 8j + 2 tig + (e & 1)
    float o[64];
    int oi[64], sacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o[i] = 0.f;
      oi[i] = 0;
      sacc[i] = 0;
    }
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
    int imax[2][2] = {{INT_MIN, INT_MIN}, {INT_MIN, INT_MIN}};
    int mint[2] = {0, 0}, lsum[2] = {0, 0};
    // accumulators are written by plain instructions only where no product
    // is in flight, and these fences keep the compiler from moving the
    // writes into one (ptxas would then serialize every wgmma)
    fence_regs(o);
    fence_regs(oi);
    fence_regs(sacc);

    if (cw == 1) bar_arrive(BAR_PP, 256);    // warpgroup 0 goes first
    mbar_wait(&qbar, 0);
    const uint64_t dq = smem_desc(sQ + 64 * D * cw, 16, 1024);
    issue_qk<R::STAGES, R::STAGE>(0, sacc, full, ring, dq, cw);
    // Each step waits for its QK^T and for the previous step's P.V, then,
    // once the scores are consumed, issues the next step's QK^T, which runs
    // under this step's softmax and P.V. The stage the last P.V reads is
    // released, and a fold it ends is made, after that wait.
    int held = -1;       // stage read by the P.V in flight
    int fold = -1;       // V scale slot of the fold due after it
    for (int st = 0; st < steps; ++st) {
      const int s = st % R::STAGES;
      bool is_b;
      const int t = step_tile<PV>(st, win, n_tiles, &is_b);
      const int w0 = (t / win) * win;
      const int w1 = min(w0 + win, n_tiles);
      int kst, nv;
      tile_keys(L, t * BN, &kst, &nv);
      const unsigned char* sV = ring + s * R::STAGE + R::KBYTES;
      const bool next = st + 1 < steps;
      wgmma_wait0();
      fence_regs(sacc);
      if (PV)
        fence_regs(oi);
      else
        fence_regs(o);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = -1;
      if (PV && fold >= 0) {
        fold_in(o, oi, l, lsum, vsc[fold], tig);
        fence_regs(oi);
        fold = -1;
      }

      if (PV && !is_b) {
        // sweep A: the integer row max per stream over the window
        if (lane == 0) mbar_arrive(&empty[s]);
        if (t == w0) {
          imax[0][0] = imax[0][1] = imax[1][0] = imax[1][1] = INT_MIN;
        }
        int tm[2] = {INT_MIN, INT_MIN};
        if (nv < BN)
          int_max_tile<true>(sacc, tig, nv, tm);
        else
          int_max_tile<false>(sacc, tig, nv, tm);
        issue_qk<R::STAGES, R::STAGE>(next ? st + 1 : st, sacc, full, ring,
                                      dq, cw);
        if (kst == 0) {
          imax[0][0] = max(imax[0][0], tm[0]);
          imax[1][0] = max(imax[1][0], tm[1]);
        } else {
          imax[0][1] = max(imax[0][1], tm[0]);
          imax[1][1] = max(imax[1][1], tm[1]);
        }
        if (t == w1 - 1) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
              for (int off = 1; off <= 2; off <<= 1)
                imax[hr][k2] = max(imax[hr][k2],
                                   __shfl_xor_sync(0xffffffffu,
                                                   imax[hr][k2], off));
            if (A.int_max) {
              mint[hr] = imax[hr][0];
            } else {
              float mw = m[hr];
#pragma unroll
              for (int k2 = 0; k2 < 2; ++k2)
                if (imax[hr][k2] != INT_MIN)
                  mw = fmaxf(mw, __fmul_rn(__int2float_rn(imax[hr][k2]),
                                           alpha[hr][k2]));
              const float corr = exp2f(__fsub_rn(m[hr], mw));
              m[hr] = mw;
              l[hr] = __fmul_rn(l[hr], corr);
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                o[4 * j + 2 * hr] = __fmul_rn(o[4 * j + 2 * hr], corr);
                o[4 * j + 2 * hr + 1] =
                    __fmul_rn(o[4 * j + 2 * hr + 1], corr);
              }
            }
          }
        }
      } else if (PV) {
        // sweep B: P quantized against the window's max, int8 P.V
        uint32_t a[4][4];
        const float al[2] = {kst ? alpha[0][1] : alpha[0][0],
                             kst ? alpha[1][1] : alpha[1][0]};
        if (nv < BN)
          quant_tile<true>(sacc, al, m, mint, A.int_max, tig, nv, a, lsum);
        else
          quant_tile<false>(sacc, al, m, mint, A.int_max, tig, nv, a, lsum);
        issue_qk<R::STAGES, R::STAGE>(next ? st + 1 : st, sacc, full, ring,
                                      dq, cw);
        const uint64_t dv = smem_desc(sV, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 32; ++kk)
          wgmma_s8_rs(oi, a[kk], dv + 2 * kk);
        wgmma_commit();
        held = s;
        // end of a window or of a stream's keys: fold the integer sums in
        if (t == w1 - 1 || (split && t == b_tile - 1))
          fold = (split && t >= b_tile) ? 1 : 0;
      } else {
        // QK only: online softmax per tile, P rounded to bf16, bf16 V
        float pf[64];
        float mx[2] = {m[0], m[1]};
        const float al[2] = {kst ? alpha[0][1] : alpha[0][0],
                             kst ? alpha[1][1] : alpha[1][0]};
        if (nv < BN)
          real_scores<true>(sacc, al, tig, nv, pf, mx);
        else
          real_scores<false>(sacc, al, tig, nv, pf, mx);
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
        // once the row maxima settle, most tiles leave them: skip the
        // rescale (a multiply by 1) when no row of the warp moved
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
        // the next QK^T runs under the exponentials and this P.V (at the
        // last step it reruns this one, which keeps the issue unconditional)
        issue_qk<R::STAGES, R::STAGE>(next ? st + 1 : st, sacc, full, ring,
                                      dq, cw);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          pf[i] = ex2_ftz(pf[i] - m[(i >> 1) & 1]);
          l[(i >> 1) & 1] += pf[i];
        }
        uint32_t a[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          a[kk][0] = pack_bf16(pf[8 * kk], pf[8 * kk + 1]);
          a[kk][1] = pack_bf16(pf[8 * kk + 2], pf[8 * kk + 3]);
          a[kk][2] = pack_bf16(pf[8 * kk + 4], pf[8 * kk + 5]);
          a[kk][3] = pack_bf16(pf[8 * kk + 6], pf[8 * kk + 7]);
        }
        // V tile: keys x head dims 0..63, then keys x head dims 64..127
        const uint64_t dv = smem_desc(sV, BN * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_bf16_rs(o, a[kk], dv + (uint64_t)(kk * 16 * 128 >> 4));
        wgmma_commit();
        held = s;
      }
    }
    wgmma_wait0();
    fence_regs(o);
    fence_regs(oi);
    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
    if (PV && fold >= 0) fold_in(o, oi, l, lsum, vsc[fold], tig);
    if (cw == 0) bar_sync(BAR_PP, 256);    // warpgroup 1's last hand-over

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[hr];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      lt = fmaxf(lt, 1e-30f);
      int lrow, pos;
      const int st = locate(L, mrow[hr], &lrow, &pos);
      if (st < 0) continue;
      bf16* dst = (st == 0 ? A.out_a + ((long long)bi * L.s_a + lrow) *
                                           A.heads * D
                           : A.out_b + ((long long)bi * L.s_b + lrow) *
                                           A.heads * D) +
                  h * D;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(__fdiv_rn(o[4 * j + 2 * hr], lt),
                      __fdiv_rn(o[4 * j + 2 * hr + 1], lt));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launch
// ---------------------------------------------------------------------------

// (rows, inner) int8, inner a multiple of 16: boxes of 128 x 128 bytes.
bool map_i8(CUtensorMap* map, const int8_t* base, long long inner,
            long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};
  const cuuint32_t box[2] = {BN, 128};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides,
                  box);
}

// One stream's bf16 V lanes in place, (batch, rows, H*128) with row and
// batch strides in elements: boxes of 128 rows x 64 lanes.
bool map_v16(CUtensorMap* map, const bf16* v, int heads, int rows,
             long long row, long long batch_stride, int batch) {
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row * 2,
                                 (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {64, BN, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, dims, strides,
                  box);
}

template <bool PV>
int launch(const Prep& P, int8_t* q8, float* qsc, int8_t* k8, int8_t* v8t,
           float* amax, bf16* out_a, bf16* out_b, int batch,
           cudaStream_t st) {
  const dim3 grid(P.L.n_pad / PREP_ROWS, P.heads, batch);
  stats_kernel<PV><<<grid, PREP_THREADS, 0, st>>>(P, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_kernel<PV><<<grid, PREP_THREADS, 0, st>>>(P, amax, q8, qsc, k8,
                                                  v8t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Attn A;
  const long long rows = (long long)batch * P.heads * P.L.n_pad;
  bool ok = map_i8(&A.tq, q8, D, rows) && map_i8(&A.tk, k8, D, rows);
  if (PV) {
    ok = ok && map_i8(&A.tv8, v8t, P.L.n_pad, (long long)batch * P.heads * D);
    A.tva = A.tvb = A.tq;                   // not read
  } else {
    const Rows& R = P.src;
    ok = ok && map_v16(&A.tva, R.a + 2 * P.heads * D, P.heads, R.s_a,
                       R.a_row, R.a_batch, batch);
    if (R.s_b > 0)
      ok = ok && map_v16(&A.tvb, R.b + 2 * P.heads * D, P.heads, R.s_b,
                         R.b_row, R.b_batch, batch);
    else
      A.tvb = A.tva;                        // not read
    A.tv8 = A.tq;                           // not read
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  A.qsc = qsc;
  A.amax = amax;
  A.L = P.L;
  A.out_a = out_a;
  A.out_b = out_b;
  A.heads = P.heads;
  A.int_max = !P.L.multipass && P.L.s_b == 0;
  err = cudaFuncSetAttribute(attn_kernel<PV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<PV>::SMEM);
  if (err != cudaSuccess) return (int)err;
  attn_kernel<PV><<<dim3(P.L.n_pad / BM, P.heads, batch), THREADS,
                    Ring<PV>::SMEM, st>>>(A);
  return (int)cudaGetLastError();
}


}  // namespace

// One or two bf16 row sources as in mmdit_attention.cu (q/k/v of each at
// lane offsets 0, H*128, 2*H*128 of rows `*_row` elements apart; the single
// block passes s_b = 0). cos/sin: (s_a + s_b, 64) f32; norm weights (128,)
// f32. Scratch in the padded row space of n_pad rows (stream b from row
// b0; ops/mmdit_attention.py _i8_plan): q8, k8 (B, H, n_pad, 128) int8,
// qsc (B, H, n_pad) f32, v8t (B, H, 128, n_pad) int8 (read only with pv),
// amax (B, H, 259) f32 zeroed by the caller. out_a/out_b: (B, s_a, H*128) /
// (B, s_b, H*128) bf16. multipass: the multi-pass numerics. Returns the
// CUDA error code (0 = success).
extern "C" int mmdit_attention_i8(
    const void* a, long long a_batch, long long a_row, int s_a,
    const void* b, long long b_batch, long long b_row, int s_b,
    const void* wq_a, const void* wk_a, const void* wq_b, const void* wk_b,
    const void* cos_t, const void* sin_t, void* q8, void* qsc, void* k8,
    void* v8t, void* amax, void* out_a, void* out_b, int batch, int heads,
    int b0, int n_pad, int multipass, int pv, float prescale, void* stream) {
  // whole tiles; stream b on a tile boundary, except in the contiguous
  // layout of the int8 P.V multi-pass
  if (n_pad % BN || b0 < s_a || b0 + s_b > n_pad ||
      (b0 % BN && !(multipass && pv && b0 == s_a)))
    return (int)cudaErrorInvalidValue;
  Prep P;
  P.src = Rows{static_cast<const bf16*>(a), a_batch, a_row, s_a,
               static_cast<const bf16*>(b), b_batch, b_row, s_b};
  P.wq_a = static_cast<const float*>(wq_a);
  P.wk_a = static_cast<const float*>(wk_a);
  P.wq_b = static_cast<const float*>(wq_b);
  P.wk_b = static_cast<const float*>(wk_b);
  P.cos_t = static_cast<const float*>(cos_t);
  P.sin_t = static_cast<const float*>(sin_t);
  P.L = Layout{s_a, s_b, b0, n_pad, multipass != 0};
  P.heads = heads;
  P.prescale = prescale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t *q = static_cast<int8_t*>(q8), *k = static_cast<int8_t*>(k8),
         *vt = static_cast<int8_t*>(v8t);
  float *qs = static_cast<float*>(qsc), *am = static_cast<float*>(amax);
  bf16 *oa = static_cast<bf16*>(out_a), *ob = static_cast<bf16*>(out_b);
  return pv ? launch<true>(P, q, qs, k, vt, am, oa, ob, batch, st)
            : launch<false>(P, q, qs, k, vt, am, oa, ob, batch, st);
}

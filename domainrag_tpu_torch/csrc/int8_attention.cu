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
//    the row max and rounds to 1 or 2 of 127, so a kernel streaming 64-key
//    tiles with its own running max lands several percent away. The int8
//    P.V instance therefore makes two sweeps per max window (the whole row
//    in one pass, 1024 keys in multi-pass): sweep A computes the int8 QK^T
//    tiles for the exact integer row max only; sweep B recomputes them,
//    quantizes P against that max and accumulates P_q V_q. The extra QK^T
//    runs at the int8 rate. The QK-only instance rounds P to bf16, which is
//    nearly scale-free, and streams with an online max per 64-key tile as
//    the bf16 kernels do.
//  * K and V scales need a reduction over the whole stream before anything
//    is quantized, and CUDA blocks run in no order: a stats kernel takes
//    the per-(b, h, stream) maxima with atomicMax (after a block reduction),
//    then a quant kernel writes q8 (with its row scales), k8 and, for P.V,
//    V8 transposed (head_dim-major, so that the P.V MMA's B operand has its
//    keys contiguous). Both recompute the same normed, roped values.
//  * The scratch lives in a padded row space: one pass puts the second
//    stream at the first 64-aligned row after the first, so that no tile
//    mixes two K or V scales; multi-pass keeps the concatenation
//    contiguous, so that its 1024-key windows count from the first row.
//    Rows in the gap and the tail are masked, never computed as keys.
//  * int8 tensor cores through mma.sync m16n8k32 (s8 in, s32 out). A block
//    of 4 warps owns 64 q rows, 16 per warp. The score tile's register
//    layout (2 columns per thread per 8-column tile) differs from the A
//    operand layout of the P.V product (4 consecutive k per register); the
//    ldmatrix row addresses of K permute the keys within each 16-key group
//    so that each thread's scores are exactly its A fragment's keys, at no
//    cost. The bf16 P.V path permutes V's ldmatrix rows the same way.
//  * Scores are exact in int32 (|s| <= 128 * 127^2); the per-window P.V
//    sums fit int32 (one pass: 17408 * 127^2 < 2^31). Offsets are 64-bit.

#include <climits>

#include "common.cuh"

namespace {

constexpr int D = 128;            // head_dim
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;    // q rows per block
constexpr int BN = 64;            // keys per tile (and rows per prep block)
constexpr int NT = BN / 8;        // 8-key score tiles
constexpr int WIN_TILES = 16;     // 1024-key max window of the multi-pass
constexpr int PREP_THREADS = 256;
constexpr int AMAX_V = 3;         // amax layout: k[2], q, v[2][128]
constexpr int AMAX_N = AMAX_V + 2 * D;
constexpr float RMS_EPS = 1e-6f;
constexpr float NEG_BIG = -1e30f;     // the running max's start (NEG_INF)

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
  const int r0 = blockIdx.x * BN, h = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float kmax = 0.f, qmax = 0.f, vmax[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < BN / (PREP_THREADS / 32); ++i) {
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
  // one pass never mixes two streams in a block (b0 is 64-aligned), and
  // multi-pass has one slot: the block's slot is that of its first valid
  // row
  float* am = amax + ((long long)bi * P.heads + h) * AMAX_N;
  int lr, ps;
  int bslot = -1;
  for (int r = r0; r < r0 + BN && bslot < 0; ++r)
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
// (PV) V8 transposed through a shared tile. Gap and tail rows are zero.
template <bool PV>
__global__ void __launch_bounds__(PREP_THREADS)
    quant_kernel(Prep P, const float* amax, int8_t* q8, float* qsc,
                 int8_t* k8, int8_t* v8t) {
  __shared__ __align__(16) int8_t vt[D][BN + 16];
  const int r0 = blockIdx.x * BN, h = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bh = (long long)bi * P.heads + h;
  const float* am = amax + bh * AMAX_N;
  const long long n_pad = P.L.n_pad;
  for (int i = 0; i < BN / (PREP_THREADS / 32); ++i) {
    const int rr = warp + i * (PREP_THREADS / 32);
    const int r = r0 + rr;
    const long long off = (bh * n_pad + r) * D + 4 * lane;
    int lrow, pos;
    const int st = locate(P.L, r, &lrow, &pos);
    if (st < 0) {
      *reinterpret_cast<uint32_t*>(q8 + off) = 0u;
      *reinterpret_cast<uint32_t*>(k8 + off) = 0u;
      if (lane == 0) qsc[bh * n_pad + r] = 0.f;
      if (PV)
#pragma unroll
        for (int j = 0; j < 4; ++j) vt[4 * lane + j][rr] = 0;
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
        vt[col][rr] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x[j], s)), -127.f),
                                    127.f);
      }
    }
  }
  if (PV) {
    __syncthreads();
    // 128 rows (head dims) of 64 key bytes: 512 chunks of 16 bytes
    for (int idx = threadIdx.x; idx < D * BN / 16; idx += PREP_THREADS) {
      const int d = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(v8t + (bh * D + d) * n_pad + r0 + 16 * c) =
          *reinterpret_cast<const uint4*>(&vt[d][16 * c]);
    }
  }
}

// ---------------------------------------------------------------------------
// tiles (PTX helpers in common.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// Byte offset of 16-byte chunk c of row r: 128-byte rows (q8, k8 tiles;
// 8 chunks, c ^ (r & 7)) and 64-byte rows (V8^T tiles; 4 chunks,
// c ^ ((r >> 1) & 3)).
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// Key (0..63) of score element e of 8-column tile t for the thread with
// tig: the K ldmatrix rows are permuted so that the thread's 4 scores of
// a 16-key group are 4 consecutive keys (the A fragment of the P.V MMA).
__device__ __forceinline__ int key_of(int t, int e, int tig) {
  return 16 * (t >> 1) + 4 * tig + 2 * (t & 1) + (e & 1);
}

// ---------------------------------------------------------------------------
// attention
// ---------------------------------------------------------------------------

struct Attn {
  const int8_t* q8;
  const float* qsc;
  const int8_t* k8;
  const int8_t* v8t;
  Rows v;                  // bf16 V in place (QK-only instance)
  const float* amax;
  Layout L;
  bf16* out_a;
  bf16* out_b;
  int heads;
  bool int_max;            // one-pass single block: integer-domain max
};

// 64 x 128 int8 tile rows [row0, row0 + 64) of a (n_pad, 128) slab.
__device__ __forceinline__ void load_rows128(int8_t* tile, const int8_t* base,
                                             int row0, int tid) {
#pragma unroll
  for (int i = 0; i < BN * 8 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 3, c = idx & 7;
    cp_async16(tile + swz128(r, c), base + (long long)(row0 + r) * D + 16 * c,
               true);
  }
}

// V8^T keys [key0, key0 + 64) of all 128 head dims.
__device__ __forceinline__ void load_vt(int8_t* tile, const int8_t* base,
                                        long long n_pad, int key0, int tid) {
#pragma unroll
  for (int i = 0; i < D * 4 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int d = idx >> 2, c = idx & 3;
    cp_async16(tile + swz64(d, c), base + d * n_pad + key0 + 16 * c, true);
  }
}

// bf16 V rows of padded keys [key0, key0 + 64), read in place; zero in the
// gap and the tail.
__device__ __forceinline__ void load_v16(bf16* tile, const Attn& A, int bi,
                                         int h, int key0, int tid) {
#pragma unroll
  for (int i = 0; i < BN * 16 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 4, c = idx & 15;
    int lrow, pos;
    const int st = locate(A.L, key0 + r, &lrow, &pos);
    const bf16* src = st < 0 ? A.v.a
                             : row_ptr(A.v, st, bi, lrow) + h * D + 8 * c;
    cp_async16(tile + r * D + ((c ^ (r & 7)) << 3), src, st >= 0);
  }
}

// s = q8 k8^T for the warp's 16 rows and one 64-key tile (keys permuted
// as key_of says).
__device__ __forceinline__ void qk_tile(const int8_t* sQ, const int8_t* sK,
                                        int warp, int lane,
                                        int (&s)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sQ + swz128(warp * 16 + ((mi & 1) << 3) + r,
                               2 * kk + (mi >> 1)));
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      const int key = 16 * p + 4 * (r >> 1) + 2 * (mi >> 1) + (r & 1);
      ldmatrix_x4(b, sK + swz128(key, 2 * kk + (mi & 1)));
      mma_s8(s[2 * p], a, b[0], b[1]);
      mma_s8(s[2 * p + 1], a, b[2], b[3]);
    }
  }
}

template <bool PV>
__global__ void __launch_bounds__(THREADS) attn_kernel(Attn A) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem);
  int8_t* sK = sQ + BM * D;                        // 2 x 64 x 128
  unsigned char* sVraw = smem + BM * D + 2 * BN * D;
  __shared__ float vsc[2][D];

  const Layout L = A.L;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const long long bh = (long long)bi * A.heads + h;
  const long long n_pad = L.n_pad;
  const int8_t* qbase = A.q8 + bh * n_pad * D;
  const int8_t* kbase = A.k8 + bh * n_pad * D;
  const int8_t* vtbase = A.v8t + bh * D * n_pad;
  const float* am = A.amax + bh * AMAX_N;
  const int n_tiles = L.n_pad / BN;
  const int win = L.multipass ? WIN_TILES : n_tiles;
  const int steps = PV ? 2 * n_tiles : n_tiles;
  const int b_tile = L.b0 / BN;      // first tile of stream b (one pass)
  const bool split = !L.multipass && L.s_b > 0;

  if (PV) {
    for (int i = tid; i < 2 * D; i += THREADS) {
      const int slot = L.multipass ? 0 : i / D;
      vsc[i / D][i % D] = scale_of(am[AMAX_V + slot * D + i % D]);
    }
  }
  const float ks[2] = {scale_of(am[0]),
                       scale_of(am[L.multipass ? 0 : 1])};
  float alpha[2][2];     // [row half][key stream]
  int mrow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + warp * 16 + g + 8 * hr;
    mrow[hr] = r;
    const float sq = A.qsc[bh * n_pad + r];
    alpha[hr][0] = __fmul_rn(sq, ks[0]);
    alpha[hr][1] = __fmul_rn(sq, ks[1]);
  }

  // step -> (tile, sweep B?): per window, sweep A over its tiles, then B
  auto step_tile = [&](int st, bool* is_b) {
    if (!PV) {
      *is_b = true;
      return st;
    }
    const int w = st / (2 * win);
    const int off = st - w * 2 * win;
    const int n = min(win, n_tiles - w * win);
    *is_b = off >= n;
    return w * win + (off >= n ? off - n : off);
  };
  auto prefetch = [&](int st, int buf) {
    bool is_b;
    const int t = step_tile(st, &is_b);
    load_rows128(sK + buf * BN * D, kbase, t * BN, tid);
    if (is_b) {
      if (PV)
        load_vt(reinterpret_cast<int8_t*>(sVraw) + buf * BN * D, vtbase,
                n_pad, t * BN, tid);
      else
        load_v16(reinterpret_cast<bf16*>(sVraw) + buf * BN * D, A, bi, h,
                 t * BN, tid);
    }
  };

  load_rows128(sQ, qbase, q0, tid);
  prefetch(0, 0);
  cp_async_commit();

  float o[16][4];
  int oi[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    oi[t][0] = oi[t][1] = oi[t][2] = oi[t][3] = 0;
  }
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  int imax[2][2], mint[2] = {0, 0}, lsum[2] = {0, 0};

  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < steps) {
      prefetch(st + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bool is_b;
    const int t = step_tile(st, &is_b);
    const int key0 = t * BN;
    const int w0 = (t / win) * win;
    const int w1 = min(w0 + win, n_tiles);
    int s[NT][4];
    qk_tile(sQ, sK + buf * BN * D, warp, lane, s);

    if (PV && !is_b) {
      // sweep A: the integer row max per stream over the window
      if (t == w0) {
        imax[0][0] = imax[0][1] = imax[1][0] = imax[1][1] = INT_MIN;
      }
#pragma unroll
      for (int tt = 0; tt < NT; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int lr, ps;
          const int ks_ = locate(L, key0 + key_of(tt, e, tig), &lr, &ps);
          if (ks_ == 0)
            imax[e >> 1][0] = max(imax[e >> 1][0], s[tt][e]);
          else if (ks_ == 1)
            imax[e >> 1][1] = max(imax[e >> 1][1], s[tt][e]);
        }
      if (t == w1 - 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1)
              imax[hr][k2] = max(imax[hr][k2],
                                 __shfl_xor_sync(0xffffffffu, imax[hr][k2],
                                                 off));
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
            for (int d = 0; d < 16; ++d) {
              o[d][2 * hr] = __fmul_rn(o[d][2 * hr], corr);
              o[d][2 * hr + 1] = __fmul_rn(o[d][2 * hr + 1], corr);
            }
          }
        }
      }
    } else if (PV) {
      // sweep B: P quantized against the window's max, int8 P.V
      int pq[NT][4];
#pragma unroll
      for (int tt = 0; tt < NT; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          int lr, ps;
          const int kst = locate(L, key0 + key_of(tt, e, tig), &lr, &ps);
          float p = 0.f;
          if (kst >= 0) {
            p = A.int_max
                    ? exp2f(__fmul_rn(__int2float_rn(s[tt][e] - mint[hr]),
                                      alpha[hr][0]))
                    : exp2f(__fsub_rn(
                          __fmul_rn(__int2float_rn(s[tt][e]),
                                    kst ? alpha[hr][1] : alpha[hr][0]),
                          m[hr]));
          }
          pq[tt][e] = (int)rintf(__fmul_rn(p, 127.0f));
          lsum[hr] += pq[tt][e];
        }
      const int8_t* tv = reinterpret_cast<const int8_t*>(sVraw) + buf * BN * D;
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int kk = 0; kk < BN / 32; ++kk) {
        const int t0 = 4 * kk;
        uint32_t a[4];
        a[0] = pack_s8(pq[t0][0], pq[t0][1], pq[t0 + 1][0], pq[t0 + 1][1]);
        a[1] = pack_s8(pq[t0][2], pq[t0][3], pq[t0 + 1][2], pq[t0 + 1][3]);
        a[2] = pack_s8(pq[t0 + 2][0], pq[t0 + 2][1], pq[t0 + 3][0],
                       pq[t0 + 3][1]);
        a[3] = pack_s8(pq[t0 + 2][2], pq[t0 + 2][3], pq[t0 + 3][2],
                       pq[t0 + 3][3]);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, tv + swz64(16 * np + ((mi >> 1) << 3) + r,
                                    2 * kk + (mi & 1)));
          mma_s8(oi[2 * np], a, b[0], b[1]);
          mma_s8(oi[2 * np + 1], a, b[2], b[3]);
        }
      }
      // end of a window or of a stream's keys: fold the integer sums in
      if (t == w1 - 1 || (split && t == b_tile - 1)) {
        const int cs = (split && t >= b_tile) ? 1 : 0;
#pragma unroll
        for (int d = 0; d < 16; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sv = vsc[cs][8 * d + 2 * tig + (e & 1)];
            o[d][e] = __fadd_rn(o[d][e],
                                __fmul_rn(__int2float_rn(oi[d][e]), sv));
            oi[d][e] = 0;
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          l[hr] = __fadd_rn(l[hr], __int2float_rn(lsum[hr]));
          lsum[hr] = 0;
        }
      }
    } else {
      // QK only: online softmax per tile, P rounded to bf16, bf16 V
      float sf[NT][4];
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int tt = 0; tt < NT; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int lr, ps;
          const int kst = locate(L, key0 + key_of(tt, e, tig), &lr, &ps);
          sf[tt][e] = kst >= 0
                          ? __fmul_rn(__int2float_rn(s[tt][e]),
                                      kst ? alpha[e >> 1][1] : alpha[e >> 1][0])
                          : __int_as_float(0xff800000);    // -inf
          mx[e >> 1] = fmaxf(mx[e >> 1], sf[tt][e]);
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], off));
        const float corr = exp2f(m[hr] - mx[hr]);
        m[hr] = mx[hr];
        l[hr] *= corr;
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          o[d][2 * hr] *= corr;
          o[d][2 * hr + 1] *= corr;
        }
      }
#pragma unroll
      for (int tt = 0; tt < NT; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sf[tt][e] = exp2f(sf[tt][e] - m[e >> 1]);
          l[e >> 1] += sf[tt][e];
        }
      const bf16* tv = reinterpret_cast<const bf16*>(sVraw) + buf * BN * D;
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int jj = 0; jj < BN / 16; ++jj) {
        uint32_t a[4];
        a[0] = pack_bf16(sf[2 * jj][0], sf[2 * jj][1]);
        a[1] = pack_bf16(sf[2 * jj][2], sf[2 * jj][3]);
        a[2] = pack_bf16(sf[2 * jj + 1][0], sf[2 * jj + 1][1]);
        a[3] = pack_bf16(sf[2 * jj + 1][2], sf[2 * jj + 1][3]);
        // k-row k_l = 8 * (mi & 1) + r holds key 4 (r >> 1) + 2 (mi & 1)
        // + (r & 1) of the 16-key group
        const int vrow = 16 * jj + 4 * (r >> 1) + 2 * (mi & 1) + (r & 1);
#pragma unroll
        for (int t2 = 0; t2 < 8; ++t2) {
          uint32_t vb[4];
          const int c = 2 * t2 + (mi >> 1);
          ldmatrix_x4_trans(vb, tv + vrow * D + ((c ^ (vrow & 7)) << 3));
          mma_bf16(o[2 * t2], a, vb[0], vb[1]);
          mma_bf16(o[2 * t2 + 1], a, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }

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
    for (int d = 0; d < 16; ++d) {
      const int col = 8 * d + 2 * tig;
      *reinterpret_cast<uint32_t*>(dst + col) =
          pack_bf16(__fdiv_rn(o[d][2 * hr], lt),
                    __fdiv_rn(o[d][2 * hr + 1], lt));
    }
  }
}

template <bool PV>
int launch(const Prep& P, int8_t* q8, float* qsc, int8_t* k8, int8_t* v8t,
           float* amax, bf16* out_a, bf16* out_b, int batch,
           cudaStream_t st) {
  const dim3 grid(P.L.n_pad / BN, P.heads, batch);
  stats_kernel<PV><<<grid, PREP_THREADS, 0, st>>>(P, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_kernel<PV><<<grid, PREP_THREADS, 0, st>>>(P, amax, q8, qsc, k8,
                                                  v8t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Attn A;
  A.q8 = q8;
  A.qsc = qsc;
  A.k8 = k8;
  A.v8t = v8t;
  A.v = P.src;
  A.v.a += 2 * P.heads * D;
  A.v.b += 2 * P.heads * D;
  A.amax = amax;
  A.L = P.L;
  A.out_a = out_a;
  A.out_b = out_b;
  A.heads = P.heads;
  A.int_max = !P.L.multipass && P.L.s_b == 0;
  const int smem = BM * D + 2 * BN * D + 2 * BN * D * (PV ? 1 : 2);
  err = cudaFuncSetAttribute(attn_kernel<PV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  attn_kernel<PV><<<dim3(P.L.n_pad / BM, P.heads, batch), THREADS, smem,
                    st>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

// One or two bf16 row sources as in mmdit_attention.cu (q/k/v of each at
// lane offsets 0, H*128, 2*H*128 of rows `*_row` elements apart; the single
// block passes s_b = 0). cos/sin: (s_a + s_b, 64) f32; norm weights (128,)
// f32. Scratch in the padded row space of n_pad rows (stream b from row
// b0): q8, k8 (B, H, n_pad, 128) int8, qsc (B, H, n_pad) f32, v8t
// (B, H, 128, n_pad) int8 (read only with pv), amax (B, H, 259) f32 zeroed
// by the caller. out_a/out_b: (B, s_a, H*128) / (B, s_b, H*128) bf16.
// multipass: the multi-pass numerics (b0 = s_a); otherwise one pass (b0 =
// s_a rounded up to 64). Returns the CUDA error code (0 = success).
extern "C" int mmdit_attention_i8(
    const void* a, long long a_batch, long long a_row, int s_a,
    const void* b, long long b_batch, long long b_row, int s_b,
    const void* wq_a, const void* wk_a, const void* wq_b, const void* wk_b,
    const void* cos_t, const void* sin_t, void* q8, void* qsc, void* k8,
    void* v8t, void* amax, void* out_a, void* out_b, int batch, int heads,
    int b0, int n_pad, int multipass, int pv, float prescale, void* stream) {
  if (n_pad % BN || b0 < s_a || b0 + s_b > n_pad)
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

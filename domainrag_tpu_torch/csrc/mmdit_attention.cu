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
// The joint variant is the single variant with two row sources, stream a
// (txt) and stream b (img); the single block passes s_b = 0.
//
// Math per (batch, head), head_dim 128, bf16 in and out:
//   q, k  <- qk-RMSNorm (f32 stats, eps 1e-6, * w in f32, round to bf16)
//            then interleaved-pair RoPE in f32 (pair (x[2i], x[2i+1])
//            rotates by cos/sin[i]), rounded to bf16;
//   s     <- q k^T in f32, in the exp2 domain: the one-pass regime scales
//            q by log2(e)/sqrt(128) before its bf16 round (the TPU
//            one-pass kernels' rounding), the multi-pass regime rounds q
//            unscaled and multiplies the f32 scores (the TPU multi-pass
//            rounding) - two instances of one streaming kernel;
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
//    (norm_rope_kernel) writes normed, roped q and k once, into (B, H,
//    n_pad, 128) scratch, at ~0.1 GB of traffic per call. v is never
//    copied: the attention reads it in place from the GEMM output.
//  * The scratch lives in a padded row space (ops/mmdit_attention.py
//    _i8_plan with multipass = pv = False, the layout of B7's QK-only
//    instance): stream b starts at the first 128-row boundary b0 after
//    stream a, so no 128-key tile and no 128-row q block mixes txt and
//    img. V is read in place through one 3-d tensor map per stream
//    (lanes, rows, batch) whose row extent is the stream's length (row
//    pitch 9216 elements for the double block, 21504 for the single block,
//    whose MLP lanes are never read): a TMA box cannot take rows from two
//    streams, and TMA's zero fill covers the gap and the tail. The prep
//    writes the gap and tail rows of q and k as zeros, whose scores are 0,
//    not -inf: every tile that holds them is masked (valid()).
//  * The attention is the shared forward of flash_fwd.cuh (wgmma, TMA ring,
//    producer + 2 ping-pong consumer warpgroups; its header gives the
//    design); this file is its front-end: the padded row space, the
//    per-stream V maps and the epilogue, which writes each real row to
//    out_a or out_b by stream row (gap and tail rows are never stored).
//    The multi-pass regime needs no kernel of its own on this card (the
//    TPU multi-pass kernel exists because a TPU core cannot hold 31k rows
//    of K in VMEM; this one streams K/V at any length): what differs is
//    the rounding, so its entry runs the prep with q unscaled and the
//    SCALE_S instance. One launch of each kernel per call in both regimes.
//  * Offsets: at B = 4, S = 31866 and a 21504-lane row the GEMM output
//    spans 2.7e9 elements, past 2^31, so every element offset is 64-bit.

#include "flash_fwd.cuh"

namespace {

constexpr int D = fwd::D;
constexpr float RMS_EPS = 1e-6f;

// Two row sources of one joint sequence, strides in elements, and where
// they sit in the padded row space: stream a at rows [0, s_a), stream b
// at [b0, b0 + s_b), n_pad rows in all.
struct Rows {
  const bf16* a;
  long long a_batch, a_row;
  int s_a;
  const bf16* b;
  long long b_batch, b_row;
  int s_b;
  int b0, n_pad;
};

// ---------------------------------------------------------------------------
// prep: qk-RMSNorm + RoPE (+ q prescale) for one (batch, padded row, head)
// per warp; gap and tail rows are written as zeros
// ---------------------------------------------------------------------------

__global__ void norm_rope_kernel(Rows src, const float* wq_a,
                                 const float* wk_a, const float* wq_b,
                                 const float* wk_b, const float* cos_t,
                                 const float* sin_t, bf16* qs, bf16* ks,
                                 int batch, int heads, float q_scale) {
  const long long warp_id =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id >= (long long)batch * src.n_pad * heads) return;
  const int h = (int)(warp_id % heads);
  const int r = (int)((warp_id / heads) % src.n_pad);
  const int bi = (int)(warp_id / ((long long)heads * src.n_pad));
  const long long dst =
      (((long long)bi * heads + h) * src.n_pad + r) * D + 4 * lane;
  const bool in_a = r < src.s_a;
  if (!in_a && (r < src.b0 || r >= src.b0 + src.s_b)) {
    *reinterpret_cast<uint2*>(qs + dst) = make_uint2(0u, 0u);
    *reinterpret_cast<uint2*>(ks + dst) = make_uint2(0u, 0u);
    return;
  }
  const int lrow = in_a ? r : r - src.b0;      // row within the stream
  const int pos = in_a ? r : src.s_a + lrow;   // joint position (RoPE)
  const bf16* base = (in_a ? src.a + bi * src.a_batch + lrow * src.a_row
                           : src.b + bi * src.b_batch + lrow * src.b_row) +
                     h * D + 4 * lane;
  const float c0 = cos_t[pos * (D / 2) + 2 * lane];
  const float c1 = cos_t[pos * (D / 2) + 2 * lane + 1];
  const float s0 = sin_t[pos * (D / 2) + 2 * lane];
  const float s1 = sin_t[pos * (D / 2) + 2 * lane + 1];

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
    float rr[4] = {y[0] * c0 - y[1] * s0, y[0] * s0 + y[1] * c0,
                   y[2] * c1 - y[3] * s1, y[2] * s1 + y[3] * c1};
    if (which == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) rr[i] *= q_scale;
    }
    __nv_bfloat162 o0 = __floats2bfloat162_rn(rr[0], rr[1]);
    __nv_bfloat162 o1 = __floats2bfloat162_rn(rr[2], rr[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&o0);
    packed.y = *reinterpret_cast<uint32_t*>(&o1);
    *reinterpret_cast<uint2*>((which == 0 ? qs : ks) + dst) = packed;
  }
}

// ---------------------------------------------------------------------------
// the front-end of the shared forward (flash_fwd.cuh): grid (n_pad / 128,
// heads, batch)
// ---------------------------------------------------------------------------

// SCALE: multiply the f32 scores by s_scale (the multi-pass rounding);
// otherwise q arrives prescaled.
template <bool SCALE>
struct Fused {
  static constexpr bool SCALE_S = SCALE;
  static constexpr int causal = 0;
  CUtensorMap tq, tk;        // (B*H, n_pad, 128) prepped q and k
  CUtensorMap tva, tvb;      // each stream's V lanes in place
  bf16* out_a;               // (B, s_a, H*128)
  bf16* out_b;               // (B, s_b, H*128)
  int s_a, s_b, b0, n_pad, heads;
  float s_scale;

  __device__ int q0() const { return blockIdx.x * fwd::BM; }
  __device__ int tiles(int) const { return n_pad / fwd::BN; }
  // real keys at the start of tile t: no tile mixes the streams (b0 is a
  // tile boundary); the rest is the gap or the tail
  __device__ int valid(int t) const {
    const int key0 = t * fwd::BN;
    const int n = key0 < b0 ? s_a - key0 : b0 + s_b - key0;
    return max(0, min(fwd::BN, n));
  }
  __device__ int bh() const { return blockIdx.z * heads + blockIdx.y; }
  __device__ void load_q(unsigned char* dst, int q0_, uint64_t* bar) const {
    fwd::load_tile(dst, &tq, 0, q0_, bh(), bar);
  }
  __device__ void load_k(unsigned char* dst, int t, uint64_t* bar) const {
    fwd::load_tile(dst, &tk, 0, t * fwd::BN, bh(), bar);
  }
  __device__ void load_v(unsigned char* dst, int t, uint64_t* bar) const {
    const int key0 = t * fwd::BN;
    const bool sb = key0 >= b0;
    fwd::load_tile(dst, sb ? &tvb : &tva, blockIdx.y * D,
                   sb ? key0 - b0 : key0, blockIdx.z, bar);
  }
  __device__ void store(int r, int hr, const float (&o)[64], float l, float,
                        int tig) const {
    const long long hd = (long long)heads * D;
    bf16* dst;
    if (r < s_a)
      dst = out_a + ((long long)blockIdx.z * s_a + r) * hd;
    else if (r >= b0 && r < b0 + s_b)
      dst = out_b + ((long long)blockIdx.z * s_b + r - b0) * hd;
    else
      return;
    fwd::store_row(dst + blockIdx.y * D, o, hr, 1.f / l, tig);
  }
};

// Prep, then the attention. q_scale multiplies q before its bf16 round;
// s_scale, with SCALE, the f32 scores.
template <bool SCALE>
int launch(const Rows& src, const void* va, const void* vb, const void* wq_a,
           const void* wk_a, const void* wq_b, const void* wk_b,
           const void* cos_t, const void* sin_t, void* qs, void* ks,
           void* out_a, void* out_b, int batch, int heads, float q_scale,
           float s_scale, cudaStream_t st) {
  if (src.n_pad % fwd::BN || src.b0 % fwd::BN || src.b0 < src.s_a ||
      src.b0 + src.s_b > src.n_pad || src.s_a <= 0)
    return (int)cudaErrorInvalidValue;
  Fused<SCALE> fe;
  const int bh = batch * heads;
  bool ok = map_rows(&fe.tq, qs, src.n_pad, bh, fwd::BN) &&
            map_rows(&fe.tk, ks, src.n_pad, bh, fwd::BN) &&
            map_lanes(&fe.tva, va, heads * D, src.s_a, src.a_row,
                      src.a_batch, batch);
  if (src.s_b > 0)
    ok = ok && map_lanes(&fe.tvb, vb, heads * D, src.s_b, src.b_row,
                         src.b_batch, batch);
  else
    fe.tvb = fe.tva;                       // not read
  if (!ok) return (int)cudaErrorInvalidValue;

  const long long warps = (long long)batch * src.n_pad * heads;
  const int prep_threads = 256;
  const long long prep_blocks = (warps * 32 + prep_threads - 1) / prep_threads;
  norm_rope_kernel<<<(unsigned)prep_blocks, prep_threads, 0, st>>>(
      src, static_cast<const float*>(wq_a), static_cast<const float*>(wk_a),
      static_cast<const float*>(wq_b), static_cast<const float*>(wk_b),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(qs), static_cast<bf16*>(ks), batch, heads, q_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  fe.out_a = static_cast<bf16*>(out_a);
  fe.out_b = static_cast<bf16*>(out_b);
  fe.s_a = src.s_a;
  fe.s_b = src.s_b;
  fe.b0 = src.b0;
  fe.n_pad = src.n_pad;
  fe.heads = heads;
  fe.s_scale = s_scale;
  return fwd::launch(fe, dim3(src.n_pad / fwd::BM, heads, batch), st);
}

Rows make_rows(const void* a, long long a_batch, long long a_row, int s_a,
               const void* b, long long b_batch, long long b_row, int s_b,
               int b0, int n_pad) {
  return Rows{static_cast<const bf16*>(a), a_batch, a_row, s_a,
              static_cast<const bf16*>(b), b_batch, b_row, s_b, b0, n_pad};
}

}  // namespace

// q and k of each source stream sit at lane offsets 0 and H*128 of rows
// `*_row` elements apart (9216 for the double block, 21504 for the single
// block with its MLP lanes); va / vb point at the streams' V lanes (lane
// 2*H*128 of their first row). Row and batch strides are multiples of 8
// elements and every base 16-byte aligned (the tensor maps' rule).
// cos/sin: (s_a + s_b, 64) f32; norm weights: (128,) f32. The padded row
// space: stream b from row b0 (a multiple of 128, >= s_a), n_pad rows (a
// multiple of 128); qs/ks: (B, H, n_pad, 128) bf16 scratch. out_a/out_b:
// (B, s_a, H*128) / (B, s_b, H*128) bf16. Both entries return the CUDA
// error code of their launches (0 = success).

// One-pass regime: `scale` (log2(e)/sqrt(128)) multiplies q before its
// bf16 round.
extern "C" int mmdit_attention(
    const void* a, long long a_batch, long long a_row, int s_a,
    const void* b, long long b_batch, long long b_row, int s_b,
    const void* va, const void* vb, const void* wq_a, const void* wk_a,
    const void* wq_b, const void* wk_b, const void* cos_t, const void* sin_t,
    void* qs, void* ks, void* out_a, void* out_b, int batch, int heads,
    int b0, int n_pad, float scale, void* stream) {
  return launch<false>(
      make_rows(a, a_batch, a_row, s_a, b, b_batch, b_row, s_b, b0, n_pad),
      va, vb, wq_a, wk_a, wq_b, wk_b, cos_t, sin_t, qs, ks, out_a, out_b,
      batch, heads, scale, 1.0f, static_cast<cudaStream_t>(stream));
}

// Multi-pass regime (replaces _flash_mp_kernel): q is rounded unscaled and
// `scale` multiplies the f32 scores.
extern "C" int mmdit_attention_mp(
    const void* a, long long a_batch, long long a_row, int s_a,
    const void* b, long long b_batch, long long b_row, int s_b,
    const void* va, const void* vb, const void* wq_a, const void* wk_a,
    const void* wq_b, const void* wk_b, const void* cos_t, const void* sin_t,
    void* qs, void* ks, void* out_a, void* out_b, int batch, int heads,
    int b0, int n_pad, float scale, void* stream) {
  return launch<true>(
      make_rows(a, a_batch, a_row, s_a, b, b_batch, b_row, s_b, b0, n_pad),
      va, vb, wq_a, wk_a, wq_b, wk_b, cos_t, sin_t, qs, ks, out_a, out_b,
      batch, heads, 1.0f, scale, static_cast<cudaStream_t>(stream));
}

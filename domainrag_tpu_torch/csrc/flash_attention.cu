// Generic flash attention for Hopper (sm_90a): forward (B5) and backward
// (B6) of domainrag_tpu/ops/attention.py in one source.
//
// Replaces:
//   B5 _flash_kernel_1pass (ops/attention.py:110) and _flash_kernel (:43),
//      both behind _flash_forward (:184): one streaming forward serves
//      both TPU regimes (whole KV in one VMEM block up to 49152 tokens,
//      KV blocks above) - CUDA blocks cannot hold the whole KV, and a
//      kernel that streams KV with an online softmax needs no second regime;
//   B6 _flash_bwd_dq_kernel (:296) and _flash_bwd_dkv_kernel (:336),
//      behind _flash_backward (:382). In each dtype one kernel computes all
//      three gradients (below), where the TPU splits dq from dk/dv and
//      recomputes S and dP in each.
//
// Layout: q/k/v/out/dout (B*H, S, 128) contiguous, head_dim padded to 128
// by the wrapper (ops/attention.py); lse and delta (B*H, Sq) f32 (the
// backward: rows zero padded to a multiple of 64).
//
// Math (as the TPU kernels):
//   forward  q arrives prescaled by log2(e)/sqrt(D) and rounded to its
//            dtype; s = q k^T in f32; columns >= kv_valid, and with causal
//            columns > row, are masked (-1e30 in f32, -inf in bf16) and
//            their p set to 0 explicitly (:89-93); exp2 online softmax, P
//            rounded to the input dtype for P.V; out = o / max(l, 1e-30) and
//            lse = m*ln2 + log(max(l, 1e-30)) (natural log).
//   backward p = exp(s * (1/sqrt(D)) - lse) on an UNscaled q, in natural
//            units (bwd_prob; the bf16 kernel as exp2(s * log2(e)/sqrt(D) -
//            lse * log2(e))); ds = p (dp - delta) with dp = dO v^T and
//            delta = rowsum(dO*O) (a PyTorch op, as in JAX); dq = ds k/sqrt(D),
//            dk = ds^T q/sqrt(D), dv = p^T dO.
//
// Instances.
//  * bf16 forward: the shared forward of flash_fwd.cuh (FlashAttention-3's
//    design for head_dim 128: a producer warpgroup TMA-loading Q once and
//    128-key K/V tiles into a 2-stage ring, two consumer warpgroups of 64 q
//    rows each on wgmma, ping-ponging at the tensor cores; its header gives
//    the design). FwdRows is its front-end: (bh, S, 128) rows through
//    tensor maps (zeros past each (b, h)'s rows), the kv_valid and causal
//    masks on the tiles that need them, causal blocks stopping at the last
//    kv tile any of their rows reaches (and launched longest first), and
//    the epilogue that writes out and lse.
//  * bf16 backward (FlashAttention-3's design for head_dim 128, on the
//    primitives of hopper.cuh): one block per (b*h, 128 kv rows), causal
//    blocks starting at the first q tile that reaches their rows. Warpgroup
//    0 is the producer (setmaxnreg down to 24): one thread loads the
//    block's K and V tiles once and a 2-stage ring of 64-row Q and dO tiles
//    (TMA, 128-byte swizzle, zeros past each (b, h)'s rows) with their lse
//    and delta rows (bulk copies), on mbarriers. Warpgroups 1 and 2 (240
//    registers) own 64 kv rows each; per q tile each computes S^T = K Q^T
//    and dP^T = V dO^T (wgmma m64n64k16, both operands from shared memory,
//    K-major), P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q
//    (m64n128k16, A = P^T / dS^T from registers, B = dO / Q MN-major),
//    accumulated in registers over all q tiles. dS^T also goes to shared
//    memory; once both halves are there (named barrier), each warpgroup
//    takes 64 of dQ's 128 lanes: dS K over the block's 128 kv rows
//    (m64n64k16, A = dS MN-major, B = K MN-major), staged in shared memory
//    and added into an f32 dq_accum by the TMA unit
//    (cp.reduce.async.bulk.tensor .add; atomicAdd from registers, scalar or
//    float2, was slower on the H100: PERF.md, b6_variants.py).
//    The wrapper zeroes dq_accum, then scales it by 1/sqrt(D) and rounds it
//    to bf16. S and dP are computed once (10 B*H*Sq*Skv*D FLOP, the least
//    work) where the TPU split recomputes both (14); 128-row kv tiles make
//    S_kv/128 adds per dq element (4.1 GB through L2 at the trainer's
//    shape). dq's sum order across blocks varies from run to run (dk and
//    dv are deterministic). Every product is bf16 in, f32 accumulate; P and
//    dS are rounded to bf16 for the three products that consume them (the
//    FlashAttention-2 choice), within 1e-2 relative Frobenius norm of the
//    f32 plain version (chip_smoke.py measures it). Registers per consumer
//    thread: dK 64 + dV 64, S^T 32 + dP^T 32 (then the bf16 A fragments
//    16 + 16), dQ 32, no spills; shared memory 194 KB, one block per SM.
//  * f32 backward: the bf16 kernel's loop on the tensor cores, every f32
//    product as 3xTF32 (x = hi + lo, hi = x rounded to TF32, lo = x - hi;
//    a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 accumulate: CUTLASS's
//    OpMultiplyAddFastF32, about f32's error where one TF32 product keeps
//    ~3 digits). wgmma takes tf32 only with both operands K-major, and
//    three of the five products need an MN-major B, so the products are
//    mma.sync m16n8k8 with fragments gathered from one f32 copy of each
//    tile and split into hi/lo in registers. One block per (b*h, 128 kv
//    rows): a producer warpgroup (setmaxnreg 24; one thread TMA-loads K and
//    V once and a 2-stage ring of 32-row Q and dO tiles, 128-byte swizzle,
//    zeros past each (b, h)'s rows, with their lse and delta rows by bulk
//    copy) and two consumer warpgroups (240 registers) of 8 warps with 16
//    kv rows each. Per q tile a warp computes S^T = K Q^T and dP^T = V dO^T
//    (16 x 32), P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q
//    (16 x 128 each; the accumulators are A fragments as they stand once a
//    fragment's k slots are taken in the order (2 tig, 2 tig + 1), and B
//    is read in that order too; each q tile's products go into fresh
//    accumulators added to dK, dV in f32, since the tensor core truncates
//    its own sums and one chain over all q tiles drifts); dS^T goes
//    to shared memory and, after a named barrier, each warp takes a 16 x
//    32 piece of dQ = dS K / sqrt(D) over the block's 128 kv rows, staged
//    in the TMA box layout and added into the f32 dq by the TMA unit
//    (cp.reduce.async.bulk.tensor .add), so dq needs no pass after the
//    kernel. Every fragment read from the swizzled tiles is free of bank
//    conflicts. Shared memory 226 KB (K, V 128 KB; two Q/dO stages 64 KB;
//    dS^T 16 KB; dQ staging 16 KB), one block per SM. dq's sum order
//    across blocks varies from run to run; dk and dv are deterministic.
//  * f32 forward: both products on the tensor cores as bf16 terms. A split
//    pass writes each f32 value of q, k and v as three bf16 planes, x = x0
//    + x1 + x2 (+ under 2^-27 |x|), into a scratch the wrapper allocates;
//    the kernel sums the six products whose term indices add to <= 2
//    (x2 y0, x1 y1, x0 y2, x1 y0, x0 y1, then x0 y0: the smallest first),
//    about f32's precision. The shared forward's structure: a producer
//    warpgroup (setmaxnreg 24) TMA-loads Q's three planes once (96 KB)
//    and each 64-key tile's K and V planes (48 KB each) on separate K and
//    V mbarriers, so that K(t+1) loads under P.V(t) and V(t+1) under
//    S(t+1) with one stage; two consumer warpgroups of 64 q rows: S = Q K^T
//    by wgmma m64n64k16 from shared memory (both K-major), the exp2 online
//    softmax in f32, P split into three bf16 A fragments in registers, P V
//    by wgmma m64n128k16 (V MN-major). S and each tile's P V go into fresh
//    accumulators (the tensor core truncates its own sums: one chain over
//    all kv tiles drifts), and o = o * corr + (P V) in f32. Shared memory
//    193 KB, one block per SM. (b5_f32_variants.py times it against two
//    terms, three products, and against 3xTF32 on mma.sync.)
//  Ragged tails (S not a multiple of the tile) are zero-filled on load,
//  masked, and never stored. Element offsets are 64-bit.
//
// Bounds on the card (the trainer's shape B = 2, H = 24, S = 4608, D = 128):
//   forward 4*B*H*S^2*D = 5.22e11 FLOP: 0.528 ms at 989 TFLOP/s bf16; in
//   f32 as six bf16 products 3.17 ms (7.79 ms at 67 TFLOP/s on f32 FMA);
//   bytes 4 x 56.6 MB bf16 = 0.07 ms (f32: the split pass reads 3 x 113 MB
//   and writes 3 x 170 MB, 0.25 ms).
//   backward at least 10*B*H*S^2*D = 1.30e12 FLOP, which both backward
//   kernels do: 1.32 ms bf16 (bytes, 8 x 56.6 MB plus the f32 dq_accum
//   written and read once, ~0.2 ms); f32 as 3xTF32 3.91e12 TF32 FLOP at
//   495 TFLOP/s = 7.9 ms (on f32 FMA it would be 19.5 ms at 67 TFLOP/s;
//   bytes 8 x 113 MB = 0.27 ms). Every call is compute-bound; the B*H*S^2
//   exponentials also load the special-function units, and the f32
//   kernel's hi/lo splits (3 instructions per fragment element) compete
//   with its mma.sync issue.

#include "flash_fwd.cuh"

namespace {

constexpr int D = 128;                  // padded head_dim
constexpr float NEG_INF = -1e30f;       // the f32 forward's running max start
constexpr float LN_2 = 0.6931471805599453f;

// p of the backward: natural exp on the unscaled score (not the forward's
// exp2 on a prescaled q)
__device__ __forceinline__ float bwd_prob(float s, float scale, float lse) {
  return expf(s * scale - lse);
}

// ---------------------------------------------------------------------------
// B5, bf16: the front-end of the shared forward (flash_fwd.cuh); grid
// (ceil(s_q / 128), bh)
// ---------------------------------------------------------------------------

struct FwdRows {
  static constexpr bool SCALE_S = false;   // q arrives prescaled
  CUtensorMap tq, tk, tv;    // (bh, S, 128) rows, boxes of 128 x 64 lanes
  bf16* out;                 // (bh, s_q, 128)
  float* lse;                // (bh, s_q), natural log
  int s_q, kv_valid, causal;
  float s_scale;             // unused

  // causal blocks run last row block first: the longest go first
  __device__ int q0() const {
    return (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * fwd::BM;
  }
  // the kv tiles up to kv_valid; causal blocks stop at the last tile any
  // of their rows reaches
  __device__ int tiles(int q0_) const {
    int n = (kv_valid + fwd::BN - 1) / fwd::BN;
    if (causal) n = min(n, (min(q0_ + fwd::BM, s_q) - 1) / fwd::BN + 1);
    return n;
  }
  __device__ int valid(int t) const {
    return min(fwd::BN, kv_valid - t * fwd::BN);
  }
  __device__ void load_q(unsigned char* dst, int q0_, uint64_t* bar) const {
    fwd::load_tile(dst, &tq, 0, q0_, blockIdx.y, bar);
  }
  __device__ void load_k(unsigned char* dst, int t, uint64_t* bar) const {
    fwd::load_tile(dst, &tk, 0, t * fwd::BN, blockIdx.y, bar);
  }
  __device__ void load_v(unsigned char* dst, int t, uint64_t* bar) const {
    fwd::load_tile(dst, &tv, 0, t * fwd::BN, blockIdx.y, bar);
  }
  __device__ void store(int r, int hr, const float (&o)[64], float l, float m,
                        int tig) const {
    if (r >= s_q) return;
    const long long row = (long long)blockIdx.y * s_q + r;
    fwd::store_row(out + row * D, o, hr, 1.f / l, tig);
    if (tig == 0) lse[row] = m * LN_2 + logf(l);
  }
};

// ---------------------------------------------------------------------------
// B5, f32: bf16 terms on wgmma
// ---------------------------------------------------------------------------

constexpr int F32_TERMS = 3;              // bf16 terms per f32 value
constexpr int F32_PLANES = 3;             // term planes the wrapper allocates
constexpr int FF_BM = 128;                // q rows per block (2 x 64)
constexpr int FF_BN = 64;                 // keys per K/V tile
constexpr int FF_STAGES = F32_TERMS == 3 ? 1 : 2;   // K/V ring depth
constexpr int FF_THREADS = 384;           // producer + 2 consumer warpgroups
constexpr int FF_QBOX = FF_BM * 128;      // bytes of a Q box: 128 rows x 64 lanes
constexpr int FF_KBOX = FF_BN * 128;      // bytes of a K or V box: 64 rows
constexpr int FF_QPLANE = 2 * FF_QBOX;    // one term of the Q tile, 32 KB
constexpr int FF_KPLANE = 2 * FF_KBOX;    // one term of a K or V tile, 16 KB
constexpr int FF_STAGE = 2 * F32_TERMS * FF_KPLANE;  // K terms, then V terms
constexpr int FF_SMEM = 1024 + F32_TERMS * FF_QPLANE + FF_STAGES * FF_STAGE;
static_assert(F32_TERMS <= F32_PLANES, "more terms than planes");

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// x = x0 + x1 + x2 + r with x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x -
// x0 - x1) (each difference exact in f32; |r| <= 2^-27 |x|): plane t of
// `terms` (planes n elements apart) receives x_t, four values a thread.
__global__ void split_kernel(const float4* __restrict__ x,
                             uint2* __restrict__ terms, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 r = x[i];
#pragma unroll
    for (int t = 0; t < F32_PLANES; ++t) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(r.x, r.y);
      const __nv_bfloat162 b = __floats2bfloat162_rn(r.z, r.w);
      terms[t * n4 + i] = make_uint2(bf2_bits(a), bf2_bits(b));
      r.x -= __low2float(a);
      r.y -= __high2float(a);
      r.z -= __low2float(b);
      r.w -= __high2float(b);
    }
  }
}

struct FwdF32 {
  CUtensorMap tq;      // Q terms (F32_PLANES * bh, s_q, 128) bf16, plane t
                       // of head b at z = t * bh + b: boxes of 128 rows
  CUtensorMap tk, tv;  // K, V terms (F32_PLANES * bh, s_kv, 128): 64 rows
  float* out;          // (bh, s_q, 128)
  float* lse;          // (bh, s_q), natural log
  int bh, s_q, kv_valid, causal;
};

// The K-major descriptor of k-step kk (16 lanes) of a term plane held as
// two boxes of `rows` rows x 64 lanes (128-byte rows), from row row0.
__device__ __forceinline__ uint64_t plane_kdesc(const unsigned char* plane,
                                                int rows, int row0, int kk) {
  return smem_desc(plane + (kk >> 2) * rows * 128 + row0 * 128, 16, 1024) +
         2 * (kk & 3);
}

// Two probabilities (x the lower key) split into F32_TERMS bf16 pairs, as
// the A fragment packs them.
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&t)[F32_TERMS]) {
#pragma unroll
  for (int i = 0; i < F32_TERMS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[i] = bf2_bits(h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

// One block per (b*h, 128 q rows); grid (ceil(s_q / 128), bh). Warpgroup 0
// loads, warpgroups 1 and 2 own 64 q rows each (accumulator element 4j + e:
// row 16 warp + g + 8 (e >> 1), column 8j + 2 tig + (e & 1)).
__global__ void __launch_bounds__(FF_THREADS, 1)
    fwd_f32_kernel(const __grid_constant__ FwdF32 P) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_k[FF_STAGES], full_v[FF_STAGES],
      empty_k[FF_STAGES], empty_v[FF_STAGES], qbar;
  // tiles on 1024-byte boundaries: the period of the 128-byte swizzle
  unsigned char* sQ =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sQ + F32_TERMS * FF_QPLANE;   // stage s: K, then V
  const int bh = blockIdx.y;
  // causal blocks run last row block first: the longest go first
  const int q0 =
      (P.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * FF_BM;
  // the kv tiles up to kv_valid; causal blocks stop at the last tile any
  // of their rows reaches
  int steps = (P.kv_valid + FF_BN - 1) / FF_BN;
  if (P.causal) steps = min(steps, (min(q0 + FF_BM, P.s_q) - 1) / FF_BN + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < FF_STAGES; ++s) {
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
      mbar_expect_tx(&qbar, F32_TERMS * FF_QPLANE);
      for (int t = 0; t < F32_TERMS; ++t)
        for (int h = 0; h < 2; ++h)
          tma_3d(sQ + t * FF_QPLANE + h * FF_QBOX, &P.tq, 64 * h, q0,
                 t * P.bh + bh, &qbar);
      for (int st = 0; st < steps; ++st) {
        const int s = st % FF_STAGES, round = st / FF_STAGES;
        unsigned char* sK = ring + s * FF_STAGE;
        unsigned char* sV = sK + F32_TERMS * FF_KPLANE;
        if (st >= FF_STAGES) mbar_wait(&empty_k[s], (round - 1) & 1);
        mbar_expect_tx(&full_k[s], F32_TERMS * FF_KPLANE);
        for (int t = 0; t < F32_TERMS; ++t)
          for (int h = 0; h < 2; ++h)
            tma_3d(sK + t * FF_KPLANE + h * FF_KBOX, &P.tk, 64 * h,
                   st * FF_BN, t * P.bh + bh, &full_k[s]);
        if (st >= FF_STAGES) mbar_wait(&empty_v[s], (round - 1) & 1);
        mbar_expect_tx(&full_v[s], F32_TERMS * FF_KPLANE);
        for (int t = 0; t < F32_TERMS; ++t)
          for (int h = 0; h < 2; ++h)
            tma_3d(sV + t * FF_KPLANE + h * FF_KBOX, &P.tv, 64 * h,
                   st * FF_BN, t * P.bh + bh, &full_v[s]);
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
  const float minus_inf = __int_as_float(0xff800000);

  float o[64], ot[64], s[FF_BN / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = ot[i] = 0.f;
#pragma unroll
  for (int i = 0; i < FF_BN / 2; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  fence_regs(ot);
  fence_regs(s);

  if (steps > 0) mbar_wait(&qbar, 0);
  for (int st = 0; st < steps; ++st) {
    const int stage = st % FF_STAGES, ph = (st / FF_STAGES) & 1;
    const unsigned char* sK = ring + stage * FF_STAGE;
    const unsigned char* sV = sK + F32_TERMS * FF_KPLANE;

    // S = Q K^T as the products of the term pairs (i, j), i + j <
    // F32_TERMS, the smallest first, into a fresh accumulator (the tensor
    // core truncates its own sums, so no chain runs across tiles)
    mbar_wait(&full_k[stage], ph);
    wgmma_fence();
#pragma unroll
    for (int sum = F32_TERMS - 1; sum >= 0; --sum)
#pragma unroll
      for (int i = sum; i >= 0; --i)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_bf16_ss64<0, 0>(
              s, plane_kdesc(sQ + i * FF_QPLANE, FF_BM, 64 * cw, kk),
              plane_kdesc(sK + (sum - i) * FF_KPLANE, FF_BN, 0, kk),
              sum != F32_TERMS - 1 || i != sum || kk != 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty_k[stage]);

    // masks (keys from kv_valid on, and with causal keys past the row),
    // then the exp2 online softmax; a masked key's p is 0
    const int key0 = st * FF_BN;
    const int nv = min(FF_BN, P.kv_valid - key0);
    const bool masked = nv < FF_BN || (P.causal && key0 + FF_BN - 1 > row0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < FF_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, c = 8 * j + 2 * tig + (e & 1);
        if (masked && (c >= nv || (P.causal && key0 + c > row[e >> 1])))
          s[i] = minus_inf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i]);
      }
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
#pragma unroll
    for (int i = 0; i < FF_BN / 2; ++i) {
      const float p = s[i] == minus_inf ? 0.f : exp2f(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
    // P's terms as A fragments (register r of k-step kk: keys 8 kk + 2 r,
    // + 1 of the thread's columns)
    uint32_t a[F32_TERMS][FF_BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < FF_BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t t[F32_TERMS];
        split_pair(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], t);
#pragma unroll
        for (int i = 0; i < F32_TERMS; ++i) a[i][kk][r] = t[i];
      }
    fence_regs(s);

    // this tile's P V over the same term pairs into a fresh accumulator,
    // folded into o in f32: o = o * corr + (P V)
    mbar_wait(&full_v[stage], ph);
    wgmma_fence();
#pragma unroll
    for (int sum = F32_TERMS - 1; sum >= 0; --sum)
#pragma unroll
      for (int i = sum; i >= 0; --i) {
        const uint64_t dv =
            smem_desc(sV + (sum - i) * FF_KPLANE, FF_KBOX, 1024);
#pragma unroll
        for (int kk = 0; kk < FF_BN / 16; ++kk)
          wgmma_bf16_rs(ot, a[i][kk], dv + (uint64_t)(kk * 16 * 128 >> 4),
                        sum != F32_TERMS - 1 || i != sum || kk != 0);
      }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(ot);
    if (lane == 0) mbar_arrive(&empty_v[stage]);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * j + e] = fmaf(o[4 * j + e], corr[e >> 1], ot[4 * j + e]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int r = row[hr];
    if (r >= P.s_q) continue;
    const long long at = (long long)bh * P.s_q + r;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(P.out + at * D + 8 * j + 2 * tig) =
          make_float2(__fdiv_rn(o[4 * j + 2 * hr], lt),
                      __fdiv_rn(o[4 * j + 2 * hr + 1], lt));
    if (tig == 0) P.lse[at] = m[hr] * LN_2 + logf(lt);
  }
}

// ---------------------------------------------------------------------------
// B6, bf16: dq, dk and dv in one kernel on wgmma, TMA and mbarriers
// ---------------------------------------------------------------------------

constexpr int BW_KV = 128;              // kv rows per block
constexpr int BW_Q = 64;                // q rows per tile of the ring
constexpr int BW_STAGES = 2;            // Q / dO / lse / delta ring depth
constexpr int BW_THREADS = 384;         // producer + 2 consumer warpgroups
constexpr int BAR_DS = 1;               // named barrier: both dS^T halves
constexpr int BAR_DQ = 2;               // named barriers 2, 3: a dQ half staged
constexpr float LOG2_E = 1.4426950408889634f;
// shared memory in elements; every tile starts on a 1024-byte boundary
// (the period of the 128-byte swizzle)
constexpr int KV_ELEMS = BW_KV * D;     // a K or V tile: two boxes of 64 lanes
constexpr int Q_ELEMS = BW_Q * D;       // a Q or dO tile: two boxes
constexpr int DS_ELEMS = BW_KV * BW_Q;  // dS^T: 128 kv rows x 64 q
constexpr int DQ_FLOATS = BW_Q * 64;    // a dQ half: two boxes of 64 x 32 f32
constexpr int BW_SMEM = 1024 + 2 * (2 * KV_ELEMS + BW_STAGES * 2 * Q_ELEMS +
                                    2 * DS_ELEMS) +
                        BW_STAGES * 2 * BW_Q * 4 + 2 * DQ_FLOATS * 4;

struct Bwd {
  CUtensorMap tq, tdo, tk, tv;   // (bh, rows, 128) bf16, boxes of 64 lanes
  CUtensorMap tdq;               // (bh, s_q, 128) f32 dq_accum, zeroed by
                                 // the caller: boxes of 64 rows x 32 lanes
  const float* lse;              // (bh, s_q_pad) natural log, zero padded
  const float* delta;            // (bh, s_q_pad) rowsum(dO * O)
  bf16* dk;                      // (bh, s_kv, 128)
  bf16* dv;
  int s_q, s_kv, kv_valid, causal, s_q_pad;
  float scale;                   // 1/sqrt(D) of the unpadded head width
};

// The K-major descriptor of k-step kk (16 lanes) of a tile of `rows` rows
// held as two boxes of 64 lanes (128-byte rows), from row `row0`.
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int rows,
                                           int row0, int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 64 + row0 * 64, 16, 1024) +
         2 * (kk & 3);
}

// The MN-major descriptor of k-step kk (16 rows) of a tile of `rows` rows
// held as 64-wide boxes along N (or M), the next box rows * 128 bytes on.
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int rows,
                                            int kk) {
  return smem_desc(tile + kk * 16 * 64, rows * 128, 1024);
}

__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// One block per (b*h, 128 kv rows); warpgroup 0 loads, warpgroups 1 and 2
// each own 64 of the kv rows (accumulator element 4j + e of a thread: kv
// row 16 warp + g + 8 (e >> 1), column 8j + 2 tig + (e & 1)).
__global__ void __launch_bounds__(BW_THREADS, 1)
    bwd_bf16_kernel(const __grid_constant__ Bwd P) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[BW_STAGES], empty[BW_STAGES], kvbar;
  bf16* sK = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* sV = sK + KV_ELEMS;
  bf16* sQ = sV + KV_ELEMS;                  // BW_STAGES tiles
  bf16* sO = sQ + BW_STAGES * Q_ELEMS;       // dO, BW_STAGES tiles
  bf16* sS = sO + BW_STAGES * Q_ELEMS;       // dS^T, two buffers
  float* sL = reinterpret_cast<float*>(sS + 2 * DS_ELEMS);  // lse per stage
  float* sD = sL + BW_STAGES * BW_Q;                         // delta
  float* sA = sD + BW_STAGES * BW_Q;         // dQ halves, one per consumer

  const int kv0 = blockIdx.x * BW_KV;
  const int bh = blockIdx.y;
  const int n_q = (P.s_q + BW_Q - 1) / BW_Q;
  // the first q tile that reaches this block's kv rows
  const int it0 = P.causal ? kv0 / BW_Q : 0;
  const int n_it = kv0 < P.kv_valid ? max(0, n_q - it0) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_expect_tx(&kvbar, 2 * KV_ELEMS * 2);
      for (int h = 0; h < 2; ++h) {
        tma_3d(sK + h * BW_KV * 64, &P.tk, 64 * h, kv0, bh, &kvbar);
        tma_3d(sV + h * BW_KV * 64, &P.tv, 64 * h, kv0, bh, &kvbar);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % BW_STAGES;
        if (it >= BW_STAGES) mbar_wait(&empty[s], (it / BW_STAGES - 1) & 1);
        const int q0 = (it0 + it) * BW_Q;
        mbar_expect_tx(&full[s], 2 * Q_ELEMS * 2 + 2 * BW_Q * 4);
        for (int h = 0; h < 2; ++h) {
          tma_3d(sQ + s * Q_ELEMS + h * BW_Q * 64, &P.tq, 64 * h, q0, bh,
                 &full[s]);
          tma_3d(sO + s * Q_ELEMS + h * BW_Q * 64, &P.tdo, 64 * h, q0, bh,
                 &full[s]);
        }
        const long long row = (long long)bh * P.s_q_pad + q0;
        bulk_g2s(sL + s * BW_Q, P.lse + row, BW_Q * 4, &full[s]);
        bulk_g2s(sD + s * BW_Q, P.delta + row, BW_Q * 4, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;                    // consumer warpgroup 0 or 1
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int rw = 64 * cw + 16 * warp + g;  // the thread's first kv row
    const float scale_log2 = P.scale * LOG2_E;
    const bool issuer = (threadIdx.x & 127) == 0;   // of the dQ adds
    float* dq_half = sA + cw * DQ_FLOATS;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    // accumulators are written by plain instructions only where no product
    // is in flight; the fences keep the compiler from moving the writes
    fence_regs(dk);
    fence_regs(dv);
    if (n_it > 0) mbar_wait(&kvbar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % BW_STAGES;
      const int q0 = (it0 + it) * BW_Q;
      const bf16* tq = sQ + s * Q_ELEMS;
      const bf16* to = sO + s * Q_ELEMS;
      const float* tl = sL + s * BW_Q;
      const float* td = sD + s * BW_Q;
      bf16* ds_buf = sS + (it & 1) * DS_ELEMS;
      mbar_wait(&full[s], (it / BW_STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 kv rows
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss64<0, 0>(st, kmajor(sK, BW_KV, 64 * cw, kk),
                              kmajor(tq, BW_Q, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss64<0, 0>(dpt, kmajor(sV, BW_KV, 64 * cw, kk),
                              kmajor(to, BW_Q, 0, kk), kk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(s/sqrt(D) - lse), masked entries 0; dS^T = P^T (dP^T -
      // delta), both per q column
      const int kvw = kv0 + 64 * cw;
      const bool masked = q0 + BW_Q > P.s_q || kvw + 64 > P.kv_valid ||
                          (P.causal && kvw + 63 > q0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tig;
        const float2 lv = *reinterpret_cast<const float2*>(tl + c);
        const float2 dl = *reinterpret_cast<const float2*>(td + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float l2 = (e & 1 ? lv.y : lv.x) * LOG2_E;
          float p = exp2f(fmaf(st[i], scale_log2, -l2));
          if (masked) {
            const int qc = q0 + c + (e & 1);
            const int kr = kv0 + rw + 8 * (e >> 1);
            if (qc >= P.s_q || kr >= P.kv_valid || (P.causal && kr > qc))
              p = 0.f;
          }
          st[i] = p;
          dpt[i] = p * (dpt[i] - (e & 1 ? dl.y : dl.x));
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, st);
      pack_a(da, dpt);
      // dS^T into shared memory for dQ: row = kv (128-byte rows of 64 q,
      // 16-byte chunk j of row r at j ^ (r & 7))
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rw + 8 * hr;
          *reinterpret_cast<uint32_t*>(ds_buf + r * 64 + ((j ^ (r & 7)) << 3) +
                                       2 * tig) =
              (j & 1) ? da[j >> 1][2 + hr] : da[j >> 1][hr];
        }
      fence_proxy_async();

      // dV += P^T dO, dK += dS^T Q (A from registers, B MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BW_Q / 16; ++kk)
        wgmma_bf16_rs(dv, pa[kk], mnmajor(to, BW_Q, kk));
#pragma unroll
      for (int kk = 0; kk < BW_Q / 16; ++kk)
        wgmma_bf16_rs(dk, da[kk], mnmajor(tq, BW_Q, kk));
      wgmma_commit();

      // dQ[:, 64 cw .. 64 cw + 63] = dS K over all 128 kv rows of the block,
      // once both warpgroups' dS^T halves are in shared memory (and the
      // last tile's dQ half has been read out of dq_half)
      if (issuer) bulk_wait_read0();
      bar_sync(BAR_DS, 256);
      float dqa[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BW_KV / 16; ++kk)
        wgmma_bf16_ss64<1, 1>(dqa, mnmajor(ds_buf, BW_KV, kk),
                              mnmajor(sK + cw * BW_KV * 64, BW_KV, kk), kk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dqa);
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) mbar_arrive(&empty[s]);

      // stage this dQ half (128-byte swizzled rows of 32 f32: 16-byte
      // chunk k of row r at k ^ (r & 7)), then one thread has the TMA unit
      // add it into dq_accum (rows past s_q are not written; the sum order
      // over blocks varies from run to run)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * warp + g + 8 * hr;
          const int k = (2 * j + (tig >> 1)) & 7;
          *reinterpret_cast<float2*>(dq_half + (j >> 2) * BW_Q * 32 +
                                     r * 32 + ((k ^ (r & 7)) << 2) +
                                     2 * (tig & 1)) =
              make_float2(dqa[4 * j + 2 * hr], dqa[4 * j + 2 * hr + 1]);
        }
      fence_proxy_async();
      bar_sync(BAR_DQ + cw, 128);
      if (issuer) {
        tma_add_3d(&P.tdq, dq_half, 64 * cw, q0, bh);
        tma_add_3d(&P.tdq, dq_half + BW_Q * 32, 64 * cw + 32, q0, bh);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait_read0();

    // every kv row of the block is written, zeros where no q reached it
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kr = kv0 + rw + 8 * hr;
      if (kr >= P.s_kv) continue;
      const long long off = ((long long)bh * P.s_kv + kr) * D + 2 * tig;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(P.dk + off + 8 * j) =
            pack_bf16(dk[4 * j + 2 * hr] * P.scale,
                      dk[4 * j + 2 * hr + 1] * P.scale);
        *reinterpret_cast<uint32_t*>(P.dv + off + 8 * j) =
            pack_bf16(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B6, f32: dq, dk and dv in one kernel on the tensor cores, as 3xTF32
// ---------------------------------------------------------------------------

constexpr int FB_KV = 128;              // kv rows per block
constexpr int FB_Q = 32;                // q rows per tile of the ring
constexpr int FB_STAGES = 2;            // Q / dO / lse / delta ring depth
constexpr int FB_THREADS = 384;         // producer + 2 consumer warpgroups
constexpr int FB_BAR_DS = 1;            // named barrier: dS^T complete
constexpr int FB_BAR_DQ = 2;            // named barrier: dQ staged
// shared memory in floats: tiles of 128 lanes held as four TMA boxes of 32
// lanes, each on a 1024-byte boundary (the period of the 128-byte swizzle)
constexpr int FB_KV_FLOATS = FB_KV * D;     // a K or V tile, 64 KB
constexpr int FB_Q_FLOATS = FB_Q * D;       // a Q, dO or dQ tile, 16 KB
constexpr int FB_DS_FLOATS = FB_KV * FB_Q;  // dS^T: 128 kv rows x 32 q
constexpr int FB_SMEM = 1024 + 4 * (2 * FB_KV_FLOATS +
                                    FB_STAGES * 2 * FB_Q_FLOATS +
                                    FB_DS_FLOATS + FB_Q_FLOATS +
                                    FB_STAGES * 2 * FB_Q);

struct BwdF32 {
  CUtensorMap tq, tdo;           // (bh, s_q, 128) f32, boxes of 32 x 32
  CUtensorMap tk, tv;            // (bh, s_kv, 128) f32, boxes of 128 x 32
  CUtensorMap tdq;               // (bh, s_q, 128) f32 dq, zeroed by the
                                 // caller: boxes of 32 x 32
  const float* lse;              // (bh, s_q_pad) natural log, zero padded
  const float* delta;            // (bh, s_q_pad) rowsum(dO * O)
  float* dk;                     // (bh, s_kv, 128)
  float* dv;
  int s_q, s_kv, kv_valid, causal, s_q_pad;
  float scale;                   // 1/sqrt(D) of the unpadded head width
};

// The float offset of element (r, c) of a tile of `rows` rows x 128 lanes
// held as four boxes of 32 lanes: 128-byte rows, 16-byte chunk j of row r
// at j ^ (r & 7), as TMA's 128-byte swizzle writes them.
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c >> 5) * rows * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
         (c & 3);
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, half away from
// zero), lo = x - hi exactly; the tensor core reads lo's top 11 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: a_lo b_hi + a_hi b_lo, then a_hi b_hi (a_lo b_lo,
// 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

template <int N>
__device__ __forceinline__ void split_n(const float (&x)[N],
                                        uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// The A fragment (16 x 8) at rows r0.., lanes c0.. of a swizzled tile
// (rows along M, lanes along K).
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* t, int rows, int r0,
                                       int c0, int g, int tig) {
  const float x[4] = {t[swz(rows, r0 + g, c0 + tig)],
                      t[swz(rows, r0 + g + 8, c0 + tig)],
                      t[swz(rows, r0 + g, c0 + tig + 4)],
                      t[swz(rows, r0 + g + 8, c0 + tig + 4)]};
  split_n(x, hi, lo);
}

// The B fragment (8 x 8) with N along the tile's rows (n0..) and K along
// its lanes (k0..).
__device__ __forceinline__ void frag_b_nk(uint32_t (&hi)[2],
                                          uint32_t (&lo)[2], const float* t,
                                          int rows, int n0, int k0, int g,
                                          int tig) {
  const float x[2] = {t[swz(rows, n0 + g, k0 + tig)],
                      t[swz(rows, n0 + g, k0 + tig + 4)]};
  split_n(x, hi, lo);
}

// The B fragment (8 x 8) with K along the tile's rows (k0..) and N along
// its lanes (n0..), in the k-slot order (2 tig, 2 tig + 1) of an A
// fragment taken from accumulator registers: slot tig is row k0 + 2 tig,
// slot tig + 4 row k0 + 2 tig + 1.
__device__ __forceinline__ void frag_b_kn(uint32_t (&hi)[2],
                                          uint32_t (&lo)[2], const float* t,
                                          int rows, int k0, int n0, int g,
                                          int tig) {
  const float x[2] = {t[swz(rows, k0 + 2 * tig, n0 + g)],
                      t[swz(rows, k0 + 2 * tig + 1, n0 + g)]};
  split_n(x, hi, lo);
}

// acc[nb] += a b over a q tile: A (16 kv rows x 32 q) from accumulator
// registers x (k slots (2 tig, 2 tig + 1) of each n8 block), B (32 q x
// 128 lanes) from the tile t. Each n8 block's product goes into a fresh
// accumulator, added to acc in f32; four blocks at a time, so that four
// chains of dependent mma.sync are in flight.
__device__ __forceinline__ void tile_products(float (&acc)[16][4],
                                              const float (&x)[4][4],
                                              const float* t, int g,
                                              int tig) {
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
    split_n(a, ah[j], al[j]);
  }
#pragma unroll
  for (int n0 = 0; n0 < 16; n0 += 4) {
    float part[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t bh[2], bl[2];
        frag_b_kn(bh, bl, t, FB_Q, 8 * j, 8 * (n0 + nb), g, tig);
        mma3(part[nb], ah[j], al[j], bh, bl);
      }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + nb][e] += part[nb][e];
  }
}

// One block per (b*h, 128 kv rows); warpgroup 0 loads, warpgroups 1 and 2
// hold 8 warps of 16 kv rows each (accumulator element e of n8 block j of
// a thread: kv row 16 warp + g + 8 (e >> 1), column 8j + 2 tig + (e & 1)).
__global__ void __launch_bounds__(FB_THREADS, 1)
    bwd_f32_kernel(const __grid_constant__ BwdF32 P) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[FB_STAGES], empty[FB_STAGES], kvbar;
  float* sK = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  float* sV = sK + FB_KV_FLOATS;
  float* sQ = sV + FB_KV_FLOATS;             // FB_STAGES tiles
  float* sO = sQ + FB_STAGES * FB_Q_FLOATS;  // dO, FB_STAGES tiles
  float* sS = sO + FB_STAGES * FB_Q_FLOATS;  // dS^T, one box of 32 q lanes
  float* sA = sS + FB_DS_FLOATS;             // dQ staged for the TMA add
  float* sL = sA + FB_Q_FLOATS;              // lse per stage
  float* sD = sL + FB_STAGES * FB_Q;         // delta per stage

  const int kv0 = blockIdx.x * FB_KV;
  const int bh = blockIdx.y;
  const int n_q = (P.s_q + FB_Q - 1) / FB_Q;
  // the first q tile that reaches this block's kv rows
  const int it0 = P.causal ? kv0 / FB_Q : 0;
  const int n_it = kv0 < P.kv_valid ? max(0, n_q - it0) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FB_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_expect_tx(&kvbar, 2 * FB_KV_FLOATS * 4);
      for (int h = 0; h < 4; ++h) {
        tma_3d(sK + h * FB_KV * 32, &P.tk, 32 * h, kv0, bh, &kvbar);
        tma_3d(sV + h * FB_KV * 32, &P.tv, 32 * h, kv0, bh, &kvbar);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % FB_STAGES;
        if (it >= FB_STAGES) mbar_wait(&empty[s], (it / FB_STAGES - 1) & 1);
        const int q0 = (it0 + it) * FB_Q;
        mbar_expect_tx(&full[s], 2 * FB_Q_FLOATS * 4 + 2 * FB_Q * 4);
        for (int h = 0; h < 4; ++h) {
          tma_3d(sQ + s * FB_Q_FLOATS + h * FB_Q * 32, &P.tq, 32 * h, q0, bh,
                 &full[s]);
          tma_3d(sO + s * FB_Q_FLOATS + h * FB_Q * 32, &P.tdo, 32 * h, q0,
                 bh, &full[s]);
        }
        const long long row = (long long)bh * P.s_q_pad + q0;
        bulk_g2s(sL + s * FB_Q, P.lse + row, FB_Q * 4, &full[s]);
        bulk_g2s(sD + s * FB_Q, P.delta + row, FB_Q * 4, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x >> 5) - 4;  // consumer warp 0 .. 7
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    const int rw = 16 * warp;                 // the warp's first kv row
    const int mq = warp & 1, nd = warp >> 1;  // its dQ rows 16 mq, lanes 32 nd
    const bool issuer = threadIdx.x == 128;   // of the dQ adds

    float dk[16][4], dv[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
    if (n_it > 0) mbar_wait(&kvbar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % FB_STAGES;
      const int q0 = (it0 + it) * FB_Q;
      const float* tq = sQ + s * FB_Q_FLOATS;
      const float* to = sO + s * FB_Q_FLOATS;
      const float* tl = sL + s * FB_Q;
      const float* td = sD + s * FB_Q;
      mbar_wait(&full[s], (it / FB_STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 kv rows
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        frag_a(kh, kl, sK, FB_KV, rw, 8 * kk, g, tig);
        frag_a(vh, vl, sV, FB_KV, rw, 8 * kk, g, tig);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh_[2], bl_[2];
          frag_b_nk(bh_, bl_, tq, FB_Q, 8 * j, 8 * kk, g, tig);
          mma3(st[j], kh, kl, bh_, bl_);
          frag_b_nk(bh_, bl_, to, FB_Q, 8 * j, 8 * kk, g, tig);
          mma3(dpt[j], vh, vl, bh_, bl_);
        }
      }

      // P^T = exp(s/sqrt(D) - lse), masked entries 0; dS^T = P^T (dP^T -
      // delta), both per q column
      const int kvw = kv0 + rw;
      const bool masked = q0 + FB_Q > P.s_q || kvw + 16 > P.kv_valid ||
                          (P.causal && kvw + 15 > q0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tig + (e & 1);
          float p = bwd_prob(st[j][e], P.scale, tl[c]);
          if (masked) {
            const int qc = q0 + c, kr = kvw + g + 8 * (e >> 1);
            if (qc >= P.s_q || kr >= P.kv_valid || (P.causal && qc < kr))
              p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - td[c]);
        }

      // dS^T into shared memory for dQ (every warp read the last tile's
      // before FB_BAR_DQ)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              sS + swz(FB_KV, rw + g + 8 * hr, 8 * j + 2 * tig)) =
              make_float2(dpt[j][2 * hr], dpt[j][2 * hr + 1]);

      // dV += P^T dO, then dK += dS^T Q: A from the registers above (k
      // slots (2 tig, 2 tig + 1) of each n8 block), B from the stage's
      // tiles. The tensor core truncates its f32 sums, so a tile's 12
      // products go into fresh accumulators and dK, dV take them by a
      // rounded add (one accumulator over all q tiles measured ~3e-5 in
      // relative norm on the H100, over F32_REL)
      tile_products(dv, st, to, g, tig);
      tile_products(dk, dpt, tq, g, tig);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // Q, dO, lse, delta read

      // the last dQ staging read by the TMA unit, dS^T complete
      if (issuer) bulk_wait_read0();
      bar_sync(FB_BAR_DS, 256);

      // dQ = dS K / sqrt(D): the warp takes q rows 16 mq.. x lanes 32 nd..
      // over the block's 128 kv rows (A = dS from dS^T, k slots (2 tig,
      // 2 tig + 1))
      // (even and odd kv steps in two accumulator sets: eight chains of
      // dependent mma.sync in flight)
      float dq[2][4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[h][nb][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < FB_KV / 8; kk += 2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * (kk + h) + 2 * tig, c = 16 * mq + g;
          const float a[4] = {sS[swz(FB_KV, r, c)], sS[swz(FB_KV, r, c + 8)],
                              sS[swz(FB_KV, r + 1, c)],
                              sS[swz(FB_KV, r + 1, c + 8)]};
          uint32_t ah[4], al[4];
          split_n(a, ah, al);
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            uint32_t bh_[2], bl_[2];
            frag_b_kn(bh_, bl_, sK, FB_KV, 8 * (kk + h), 32 * nd + 8 * nb, g,
                      tig);
            mma3(dq[h][nb], ah, al, bh_, bl_);
          }
        }
      // stage dQ in the tensor map's box layout; one thread has the TMA
      // unit add it into dq (rows past s_q are not written; the sum order
      // over blocks varies from run to run)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              sA + swz(FB_Q, 16 * mq + g + 8 * hr,
                       32 * nd + 8 * nb + 2 * tig)) =
              make_float2((dq[0][nb][2 * hr] + dq[1][nb][2 * hr]) * P.scale,
                          (dq[0][nb][2 * hr + 1] + dq[1][nb][2 * hr + 1]) *
                              P.scale);
      fence_proxy_async();
      bar_sync(FB_BAR_DQ, 256);
      if (issuer) {
        for (int h = 0; h < 4; ++h)
          tma_add_3d(&P.tdq, sA + h * FB_Q * 32, 32 * h, q0, bh);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait_read0();

    // every kv row of the block is written, zeros where no q reached it
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kr = kv0 + rw + g + 8 * hr;
      if (kr < P.s_kv) {
        const long long off = ((long long)bh * P.s_kv + kr) * D + 2 * tig;
#pragma unroll
        for (int nb = 0; nb < 16; ++nb) {
          *reinterpret_cast<float2*>(P.dk + off + 8 * nb) = make_float2(
              dk[nb][2 * hr] * P.scale, dk[nb][2 * hr + 1] * P.scale);
          *reinterpret_cast<float2*>(P.dv + off + 8 * nb) =
              make_float2(dv[nb][2 * hr], dv[nb][2 * hr + 1]);
        }
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// (bh, rows, 128) f32 as a tensor map: boxes of `box` rows x 32 lanes (128
// bytes); a load past each (b, h)'s last row reads zeros, a reduce there
// writes nothing.
bool map_rows_f32(CUtensorMap* map, const void* base, int rows, int bh,
                  int box) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4,
                                 (cuuint64_t)rows * D * 4};
  const cuuint32_t boxes[3] = {32, (cuuint32_t)box, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims,
                  strides, boxes);
}

// B5 f32: the split pass over q, k and v into `terms`, then the kernel.
int fwd_f32(const void* q, const void* k, const void* v, void* out,
            void* lse, int bh, int s_q, int s_kv, int kv_valid, int causal,
            void* terms, cudaStream_t st) {
  const long long nq = (long long)bh * s_q * D, nk = (long long)bh * s_kv * D;
  bf16* tq = static_cast<bf16*>(terms);
  bf16* tk = tq + F32_PLANES * nq;
  bf16* tv = tk + F32_PLANES * nk;
  const void* src[3] = {q, k, v};
  bf16* dst[3] = {tq, tk, tv};
  for (int i = 0; i < 3; ++i) {
    const long long n4 = (i == 0 ? nq : nk) / 4;
    const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
    split_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(src[i]),
                                         reinterpret_cast<uint2*>(dst[i]),
                                         n4);
  }
  FwdF32 P;
  if (!(map_rows(&P.tq, tq, s_q, F32_PLANES * bh, FF_BM) &&
        map_rows(&P.tk, tk, s_kv, F32_PLANES * bh, FF_BN) &&
        map_rows(&P.tv, tv, s_kv, F32_PLANES * bh, FF_BN)))
    return (int)cudaErrorInvalidValue;
  P.out = static_cast<float*>(out);
  P.lse = static_cast<float*>(lse);
  P.bh = bh;
  P.s_q = s_q;
  P.kv_valid = kv_valid;
  P.causal = causal;
  cudaError_t err = allow_smem(fwd_f32_kernel, FF_SMEM);
  if (err != cudaSuccess) return (int)err;
  fwd_f32_kernel<<<dim3((s_q + FF_BM - 1) / FF_BM, bh), FF_THREADS, FF_SMEM,
                   st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out/dout/dk/dv: (bh, S, 128) contiguous, head_dim padded to 128
// by the wrapper. kv positions >= kv_valid (<= s_kv) are masked, and with
// `causal` kv positions > the q position. Every entry returns the CUDA
// error code of its launches (0 = success).

// B5: out = softmax(q k^T) v with q prescaled by log2(e)/sqrt(D); lse
// (bh, s_q) f32 in natural log. dtype: 0 = bf16, 1 = f32 (bf16 terms),
// both on the tensor cores; 9 (cudaErrorInvalidConfiguration) for another.
// terms (f32 only, else null): bf16 scratch of 3 * bh * 128 * (s_q + 2 *
// s_kv) elements, for the term planes of q, k and v.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* out, void* lse, int bh, int s_q,
                         int s_kv, int kv_valid, int causal, void* terms,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd_f32(q, k, v, out, lse, bh, s_q, s_kv, kv_valid, causal, terms,
                   st);
  if (dtype != 0) return (int)cudaErrorInvalidConfiguration;
  FwdRows fe;
  if (!(map_rows(&fe.tq, q, s_q, bh, fwd::BM) &&
        map_rows(&fe.tk, k, s_kv, bh, fwd::BN) &&
        map_rows(&fe.tv, v, s_kv, bh, fwd::BN)))
    return (int)cudaErrorInvalidValue;
  fe.out = static_cast<bf16*>(out);
  fe.lse = static_cast<float*>(lse);
  fe.s_q = s_q;
  fe.kv_valid = kv_valid;
  fe.causal = causal;
  fe.s_scale = 1.f;
  return fwd::launch(fe, dim3((s_q + fwd::BM - 1) / fwd::BM, bh), st);
}

// B6, bf16: dq, dk and dv in one launch. lse and delta: (bh, s_q_pad) f32,
// s_q_pad = s_q rounded up to a multiple of 64, zero padded; dq_accum:
// (bh, s_q, 128) f32, zeroed by the caller, receives sum_kv dS K (not yet
// scaled by 1/sqrt(D), summed in an order that varies from run to run);
// dk, dv: (bh, s_kv, 128) bf16. scale = 1/sqrt(D) of the unpadded width.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq_accum, void* dk,
                              void* dv, int bh, int s_q, int s_kv,
                              int kv_valid, int causal, float scale,
                              void* stream) {
  Bwd P;
  if (!(map_rows(&P.tq, q, s_q, bh, BW_Q) &&
        map_rows(&P.tdo, dout, s_q, bh, BW_Q) &&
        map_rows(&P.tk, k, s_kv, bh, BW_KV) &&
        map_rows(&P.tv, v, s_kv, bh, BW_KV) &&
        map_rows_f32(&P.tdq, dq_accum, s_q, bh, BW_Q)))
    return (int)cudaErrorInvalidValue;
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.dk = static_cast<bf16*>(dk);
  P.dv = static_cast<bf16*>(dv);
  P.s_q = s_q;
  P.s_kv = s_kv;
  P.kv_valid = kv_valid;
  P.causal = causal;
  P.s_q_pad = (s_q + BW_Q - 1) / BW_Q * BW_Q;
  P.scale = scale;
  cudaError_t err = allow_smem(bwd_bf16_kernel, BW_SMEM);
  if (err != cudaSuccess) return (int)err;
  bwd_bf16_kernel<<<dim3((s_kv + BW_KV - 1) / BW_KV, bh), BW_THREADS, BW_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// B6, f32: dq, dk and dv in one launch, every product in 3xTF32. lse and
// delta: (bh, s_q_pad) f32, s_q_pad = s_q rounded up to a multiple of 64,
// zero padded; dq: (bh, s_q, 128) f32, zeroed by the caller, receives
// sum_kv dS K / sqrt(D) (summed in an order that varies from run to run);
// dk, dv: (bh, s_kv, 128) f32. scale = 1/sqrt(D) of the unpadded width.
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int bh, int s_q, int s_kv, int kv_valid,
                             int causal, float scale, void* stream) {
  BwdF32 P;
  if (!(map_rows_f32(&P.tq, q, s_q, bh, FB_Q) &&
        map_rows_f32(&P.tdo, dout, s_q, bh, FB_Q) &&
        map_rows_f32(&P.tk, k, s_kv, bh, FB_KV) &&
        map_rows_f32(&P.tv, v, s_kv, bh, FB_KV) &&
        map_rows_f32(&P.tdq, dq, s_q, bh, FB_Q)))
    return (int)cudaErrorInvalidValue;
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.dk = static_cast<float*>(dk);
  P.dv = static_cast<float*>(dv);
  P.s_q = s_q;
  P.s_kv = s_kv;
  P.kv_valid = kv_valid;
  P.causal = causal;
  P.s_q_pad = (s_q + BW_Q - 1) / BW_Q * BW_Q;
  P.scale = scale;
  cudaError_t err = allow_smem(bwd_f32_kernel, FB_SMEM);
  if (err != cudaSuccess) return (int)err;
  bwd_f32_kernel<<<dim3((s_kv + FB_KV - 1) / FB_KV, bh), FB_THREADS, FB_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// The 3xTF32 variant of the f32 flash forward (B5 f32) on mma.sync, kept
// to be measured against the committed kernel (fwd_f32_kernel, bf16 terms
// on wgmma): domainrag_tpu_torch/b5_f32_variants.py builds a copy of
// flash_attention.cu that includes this file inside its anonymous
// namespace, after the f32 backward's helpers (swz, split_tf32, mma3,
// frag_a, frag_b_nk, frag_b_kn), and routes flash_fwd's dtype 1 to
// fwd_tf32. The shipped library does not include it.
//
// Same math as fwd_f32_kernel, every product as 3xTF32 (a_lo b_hi + a_hi
// b_lo + a_hi b_hi, hi = x rounded to TF32), the f32 backward's loop
// shape: one block per (b*h, 128 q rows); a producer warpgroup
// (setmaxnreg 24) TMA-loads the f32 Q tile once (64 KB, four 32-lane boxes,
// 128-byte swizzle) and 64-key K and V tiles (32 KB each) into a 2-stage
// ring on separate K and V mbarriers; 8 consumer warps of 16 q rows: S (16
// x 64) = Q K^T from the swizzled tiles, the exp2 online softmax, then O +=
// P V with P's A fragments taken from the score accumulators in the k-slot
// order (2 tig, 2 tig + 1) and V read in that order; each tile's P V in
// fresh accumulators added to O in f32. Shared memory 193 KB.

constexpr int TF_BM = 128;               // q rows per block (8 warps x 16)
constexpr int TF_BN = 64;                // keys per K/V tile
constexpr int TF_STAGES = 2;
constexpr int TF_THREADS = 384;          // producer warpgroup + 8 warps
constexpr int TF_QF = TF_BM * D;         // floats of the Q tile
constexpr int TF_KF = TF_BN * D;         // floats of a K or V tile
constexpr int TF_SMEM = 1024 + 4 * (TF_QF + TF_STAGES * 2 * TF_KF);

struct FwdTf32 {
  CUtensorMap tq;        // (bh, s_q, 128) f32, boxes of 128 rows x 32 lanes
  CUtensorMap tk, tv;    // (bh, s_kv, 128) f32, boxes of 64 rows x 32 lanes
  float* out;            // (bh, s_q, 128)
  float* lse;            // (bh, s_q), natural log
  int s_q, kv_valid, causal;
};

// o[nb] += p v over one kv tile: A (16 q rows x 64 keys) from the score
// accumulators x (k slots (2 tig, 2 tig + 1) of each n8 block), B (64 keys
// x 128 lanes) from the V tile t; four n8 blocks at a time in fresh
// accumulators, added to o in f32.
__device__ __forceinline__ void pv_tf32(float (&o)[16][4],
                                        const float (&x)[TF_BN / 8][4],
                                        const float* t, int g, int tig) {
  uint32_t ah[TF_BN / 8][4], al[TF_BN / 8][4];
#pragma unroll
  for (int j = 0; j < TF_BN / 8; ++j) {
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
    for (int j = 0; j < TF_BN / 8; ++j)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t bh[2], bl[2];
        frag_b_kn(bh, bl, t, TF_BN, 8 * j, 8 * (n0 + nb), g, tig);
        mma3(part[nb], ah[j], al[j], bh, bl);
      }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n0 + nb][e] += part[nb][e];
  }
}

__global__ void __launch_bounds__(TF_THREADS, 1)
    fwd_tf32_kernel(const __grid_constant__ FwdTf32 P) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_k[TF_STAGES], full_v[TF_STAGES],
      empty_k[TF_STAGES], empty_v[TF_STAGES], qbar;
  float* sQ = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  float* ring = sQ + TF_QF;                // stage s: K, then V
  const int bh = blockIdx.y;
  const int q0 =
      (P.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * TF_BM;
  int steps = (P.kv_valid + TF_BN - 1) / TF_BN;
  if (P.causal) steps = min(steps, (min(q0 + TF_BM, P.s_q) - 1) / TF_BN + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);     // lane 0 of each consumer warp
      mbar_init(&empty_v[s], 8);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && steps > 0) {
      mbar_expect_tx(&qbar, TF_QF * 4);
      for (int h = 0; h < 4; ++h)
        tma_3d(sQ + h * TF_BM * 32, &P.tq, 32 * h, q0, bh, &qbar);
      for (int st = 0; st < steps; ++st) {
        const int s = st % TF_STAGES, round = st / TF_STAGES;
        float* sK = ring + s * 2 * TF_KF;
        if (st >= TF_STAGES) mbar_wait(&empty_k[s], (round - 1) & 1);
        mbar_expect_tx(&full_k[s], TF_KF * 4);
        for (int h = 0; h < 4; ++h)
          tma_3d(sK + h * TF_BN * 32, &P.tk, 32 * h, st * TF_BN, bh,
                 &full_k[s]);
        if (st >= TF_STAGES) mbar_wait(&empty_v[s], (round - 1) & 1);
        mbar_expect_tx(&full_v[s], TF_KF * 4);
        for (int h = 0; h < 4; ++h)
          tma_3d(sK + TF_KF + h * TF_BN * 32, &P.tv, 32 * h, st * TF_BN, bh,
                 &full_v[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int warp = (threadIdx.x >> 5) - 4;  // consumer warp 0 .. 7
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int rw = 16 * warp;                 // the warp's first q row
  const int row[2] = {q0 + rw + g, q0 + rw + g + 8};
  const float minus_inf = __int_as_float(0xff800000);

  float o[16][4];
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  if (steps > 0) mbar_wait(&qbar, 0);

  for (int st = 0; st < steps; ++st) {
    const int stage = st % TF_STAGES, ph = (st / TF_STAGES) & 1;
    const float* sK = ring + stage * 2 * TF_KF;
    const float* sV = sK + TF_KF;
    mbar_wait(&full_k[stage], ph);
    float s[TF_BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < TF_BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      frag_a(ah, al, sQ, TF_BM, rw, 8 * kk, g, tig);
#pragma unroll
      for (int nb = 0; nb < TF_BN / 8; ++nb) {
        uint32_t bh_[2], bl_[2];
        frag_b_nk(bh_, bl_, sK, TF_BN, 8 * nb, 8 * kk, g, tig);
        mma3(s[nb], ah, al, bh_, bl_);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_k[stage]);

    const int key0 = st * TF_BN;
    const int nv = min(TF_BN, P.kv_valid - key0);
    const bool masked = nv < TF_BN || (P.causal && key0 + TF_BN - 1 > q0 + rw);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < TF_BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nb + 2 * tig + (e & 1);
        if (masked && (c >= nv || (P.causal && key0 + c > row[e >> 1])))
          s[nb][e] = minus_inf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
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
    for (int nb = 0; nb < TF_BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[nb][e] == minus_inf ? 0.f : exp2f(s[nb][e] - m[e >> 1]);
        s[nb][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] *= corr[e >> 1];
    mbar_wait(&full_v[stage], ph);
    pv_tf32(o, s, sV, g, tig);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_v[stage]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    if (row[hr] >= P.s_q) continue;
    const long long at = (long long)bh * P.s_q + row[hr];
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
      *reinterpret_cast<float2*>(P.out + at * D + 8 * nb + 2 * tig) =
          make_float2(__fdiv_rn(o[nb][2 * hr], lt),
                      __fdiv_rn(o[nb][2 * hr + 1], lt));
    if (tig == 0) P.lse[at] = m[hr] * LN_2 + logf(lt);
  }
}

int fwd_tf32(const void* q, const void* k, const void* v, void* out,
             void* lse, int bh, int s_q, int s_kv, int kv_valid, int causal,
             cudaStream_t st) {
  FwdTf32 P;
  if (!(map_rows_f32(&P.tq, q, s_q, bh, TF_BM) &&
        map_rows_f32(&P.tk, k, s_kv, bh, TF_BN) &&
        map_rows_f32(&P.tv, v, s_kv, bh, TF_BN)))
    return (int)cudaErrorInvalidValue;
  P.out = static_cast<float*>(out);
  P.lse = static_cast<float*>(lse);
  P.s_q = s_q;
  P.kv_valid = kv_valid;
  P.causal = causal;
  cudaError_t err = allow_smem(fwd_tf32_kernel, TF_SMEM);
  if (err != cudaSuccess) return (int)err;
  fwd_tf32_kernel<<<dim3((s_q + TF_BM - 1) / TF_BM, bh), TF_THREADS, TF_SMEM,
                    st>>>(P);
  return (int)cudaGetLastError();
}

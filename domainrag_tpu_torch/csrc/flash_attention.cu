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
//      behind _flash_backward (:382): the same split - one block per
//      (b*h, q tile) looping over KV tiles for dq, one per (b*h, kv tile)
//      looping over q tiles for dk/dv. Nothing is reduced across blocks, so
//      no atomics.
//
// Layout: q/k/v/out/dout (B*H, S, 128) contiguous, head_dim padded to 128
// by the wrapper (ops/attention.py); lse and delta (B*H, Sq) f32.
//
// Math (as the TPU kernels):
//   forward  q arrives prescaled by log2(e)/sqrt(D) and rounded to its
//            dtype; s = q k^T in f32; columns >= kv_valid, and with causal
//            columns > row, are masked to -1e30 and their p set to 0
//            explicitly (:89-93); exp2 online softmax, P rounded to the
//            input dtype for P.V; out = o / max(l, 1e-30) and
//            lse = m*ln2 + log(max(l, 1e-30)) (natural log).
//   backward p = exp(s * (1/sqrt(D)) - lse) on an UNscaled q, in natural
//            units (bwd_prob); ds = p (dp - delta) with dp = dO v^T and
//            delta = rowsum(dO*O) (a PyTorch op, as in JAX); dq = ds k/sqrt(D),
//            dk = ds^T q/sqrt(D), dv = p^T dO.
//
// Instances.
//  * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulate), tiles in shared memory by cp.async (double-buffered),
//    XOR-swizzled 16-byte chunks for conflict-free ldmatrix - the design of
//    flash_kernel in mmdit_attention.cu. Forward: 4 warps x two 16-row q
//    tiles = 128 q rows per block, 64-row K/V tiles. dq: 4 warps x 16 q
//    rows, 64-row K/V tiles. dk/dv: 4 warps x 16 kv rows, 64-row q tiles
//    processed in two 32-column halves so that the dk and dv accumulators
//    (128 f32 registers a thread) fit beside the score tiles. The TPU
//    kernels take every backward product in f32; here s and dp are exact
//    f32 sums of bf16 products, and P and dS are rounded to bf16 for the
//    three products that consume them, with f32 accumulation (the
//    FlashAttention-2 choice). Against the f32 plain version this stays
//    within 1e-2 relative Frobenius norm (chip_smoke.py measures it).
//  * f32: no TF32 (the port turns it off), so f32 FMA on the CUDA cores:
//    256 threads, 64x64 score tiles, each thread 4 rows x 4 columns of a
//    score tile and 4 rows x 8 columns of a 128-wide accumulator, rows
//    ty + 16i and columns tx + 16j so that every shared-memory read is a
//    broadcast or conflict-free (row pitch 129 / 65 floats).
//  Ragged tails (S not a multiple of the tile) are zero-filled on load,
//  masked, and never stored. Element offsets are 64-bit.
//
// Bounds on the card (the trainer's shape B = 2, H = 24, S = 4608, D = 128):
//   forward 4*B*H*S^2*D = 5.22e11 FLOP: 0.528 ms at 989 TFLOP/s bf16,
//   7.79 ms at 67 TFLOP/s f32 (FMA); bytes 4 x 56.6 MB bf16 = 0.07 ms.
//   backward at least 10*B*H*S^2*D = 1.30e12 FLOP (dq and dk/dv together;
//   these two kernels recompute s twice and do 14*B*H*S^2*D = 1.83e12):
//   1.32 ms bf16 at the least count. Every call is compute-bound; the
//   B*H*S^2 exponentials also load the special-function units.

#include "common.cuh"

namespace {

constexpr int D = 128;                  // padded head_dim
constexpr int THREADS = 128;            // mma kernels: 4 warps
constexpr int BN = 64;                  // kv rows per tile
constexpr int BQ = 64;                  // q rows per tile of the backward
constexpr int TILE = 64 * D;            // elements of a 64-row tile
constexpr float NEG_INF = -1e30f;
constexpr float LN_2 = 0.6931471805599453f;

// p of the backward: natural exp on the unscaled score (not the forward's
// exp2 on a prescaled q)
__device__ __forceinline__ float bwd_prob(float s, float scale, float lse) {
  return expf(s * scale - lse);
}

__device__ __forceinline__ bool keep(int row, int col, int kv_valid,
                                     int causal) {
  return col < kv_valid && (!causal || col <= row);
}

// ---------------------------------------------------------------------------
// tiles (PTX helpers in common.cuh)
// ---------------------------------------------------------------------------

// Element offset of 16-byte chunk c (0..15) of row `row` in a swizzled
// (rows, 128) bf16 tile: chunk c lives at c ^ (row & 7).
__device__ __forceinline__ int swz(int row, int c) {
  return row * D + ((c ^ (row & 7)) << 3);
}

// ROWS rows of 128 from `base` (row stride D) starting at row0; rows >=
// limit are zero-filled.
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

// A operand (16 rows x 16 k) from a swizzled row-major tile: rows m, cols k
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* tile,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(r, tile + swz(row0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B operands of two 8-column n tiles from a tile whose rows are n and
// columns k: r[0..1] n rows row0..row0+7, r[2..3] rows row0+8..row0+15
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const bf16* tile,
                                       int row0, int kk, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(r, tile + swz(row0 + ((mi >> 1) << 3) + (lane & 7),
                            2 * kk + (mi & 1)));
}

// B operands of two 8-column n tiles (columns 16*t2 ..) from a tile whose
// rows are k (row0 .. row0+15) and columns n
__device__ __forceinline__ void frag_b_trans(uint32_t (&r)[4],
                                             const bf16* tile, int row0,
                                             int t2, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4_trans(r, tile + swz(row0 + ((mi & 1) << 3) + (lane & 7),
                                  2 * t2 + (mi >> 1)));
}

// A operand of one 16-wide k step from C fragments c[2*jj], c[2*jj+1]
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Write a warp's 16 x 128 C fragment (rows row0 + g, row0 + g + 8) into a
// swizzled bf16 tile, scaled by `mul`.
__device__ __forceinline__ void c_to_tile(bf16* tile, const float (&c)[16][4],
                                          int row0, float mul0, float mul1,
                                          int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int col = 8 * t + 2 * tig;
    const int ch = col >> 3, e = col & 7;
    *reinterpret_cast<uint32_t*>(tile + swz(r0, ch) + e) =
        pack_bf16(c[t][0] * mul0, c[t][1] * mul0);
    *reinterpret_cast<uint32_t*>(tile + swz(r1, ch) + e) =
        pack_bf16(c[t][2] * mul1, c[t][3] * mul1);
  }
}

// ROWS rows of a swizzled tile to global rows row0.. (< limit), stride D
template <int ROWS>
__device__ __forceinline__ void store_tile(bf16* base, const bf16* tile,
                                           int row0, int limit, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 16 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 4, c = idx & 15;
    if (row0 + row >= limit) continue;
    *reinterpret_cast<uint4*>(base + (long long)(row0 + row) * D + c * 8) =
        *reinterpret_cast<const uint4*>(tile + swz(row, c));
  }
}

// ---------------------------------------------------------------------------
// B5, bf16: streaming forward on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MT = 2;                            // 16-row q tiles per warp
constexpr int FWD_BM = 4 * 16 * MT;              // q rows per block (128)
constexpr int FWD_SMEM = (FWD_BM * D + 4 * TILE) * 2;   // Q + 2K + 2V: 96 KB

__global__ void __launch_bounds__(THREADS)
    fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int s_q, int s_kv, int kv_valid,
                    int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + FWD_BM * D;
  bf16* sV = sK + 2 * TILE;

  const int q0 = blockIdx.x * FWD_BM;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* qbase = q + bh * s_q * D;
  const bf16* kbase = k + bh * s_kv * D;
  const bf16* vbase = v + bh * s_kv * D;

  int n_kv = (kv_valid + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + FWD_BM, s_q) - 1) / BN + 1);

  load_tile<FWD_BM>(sQ, qbase, q0, s_q, tid);
  load_tile<BN>(sK, kbase, 0, kv_valid, tid);
  load_tile<BN>(sV, vbase, 0, kv_valid, tid);
  cp_async_commit();

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
      load_tile<BN>(sK + (buf ^ 1) * TILE, kbase, (j + 1) * BN, kv_valid,
                    tid);
      load_tile<BN>(sV + (buf ^ 1) * TILE, vbase, (j + 1) * BN, kv_valid,
                    tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tk = sK + buf * TILE;
    const bf16* tv = sV + buf * TILE;

    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 8; ++t)
        s[mt][t][0] = s[mt][t][1] = s[mt][t][2] = s[mt][t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) frag_a(qa[mt], sQ, wrow + 16 * mt, kk,
                                             lane);
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        uint32_t kb[4];
        frag_b(kb, tk, 16 * p, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * p], qa[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * p + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    const int kv0 = j * BN;
    const bool masked =
        kv0 + BN > kv_valid || (causal && kv0 + BN - 1 > q0 + wrow);
    if (masked) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = q0 + wrow + 16 * mt + g, r1 = r0 + 8;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = kv0 + 8 * t + 2 * tig;
          if (!keep(r0, col, kv_valid, causal)) s[mt][t][0] = NEG_INF;
          if (!keep(r0, col + 1, kv_valid, causal)) s[mt][t][1] = NEG_INF;
          if (!keep(r1, col, kv_valid, causal)) s[mt][t][2] = NEG_INF;
          if (!keep(r1, col + 1, kv_valid, causal)) s[mt][t][3] = NEG_INF;
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
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
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mx = e < 2 ? mx0 : mx1;
          // a masked column's p is 0 even where the whole row is masked
          // so far (s == m == -1e30 would give exp2(0) = 1)
          s[mt][t][e] = (masked && s[mt][t][e] == NEG_INF)
                            ? 0.f : exp2f(s[mt][t][e] - mx);
        }
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
      for (int mt = 0; mt < MT; ++mt)
        c_to_a(a[mt], s[mt][2 * jj], s[mt][2 * jj + 1]);
#pragma unroll
      for (int t2 = 0; t2 < 8; ++t2) {
        uint32_t vb[4];
        frag_b_trans(vb, tv, 16 * jj, t2, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * t2], a[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * t2 + 1], a[mt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }

  float* lse_row = lse + bh * s_q;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    const int r0 = q0 + wrow + 16 * mt + g, r1 = r0 + 8;
    if (tig == 0) {
      if (r0 < s_q) lse_row[r0] = m[mt][0] * LN_2 + logf(l0);
      if (r1 < s_q) lse_row[r1] = m[mt][1] * LN_2 + logf(l1);
    }
    c_to_tile(sQ, o[mt], wrow + 16 * mt, 1.f / l0, 1.f / l1, lane);
  }
  __syncthreads();
  store_tile<FWD_BM>(out + bh * s_q * D, sQ, q0, s_q, tid);
}

// ---------------------------------------------------------------------------
// f32 instances: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int ST = 256;                 // threads of the f32 kernels
constexpr int LD = D + 1;               // row pitch of 128-wide f32 tiles
constexpr int LDP = 64 + 1;             // row pitch of 64-wide f32 tiles
constexpr int FT = 64 * LD;             // floats of a 64 x 128 tile
constexpr int PT = 64 * LDP;            // floats of a 64 x 64 tile

// 64 rows of 128 from global rows row0.. (rows >= limit zero) into a
// tile of pitch LD
__device__ __forceinline__ void load_f(float* dst, const float* base,
                                       int row0, int limit, int tid) {
  for (int idx = tid; idx < 64 * D; idx += ST) {
    const int r = idx >> 7, c = idx & 127;
    dst[r * LD + c] =
        row0 + r < limit ? base[(long long)(row0 + r) * D + c] : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16i][d] * B[tx + 16j][d]  (A, B pitch LD)
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A,
                                      const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * LD + d];
      b[i] = B[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_k P[ty + 16i][k] * B[k][tx + 16c]  (P pitch LDP, B LD)
__device__ __forceinline__ void mm_nn(float (&acc)[4][8], const float* P,
                                      const float* B, int ty, int tx) {
#pragma unroll 4
  for (int kx = 0; kx < 64; ++kx) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * LDP + kx];
#pragma unroll
    for (int c = 0; c < 8; ++c) b[c] = B[kx * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// sum over the 16 lanes that share a row (one half-warp)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void store_acc(float* base,
                                          const float (&acc)[4][8],
                                          int row0, int limit, int ty, int tx,
                                          const float (&mul)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= limit) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      base[(long long)r * D + tx + 16 * c] = acc[i][c] * mul[i];
  }
}

constexpr int SIMT_FWD_SMEM = (3 * FT + PT) * 4;      // Q, K, V, P
constexpr int SIMT_BWD_SMEM = (4 * FT + 2 * PT + 128) * 4;

__global__ void __launch_bounds__(ST)
    fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int s_q, int s_kv, int kv_valid,
                    int causal) {
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;
  float* sK = sQ + FT;
  float* sV = sK + FT;
  float* sP = sV + FT;
  const int q0 = blockIdx.x * 64;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* kbase = k + bh * s_kv * D;
  const float* vbase = v + bh * s_kv * D;

  int n_kv = (kv_valid + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + 64, s_q) - 1) / BN + 1);
  load_f(sQ, q + bh * s_q * D, q0, s_q, tid);

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BN;
    __syncthreads();
    load_f(sK, kbase, kv0, kv_valid, tid);
    load_f(sV, vbase, kv0, kv_valid, tid);
    __syncthreads();
    float s[4][4] = {};
    mm_nt(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        ok[jj] = keep(row, kv0 + tx + 16 * jj, kv_valid, causal);
        if (!ok[jj]) s[i][jj] = NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = row_max(mx);
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? exp2f(s[i][jj] - mx) : 0.f;
        ps += p;
        sP[(ty + 16 * i) * LDP + tx + 16 * jj] = p;
      }
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    mm_nn(o, sP, sV, ty, tx);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(row_sum(l[i]), 1e-30f);
    inv[i] = 1.f / li;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < s_q) lse[bh * s_q + row] = m[i] * LN_2 + logf(li);
  }
  store_acc(out + bh * s_q * D, o, q0, s_q, ty, tx, inv);
}

__global__ void __launch_bounds__(ST)
    dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int s_q, int s_kv, int kv_valid, int causal, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;
  float* sO = sQ + FT;          // dO
  float* sK = sO + FT;
  float* sV = sK + FT;
  float* sS = sV + FT;          // dS
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* kbase = k + bh * s_kv * D;
  const float* vbase = v + bh * s_kv * D;

  int n_kv = (kv_valid + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, s_q) - 1) / BN + 1);
  load_f(sQ, q + bh * s_q * D, q0, s_q, tid);
  load_f(sO, dout + bh * s_q * D, q0, s_q, tid);
  float lse_r[4], del_r[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < s_q ? lse[bh * s_q + row] : 0.f;
    del_r[i] = row < s_q ? delta[bh * s_q + row] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BN;
    __syncthreads();
    load_f(sK, kbase, kv0, s_kv, tid);
    load_f(sV, vbase, kv0, s_kv, tid);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt(s, sQ, sK, ty, tx);
    mm_nt(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = kv0 + tx + 16 * jj;
        const float p = keep(row, col, kv_valid, causal)
                            ? bwd_prob(s[i][jj], scale, lse_r[i]) : 0.f;
        sS[(ty + 16 * i) * LDP + tx + 16 * jj] = p * (dp[i][jj] - del_r[i]);
      }
    }
    __syncthreads();
    mm_nn(acc, sS, sK, ty, tx);
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_acc(dq + bh * s_q * D, acc, q0, s_q, ty, tx, mul);
}

__global__ void __launch_bounds__(ST)
    dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int s_q, int s_kv, int kv_valid,
                    int causal, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sK = fsm;
  float* sV = sK + FT;
  float* sQ = sV + FT;
  float* sO = sQ + FT;          // dO
  float* sP = sO + FT;          // P^T (kv rows x q columns)
  float* sS = sP + PT;          // dS^T
  float* sL = sS + PT;          // lse of the q tile
  float* sD = sL + 64;          // delta of the q tile
  const int kv0 = blockIdx.x * BN;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qbase = q + bh * s_q * D;
  const float* obase = dout + bh * s_q * D;

  load_f(sK, k + bh * s_kv * D, kv0, s_kv, tid);
  load_f(sV, v + bh * s_kv * D, kv0, s_kv, tid);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (s_q + BQ - 1) / BQ;
  for (int it = causal ? kv0 / BQ : 0; it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();
    load_f(sQ, qbase, q0, s_q, tid);
    load_f(sO, obase, q0, s_q, tid);
    if (tid < 64) {
      const bool in = q0 + tid < s_q;
      sL[tid] = in ? lse[bh * s_q + q0 + tid] : 0.f;
      sD[tid] = in ? delta[bh * s_q + q0 + tid] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    mm_nt(st, sK, sQ, ty, tx);
    mm_nt(dpt, sV, sO, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kvr = kv0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = tx + 16 * jj;
        const float p = (q0 + qc < s_q && keep(q0 + qc, kvr, kv_valid,
                                               causal))
                            ? bwd_prob(st[i][jj], scale, sL[qc]) : 0.f;
        sP[(ty + 16 * i) * LDP + qc] = p;
        sS[(ty + 16 * i) * LDP + qc] = p * (dpt[i][jj] - sD[qc]);
      }
    }
    __syncthreads();
    mm_nn(dv_acc, sP, sO, ty, tx);
    mm_nn(dk_acc, sS, sQ, ty, tx);
  }
  const float dk_scale = scale;  // dk = ds^T q / sqrt(D)
  const float mk[4] = {dk_scale, dk_scale, dk_scale, dk_scale};
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_acc(dk + bh * s_kv * D, dk_acc, kv0, s_kv, ty, tx, mk);
  store_acc(dv + bh * s_kv * D, dv_acc, kv0, s_kv, ty, tx, one);
}

// ---------------------------------------------------------------------------
// B6, bf16: dq and dk/dv on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BWD_SMEM = 6 * TILE * 2 + 4 * BQ * 4;   // 96 KB + lse/delta

// dq: one block per (b*h, 64 q rows); 4 warps x 16 q rows; K/V tiles of
// 64 rows double-buffered.
__global__ void __launch_bounds__(THREADS)
    dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int s_q, int s_kv, int kv_valid, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + TILE;                  // dO
  bf16* sK = sO + TILE;                  // 2 buffers
  bf16* sV = sK + 2 * TILE;              // 2 buffers

  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;
  const bf16* kbase = k + bh * s_kv * D;
  const bf16* vbase = v + bh * s_kv * D;

  int n_kv = (kv_valid + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, s_q) - 1) / BN + 1);

  load_tile<BQ>(sQ, q + bh * s_q * D, q0, s_q, tid);
  load_tile<BQ>(sO, dout + bh * s_q * D, q0, s_q, tid);
  load_tile<BN>(sK, kbase, 0, s_kv, tid);
  load_tile<BN>(sV, vbase, 0, s_kv, tid);
  cp_async_commit();

  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  const float lse0 = r0 < s_q ? lse[bh * s_q + r0] : 0.f;
  const float lse1 = r1 < s_q ? lse[bh * s_q + r1] : 0.f;
  const float del0 = r0 < s_q ? delta[bh * s_q + r0] : 0.f;
  const float del1 = r1 < s_q ? delta[bh * s_q + r1] : 0.f;

  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      load_tile<BN>(sK + (buf ^ 1) * TILE, kbase, (j + 1) * BN, s_kv, tid);
      load_tile<BN>(sV + (buf ^ 1) * TILE, vbase, (j + 1) * BN, s_kv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tk = sK + buf * TILE;
    const bf16* tv = sV + buf * TILE;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t qa[4], da[4];
      frag_a(qa, sQ, wrow, kk, lane);
      frag_a(da, sO, wrow, kk, lane);
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        uint32_t kb[4], vb[4];
        frag_b(kb, tk, 16 * p, kk, lane);
        mma_bf16(s[2 * p], qa, kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qa, kb[2], kb[3]);
        frag_b(vb, tv, 16 * p, kk, lane);
        mma_bf16(dp[2 * p], da, vb[0], vb[1]);
        mma_bf16(dp[2 * p + 1], da, vb[2], vb[3]);
      }
    }

    const int kv0 = j * BN;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = kv0 + 8 * t + 2 * tig + (e & 1);
        const float p = keep(row, col, kv_valid, causal)
                            ? bwd_prob(s[t][e], scale, e < 2 ? lse0 : lse1)
                            : 0.f;
        s[t][e] = p * (dp[t][e] - (e < 2 ? del0 : del1));      // ds
      }
    }

#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      uint32_t a[4];
      c_to_a(a, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
      for (int t2 = 0; t2 < 8; ++t2) {
        uint32_t kb[4];
        frag_b_trans(kb, tk, 16 * jj, t2, lane);
        mma_bf16(acc[2 * t2], a, kb[0], kb[1]);
        mma_bf16(acc[2 * t2 + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }

  c_to_tile(sO, acc, wrow, scale, scale, lane);
  __syncthreads();
  store_tile<BQ>(dq + bh * s_q * D, sO, q0, s_q, tid);
}

// dk/dv: one block per (b*h, 64 kv rows); 4 warps x 16 kv rows; q tiles
// of 64 rows double-buffered, each taken in two halves of 32 columns.
__global__ void __launch_bounds__(THREADS)
    dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int s_q, int s_kv, int kv_valid,
                    int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;                  // 2 buffers
  bf16* sO = sQ + 2 * TILE;              // 2 buffers (dO)
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);   // 2 x 64 lse
  float* sD = sL + 2 * BQ;                                // 2 x 64 delta

  const int kv0 = blockIdx.x * BN;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;
  const bf16* qbase = q + bh * s_q * D;
  const bf16* obase = dout + bh * s_q * D;
  const float* lrow = lse + bh * s_q;
  const float* drow = delta + bh * s_q;

  const int n_q = (s_q + BQ - 1) / BQ;
  const int i0 = causal ? kv0 / BQ : 0;

  load_tile<BN>(sK, k + bh * s_kv * D, kv0, s_kv, tid);
  load_tile<BN>(sV, v + bh * s_kv * D, kv0, s_kv, tid);
  if (i0 < n_q) {
    load_tile<BQ>(sQ, qbase, i0 * BQ, s_q, tid);
    load_tile<BQ>(sO, obase, i0 * BQ, s_q, tid);
    if (tid < BQ) {
      const int r = i0 * BQ + tid;
      sL[tid] = r < s_q ? lrow[r] : 0.f;
      sD[tid] = r < s_q ? drow[r] : 0.f;
    }
  }
  cp_async_commit();

  float dk_acc[16][4], dv_acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;
  const int kr0 = kv0 + wrow + g, kr1 = kr0 + 8;

  for (int it = i0; it < n_q; ++it) {
    const int buf = (it - i0) & 1;
    if (it + 1 < n_q) {
      const int nb = buf ^ 1, nq = (it + 1) * BQ;
      load_tile<BQ>(sQ + nb * TILE, qbase, nq, s_q, tid);
      load_tile<BQ>(sO + nb * TILE, obase, nq, s_q, tid);
      if (tid < BQ) {
        sL[nb * BQ + tid] = nq + tid < s_q ? lrow[nq + tid] : 0.f;
        sD[nb * BQ + tid] = nq + tid < s_q ? drow[nq + tid] : 0.f;
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tq = sQ + buf * TILE;
    const bf16* to = sO + buf * TILE;
    const float* tl = sL + buf * BQ;
    const float* td = sD + buf * BQ;
    const int q0 = it * BQ;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;          // first q column of this half
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ka[4], va[4];
        frag_a(ka, sK, wrow, kk, lane);
        frag_a(va, sV, wrow, kk, lane);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t qb[4], ob[4];
          frag_b(qb, tq, c0 + 16 * p, kk, lane);
          mma_bf16(st[2 * p], ka, qb[0], qb[1]);
          mma_bf16(st[2 * p + 1], ka, qb[2], qb[3]);
          frag_b(ob, to, c0 + 16 * p, kk, lane);
          mma_bf16(dpt[2 * p], va, ob[0], ob[1]);
          mma_bf16(dpt[2 * p + 1], va, ob[2], ob[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kvr = e < 2 ? kr0 : kr1;
          const int qc = c0 + 8 * t + 2 * tig + (e & 1);
          const float p = (q0 + qc < s_q && keep(q0 + qc, kvr, kv_valid,
                                                 causal))
                              ? bwd_prob(st[t][e], scale, tl[qc]) : 0.f;
          dpt[t][e] = p * (dpt[t][e] - td[qc]);                  // ds^T
          st[t][e] = p;                                           // p^T
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, st[2 * jj], st[2 * jj + 1]);
        c_to_a(sa, dpt[2 * jj], dpt[2 * jj + 1]);
#pragma unroll
        for (int t2 = 0; t2 < 8; ++t2) {
          uint32_t ob[4], qb[4];
          frag_b_trans(ob, to, c0 + 16 * jj, t2, lane);
          mma_bf16(dv_acc[2 * t2], pa, ob[0], ob[1]);
          mma_bf16(dv_acc[2 * t2 + 1], pa, ob[2], ob[3]);
          frag_b_trans(qb, tq, c0 + 16 * jj, t2, lane);
          mma_bf16(dk_acc[2 * t2], sa, qb[0], qb[1]);
          mma_bf16(dk_acc[2 * t2 + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();
  }

  const float dk_scale = scale;  // dk = ds^T q / sqrt(D)
  cp_async_wait<0>();
  __syncthreads();
  c_to_tile(sQ, dk_acc, wrow, dk_scale, dk_scale, lane);
  c_to_tile(sO, dv_acc, wrow, 1.f, 1.f, lane);
  __syncthreads();
  store_tile<BN>(dk + bh * s_kv * D, sQ, kv0, s_kv, tid);
  store_tile<BN>(dv + bh * s_kv * D, sO, kv0, s_kv, tid);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

int fwd_simt(const void* q, const void* k, const void* v, void* out,
             void* lse, int bh, int s_q, int s_kv, int kv_valid, int causal,
             cudaStream_t st) {
  cudaError_t err = allow_smem(fwd_simt_kernel, SIMT_FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  fwd_simt_kernel<<<dim3((s_q + 63) / 64, bh), ST, SIMT_FWD_SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), s_q, s_kv, kv_valid, causal);
  return (int)cudaGetLastError();
}

int bwd_simt(int which, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dq,
             void* dk, void* dv, int bh, int s_q, int s_kv, int kv_valid,
             int causal, float scale, cudaStream_t st) {
  const float *tq = static_cast<const float*>(q),
              *tk = static_cast<const float*>(k),
              *tv = static_cast<const float*>(v),
              *to = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(delta);
  cudaError_t err;
  if (which == 0) {
    err = allow_smem(dq_simt_kernel, SIMT_BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    dq_simt_kernel<<<dim3((s_q + BQ - 1) / BQ, bh), ST, SIMT_BWD_SMEM,
                     st>>>(tq, tk, tv, to, fl, fd, static_cast<float*>(dq),
                           s_q, s_kv, kv_valid, causal, scale);
  } else {
    err = allow_smem(dkv_simt_kernel, SIMT_BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    dkv_simt_kernel<<<dim3((s_kv + BN - 1) / BN, bh), ST, SIMT_BWD_SMEM,
                      st>>>(tq, tk, tv, to, fl, fd, static_cast<float*>(dk),
                            static_cast<float*>(dv), s_q, s_kv, kv_valid,
                            causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16 (tensor cores), 1 = f32 (CUDA cores). q/k/v/out/dout/dq/
// dk/dv: (bh, S, 128) contiguous; lse, delta: (bh, s_q) f32. kv positions
// >= kv_valid (<= s_kv) are masked, and with `causal` kv positions > the
// q position. Both entries return the CUDA error code of their launches
// (0 = success); 9 (cudaErrorInvalidConfiguration) for a dtype they lack.

// B5: out = softmax(q k^T) v with q prescaled by log2(e)/sqrt(D); lse in
// natural log.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* out, void* lse, int bh, int s_q,
                         int s_kv, int kv_valid, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd_simt(q, k, v, out, lse, bh, s_q, s_kv, kv_valid, causal, st);
  if (dtype != 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = allow_smem(fwd_bf16_kernel, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  fwd_bf16_kernel<<<dim3((s_q + FWD_BM - 1) / FWD_BM, bh), THREADS, FWD_SMEM,
                    st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), s_q, s_kv, kv_valid, causal);
  return (int)cudaGetLastError();
}

// B6: which = 0 launches the dq kernel, 1 the dk/dv kernel; scale =
// 1/sqrt(D) of the unpadded head width.
extern "C" int flash_bwd(int dtype, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, void* dq, void* dk, void* dv,
                         int which, int bh, int s_q, int s_kv, int kv_valid,
                         int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_simt(which, q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q,
                    s_kv, kv_valid, causal, scale, st);
  if (dtype != 0) return (int)cudaErrorInvalidConfiguration;
  const bf16 *tq = static_cast<const bf16*>(q),
             *tk = static_cast<const bf16*>(k),
             *tv = static_cast<const bf16*>(v),
             *to = static_cast<const bf16*>(dout);
  const float *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(delta);
  cudaError_t err;
  if (which == 0) {
    err = allow_smem(dq_bf16_kernel, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    dq_bf16_kernel<<<dim3((s_q + BQ - 1) / BQ, bh), THREADS, BWD_SMEM, st>>>(
        tq, tk, tv, to, fl, fd, static_cast<bf16*>(dq), s_q, s_kv, kv_valid,
        causal, scale);
  } else {
    err = allow_smem(dkv_bf16_kernel, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    dkv_bf16_kernel<<<dim3((s_kv + BN - 1) / BN, bh), THREADS, BWD_SMEM,
                      st>>>(tq, tk, tv, to, fl, fd, static_cast<bf16*>(dk),
                            static_cast<bf16*>(dv), s_q, s_kv, kv_valid,
                            causal, scale);
  }
  return (int)cudaGetLastError();
}

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
//      behind _flash_backward (:382). In bf16 one kernel computes all three
//      gradients (below); the f32 instance keeps the TPU split - one block
//      per (b*h, q tile) looping over KV tiles for dq, one per (b*h, kv
//      tile) looping over q tiles for dk/dv.
//
// Layout: q/k/v/out/dout (B*H, S, 128) contiguous, head_dim padded to 128
// by the wrapper (ops/attention.py); lse and delta (B*H, Sq) f32 (the bf16
// backward: rows zero padded to a multiple of 64).
//
// Math (as the TPU kernels):
//   forward  q arrives prescaled by log2(e)/sqrt(D) and rounded to its
//            dtype; s = q k^T in f32; columns >= kv_valid, and with causal
//            columns > row, are masked to -1e30 and their p set to 0
//            explicitly (:89-93); exp2 online softmax, P rounded to the
//            input dtype for P.V; out = o / max(l, 1e-30) and
//            lse = m*ln2 + log(max(l, 1e-30)) (natural log).
//   backward p = exp(s * (1/sqrt(D)) - lse) on an UNscaled q, in natural
//            units (bwd_prob; the bf16 kernel as exp2(s * log2(e)/sqrt(D) -
//            lse * log2(e))); ds = p (dp - delta) with dp = dO v^T and
//            delta = rowsum(dO*O) (a PyTorch op, as in JAX); dq = ds k/sqrt(D),
//            dk = ds^T q/sqrt(D), dv = p^T dO.
//
// Instances.
//  * bf16 forward: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulate), tiles in shared memory by cp.async (double-buffered),
//    XOR-swizzled 16-byte chunks for conflict-free ldmatrix - the design of
//    flash_kernel in mmdit_attention.cu: 4 warps x two 16-row q tiles = 128
//    q rows per block, 64-row K/V tiles.
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
//   backward at least 10*B*H*S^2*D = 1.30e12 FLOP: 1.32 ms bf16 (the bf16
//   kernel does exactly that; its bytes, 8 x 56.6 MB plus the f32 dq_accum
//   written and read once, are ~0.2 ms); the f32 kernels recompute s and dp
//   and do 14*B*H*S^2*D. Every call is compute-bound; the B*H*S^2
//   exponentials also load the special-function units.

#include "hopper.cuh"

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

// (bh, rows, 128) bf16 rows as a tensor map: boxes of `box` rows x 64
// lanes (128 bytes), zeros past each (b, h)'s last row.
bool map_rows(CUtensorMap* map, const void* base, int rows, int bh,
              int box) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t boxes[3] = {64, (cuuint32_t)box, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                  strides, boxes);
}

// (bh, rows, 128) f32 as a tensor map: boxes of 64 rows x 32 lanes (128
// bytes); a reduce past each (b, h)'s last row writes nothing.
bool map_rows_f32(CUtensorMap* map, void* base, int rows, int bh) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4,
                                 (cuuint64_t)rows * D * 4};
  const cuuint32_t boxes[3] = {32, BW_Q, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims,
                  strides, boxes);
}

}  // namespace

// q/k/v/out/dout/dk/dv: (bh, S, 128) contiguous, head_dim padded to 128
// by the wrapper. kv positions >= kv_valid (<= s_kv) are masked, and with
// `causal` kv positions > the q position. Every entry returns the CUDA
// error code of its launches (0 = success).

// B5: out = softmax(q k^T) v with q prescaled by log2(e)/sqrt(D); lse
// (bh, s_q) f32 in natural log. dtype: 0 = bf16 (tensor cores), 1 = f32
// (CUDA cores); 9 (cudaErrorInvalidConfiguration) for another.
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
        map_rows_f32(&P.tdq, dq_accum, s_q, bh)))
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

// B6, f32: which = 0 launches the dq kernel, 1 the dk/dv kernel; lse and
// delta (bh, s_q) f32; dq, dk, dv f32. scale = 1/sqrt(D) of the unpadded
// head width.
extern "C" int flash_bwd_f32(int which, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int bh, int s_q, int s_kv, int kv_valid,
                             int causal, float scale, void* stream) {
  return bwd_simt(which, q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q,
                  s_kv, kv_valid, causal, scale,
                  static_cast<cudaStream_t>(stream));
}

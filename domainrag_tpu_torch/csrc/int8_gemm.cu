// W8A8 int8 GEMM for Hopper (sm_90a): y = (x_q @ w_q^T) * x_s * w_s (+ b).
//
// Replaces _kernel (domainrag_tpu/ops/int8_gemm.py:117), the K-blocked
// int8 x int8 -> int32 Pallas GEMM of every quantized linear of the MMDiT
// under --w8a8 (314 per forward at full width).
//
// Math: x_q (M, K) int8, row-major; w_q (N, K) int8, K contiguous (the
// K-major layout of models.quant: the transpose of the JAX package's
// (K, N) w_q, because wgmma takes 8-bit operands only K-major); x_s (M,)
// and w_s (N,) f32; the int32 dot is exact in any order (|acc| <= K *
// 127^2 < 2^31 for K < 133k). Epilogue, in this order and with no fused
// multiply-add: acc -> f32 (round to nearest) * x_s * w_s, cast to the
// output type (bf16 or f32), then + bias in the output type (bf16 + bf16
// computed in f32 and rounded once, as torch does). Bitwise equal to
// w8a8_reference.
//
// Bound on the card: 2*M*N*K int8 operations at 1979 TOP/s, or the bytes
// (x_q, w_q, the scales and bias read once, y written once) at 3.35 TB/s.
// At 1024 px (M = 4096 / 1241 / 5337) the block GEMMs are operation-bound
// (e.g. 5337 x 3072 x 21504: 0.36 ms); the M = 1 modulation GEMMs are
// byte-bound (3072 x 18432 = 57 MB of weight, 17 us).
//
// Instances (ops/int8_gemm.py `instance` picks one per shape):
//  * wgmma (M >= 64, K % 16 == 0): a persistent grid, one block per SM
//    walking 128 x 256 output tiles (M fastest, so the blocks in flight
//    share their weight tiles in L2). Warpgroup 0 is the producer
//    (setmaxnreg down to 40): one thread TMA-loads 128-byte-swizzled K
//    tiles of 128 bytes, x_q 128 rows (16 KB) and w_q 256 rows (32 KB),
//    into an mbarrier ring of 48 KB stages, running ahead across tiles so
//    that the next tile's loads overlap this tile's epilogue. Warpgroups 1
//    and 2 (232 registers) own 64 rows each: per stage 4 k-steps of two
//    wgmma.m64n128k32.s32.s8.s8 (both operands K-major from shared
//    memory) into 128 int32 accumulators, one wgmma group kept in flight
//    (a stage is released once the group after it is issued). Epilogue,
//    bf16 out with N % 8 == 0 (every path shape): each warpgroup stages
//    its bf16 rows in shared memory a 64 x 128 half at a time (16 KB, the
//    128-byte swizzle, free of bank conflicts) and one thread hands each
//    half to the TMA unit, which stores the last while the warpgroup
//    starts its next tile; halves keep the 4 ring stages' room (226 KB in
//    all; a 3-stage ring is slower). The tile's w_s, bias and x_s are
//    read from global memory before its mainloop, so that their latency
//    passes under it. Stores from registers, 16 bytes per row per warp,
//    with the scales read in the epilogue, make the kernel 1.2-1.9x
//    slower at the large path shapes (b4_variants.py, PERF.md); they stay
//    for f32 out and N % 8 != 0. Ragged M, N and K:
//    TMA zero-fills rows and k past the extents (zeros add nothing to the
//    integer sums); rows past M and columns past N are not stored (the
//    TMA store clips them).
//  * gemv (M < 64, K % 16 == 0: the M = 1 modulation and embedder linears,
//    byte-bound): one warp per output column, 16-byte loads of its K-major
//    weight row, __dp4a against up to 8 x_q rows at a time, a shuffle sum
//    (exact in int32) and the same epilogue per element.
//  * mma (K % 16 != 0, or rows not 16-byte aligned: shapes TMA and the
//    vector loads cannot describe; no path shape): mma.sync.m16n8k32 on
//    byte-loaded, zero-filled 128 x 64 tiles of both operands, 128 x 128
//    output tiles, exact like the others.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// the epilogue: acc * x_s * w_s, cast, + bias, in that order, no FMA
// ---------------------------------------------------------------------------

template <bool F32OUT>
__device__ __forceinline__ void store_pair(void* out, long long off, float y0,
                                           float y1, const void* bias,
                                           int col, int n, bool pair_ok) {
  if (F32OUT) {
    float* o = static_cast<float*>(out) + off;
    const float* b = static_cast<const float*>(bias);
    if (b) {
      y0 = __fadd_rn(y0, b[col]);
      if (col + 1 < n) y1 = __fadd_rn(y1, b[col + 1]);
    }
    if (pair_ok) {
      *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
    } else {
      o[0] = y0;
      if (col + 1 < n) o[1] = y1;
    }
  } else {
    bf16* o = static_cast<bf16*>(out) + off;
    const bf16* b = static_cast<const bf16*>(bias);
    bf16 r0 = __float2bfloat16_rn(y0), r1 = __float2bfloat16_rn(y1);
    if (b) {
      r0 = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(r0), __bfloat162float(b[col])));
      if (col + 1 < n)
        r1 = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(r1), __bfloat162float(b[col + 1])));
    }
    if (pair_ok) {
      __nv_bfloat162 v;
      v.x = r0;
      v.y = r1;
      *reinterpret_cast<__nv_bfloat162*>(o) = v;
    } else {
      o[0] = r0;
      if (col + 1 < n) o[1] = r1;
    }
  }
}

// acc * x_s * w_s of one element, rounded after each multiply
__device__ __forceinline__ float rescale(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// One row's pairs of a thread's accumulators (element 4j + 2 hr + e: column
// n0 + 8j + 2 tig + e), from registers to global memory.
template <bool F32OUT, int J>
__device__ __forceinline__ void store_row(const int (&acc)[4 * J], int hr,
                                          int row, float sx, int n0, int tig,
                                          const float* ws, const void* bias,
                                          void* out, int n) {
  const bool vec_out = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = n0 + 8 * j + 2 * tig;
    if (col >= n) continue;
    const float y0 = rescale(acc[4 * j + 2 * hr], sx, ws[col]);
    const float y1 =
        col + 1 < n ? rescale(acc[4 * j + 2 * hr + 1], sx, ws[col + 1]) : 0.f;
    store_pair<F32OUT>(out, (long long)row * n + col, y0, y1, bias, col, n,
                       vec_out && col + 1 < n);
  }
}

// ---------------------------------------------------------------------------
// wgmma instance: persistent, TMA ring, producer + 2 consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;                  // output rows per tile
constexpr int WG_BN = 256;                  // output columns per tile
constexpr int WG_BK = 128;                  // K bytes per stage (one swizzle row)
constexpr int WG_THREADS = 384;
constexpr int WG_A = WG_BM * WG_BK;         // bytes of an x_q stage, 16 KB
constexpr int WG_B = WG_BN * WG_BK;         // bytes of a w_q stage, 32 KB
constexpr int WG_STAGE = WG_A + WG_B;
constexpr int WG_STAGES = 4;
constexpr int WG_OUT = 64 * 128 * 2;        // a warpgroup's staged half, 16 KB
constexpr int BAR_OUT = 1;                  // named barriers 1, 2: staging
constexpr int BAR_COLS = 3;                 // named barrier 3: the tile's scales
constexpr int WG_COLS = WG_BN * 6;          // the tile's w_s (f32) and bias (bf16)

constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE;   // + the staging

struct Gemm {
  CUtensorMap tx;       // x_q (m, k): boxes of 128 bytes x 128 rows
  CUtensorMap tw;       // w_q (n, k): boxes of 128 bytes x 256 rows
  CUtensorMap to;       // bf16 out (m, n), TMA_OUT: boxes of 64 x 64
  const float* xs;
  const float* ws;
  const void* bias;     // (n,) in the output type, or null
  void* out;            // (m, n)
  int m, n, k;
};

// Byte offset of the bf16 pair at (row r, column c) of a warpgroup's
// staged 64 x 128 half: two TMA boxes of 64 columns (128-byte rows, 8 KB),
// 16-byte chunk j of row r at j ^ (r & 7) (the 128-byte swizzle), so that
// the 8 rows of a warp's pairs fall in distinct banks.
__device__ __forceinline__ int out_swz(int r, int c) {
  return (c >> 6) * 8192 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}

// One row's pairs of a thread's accumulators for a 128-column half
// (columns 8j + 2 tig of the half), rescaled, cast and biased into the
// staged half; w_s and the bias of the half's columns come from shared
// memory (zeros past n, where the TMA store clips the pairs anyway).
__device__ __forceinline__ void stage_row(const int (&acc)[64], int hr,
                                          int r, float sx, int tig,
                                          const float* sw, const bf16* sb,
                                          bool bias, unsigned char* stg) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * tig;
    const float2 w = *reinterpret_cast<const float2*>(sw + c);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(sb + c);
    bf16 r0 = __float2bfloat16_rn(rescale(acc[4 * j + 2 * hr], sx, w.x));
    bf16 r1 = __float2bfloat16_rn(rescale(acc[4 * j + 2 * hr + 1], sx, w.y));
    if (bias) {
      r0 = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(r0), __bfloat162float(b.x)));
      r1 = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(r1), __bfloat162float(b.y)));
    }
    __nv_bfloat162 v;
    v.x = r0;
    v.y = r1;
    *reinterpret_cast<__nv_bfloat162*>(stg + out_swz(r, c)) = v;
  }
}

// A warpgroup's 64 rows of one 128-column half (from tile column c0) into
// its staging, then handed to the TMA unit by one thread (rows past m and
// columns past n are clipped); the staging is reused once the unit has
// read it. sx: the x_s of the thread's two rows.
__device__ __forceinline__ void store_half(const Gemm& P, const int (&acc)[64],
                                          const float (&sx)[2], int m0,
                                          int n0, int c0, int cw, int warp,
                                          int g, int tig, bool issuer,
                                          const float* sw, const bf16* sb,
                                          unsigned char* stg) {
  if (issuer) bulk_wait_read0();
  bar_sync(BAR_OUT + cw, 128);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    stage_row(acc, hr, 16 * warp + g + 8 * hr, sx[hr], tig, sw + c0, sb + c0,
              P.bias != nullptr, stg);
  fence_proxy_async();
  bar_sync(BAR_OUT + cw, 128);
  if (issuer) {
    tma_store_2d(&P.to, stg, n0 + c0, m0 + 64 * cw);
    tma_store_2d(&P.to, stg + 8192, n0 + c0 + 64, m0 + 64 * cw);
    bulk_commit();
  }
}

// TMA_OUT (bf16 out, n % 8 == 0): the epilogue stages each warpgroup's
// rows in shared memory, a half at a time, and one thread hands them to
// the TMA unit, which writes the second half while the warpgroup goes on
// to its next tile; the tile's w_s, bias and x_s are loaded into
// registers before its mainloop (one column per consumer thread), so that
// their latency passes under it, and the columns' go through shared
// memory. Otherwise pairs go from registers to global memory.
template <bool F32OUT, bool TMA_OUT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    w8a8_wgmma_kernel(const __grid_constant__ Gemm P) {
  constexpr int STAGES = WG_STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // stages on 1024-byte boundaries: the period of the 128-byte swizzle
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tiles_m = (P.m + WG_BM - 1) / WG_BM;
  const int tiles = tiles_m * ((P.n + WG_BN - 1) / WG_BN);
  const int kt_n = (P.k + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);       // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % tiles_m) * WG_BM, n0 = (t / tiles_m) * WG_BN;
        for (int kt = 0; kt < kt_n; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = ring + s * WG_STAGE;
          mbar_expect_tx(&full[s], WG_STAGE);
          tma_2d(st, &P.tx, kt * WG_BK, m0, &full[s]);
          tma_2d(st + WG_A, &P.tw, kt * WG_BK, n0, &full[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;                     // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;    // of the TMA stores
  unsigned char* stg = ring + STAGES * WG_STAGE + cw * WG_OUT;
  float* sw = reinterpret_cast<float*>(ring + STAGES * WG_STAGE + 2 * WG_OUT);
  bf16* sb = reinterpret_cast<bf16*>(sw + WG_BN);
  const int ct = threadIdx.x - 128;          // the thread's tile column
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * WG_BM, n0 = (t / tiles_m) * WG_BN;
    float col_w = 0.f, sx[2] = {0.f, 0.f};
    bf16 col_b = __float2bfloat16_rn(0.f);
    if (TMA_OUT) {
      if (n0 + ct < P.n) {
        col_w = P.ws[n0 + ct];
        if (P.bias) col_b = static_cast<const bf16*>(P.bias)[n0 + ct];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + 64 * cw + 16 * warp + g + 8 * hr;
        if (row < P.m) sx[hr] = P.xs[row];
      }
    }
    // accumulator element 4j + e: row 16 warp + g + 8 (e >> 1) of the
    // warpgroup's 64, column 8j + 2 tig + (e & 1) of its 128-column half
    int acc0[64], acc1[64];
    for (int kt = 0; kt < kt_n; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = ring + s * WG_STAGE;
      const uint64_t da = smem_desc(st + 64 * WG_BK * cw, 16, 1024);
      const uint64_t db0 = smem_desc(st + WG_A, 16, 1024);
      const uint64_t db1 = smem_desc(st + WG_A + 128 * WG_BK, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk) {
        const int accumulate = kt > 0 || kk > 0;
        wgmma_s8_ss(acc0, da + 2 * kk, db0 + 2 * kk, accumulate);
        wgmma_s8_ss(acc1, da + 2 * kk, db1 + 2 * kk, accumulate);
      }
      wgmma_commit();
      // the group before this one is done: its stage can be refilled
      wgmma_wait1();
      if (kt > 0 && lane == 0)
        mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
    }
    wgmma_wait0();
    fence_regs(acc0);
    fence_regs(acc1);
    if (lane == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);

    if (TMA_OUT) {
      // both warpgroups are done with the last tile's columns
      bar_sync(BAR_COLS, 256);
      sw[ct] = col_w;
      sb[ct] = col_b;
      bar_sync(BAR_COLS, 256);
      store_half(P, acc0, sx, m0, n0, 0, cw, warp, g, tig, issuer, sw, sb,
                 stg);
      store_half(P, acc1, sx, m0, n0, 128, cw, warp, g, tig, issuer, sw, sb,
                 stg);
    } else {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + 64 * cw + 16 * warp + g + 8 * hr;
        if (row >= P.m) continue;
        const float sx = P.xs[row];
        store_row<F32OUT, 16>(acc0, hr, row, sx, n0, tig, P.ws, P.bias,
                              P.out, P.n);
        store_row<F32OUT, 16>(acc1, hr, row, sx, n0 + 128, tig, P.ws,
                              P.bias, P.out, P.n);
      }
    }
  }
  if (TMA_OUT && issuer) bulk_wait_read0();    // the staging outlives its reads
}

// ---------------------------------------------------------------------------
// gemv instance: M < 64, one warp per output column
// ---------------------------------------------------------------------------

constexpr int GV_THREADS = 256;
constexpr int GV_ROWS = 8;                  // x_q rows per pass over a column

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

template <bool F32OUT>
__global__ void __launch_bounds__(GV_THREADS)
    w8a8_gemv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws,
                     const void* __restrict__ bias, void* __restrict__ out,
                     int m, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * (GV_THREADS / 32) + (threadIdx.x >> 5);
  if (col >= n) return;
  const int8_t* wr = w + (long long)col * k;
  for (int m0 = 0; m0 < m; m0 += GV_ROWS) {
    int acc[GV_ROWS];
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) acc[r] = 0;
#pragma unroll 4
    for (int c = 16 * lane; c < k; c += 512) {
      const int4 wv = *reinterpret_cast<const int4*>(wr + c);
#pragma unroll
      for (int r = 0; r < GV_ROWS; ++r)
        if (m0 + r < m)
          acc[r] = dot16(
              *reinterpret_cast<const int4*>(x + (long long)(m0 + r) * k + c),
              wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
#pragma unroll
    for (int r = 0; r < GV_ROWS; ++r) {
      const int row = m0 + r;
      if (lane == r && row < m)
        store_pair<F32OUT>(out, (long long)row * n + col,
                           rescale(acc[r], xs[row], ws[col]), 0.f, bias, col,
                           col + 1, false);
    }
  }
}

// ---------------------------------------------------------------------------
// mma instance: any K (mma.sync on byte-loaded tiles)
// ---------------------------------------------------------------------------

constexpr int MS_BM = 128;                  // output rows (and columns) per tile
constexpr int MS_BK = 64;                   // K bytes per tile
constexpr int MS_THREADS = 256;
constexpr int MS_WM = 64;                   // warp tile rows
constexpr int MS_WN = 32;                   // warp tile columns
constexpr int MS_MT = MS_WM / 16;           // 16-row MMA tiles per warp
constexpr int MS_NT = MS_WN / 8;            // 8-column MMA tiles per warp

// Byte offset of 16-byte chunk c (0..3) of row r in a (rows, 64-byte) tile:
// chunk c lives at c ^ ((r >> 1) & 3), so the 8 rows of an ldmatrix read
// fall in 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * MS_BK + ((c ^ ((r >> 1) & 3)) << 4);
}

// Rows [r0, r0 + 128) x k [k0, k0 + 64) of a (rows, k) int8 matrix into a
// tile, byte by byte, zero-filled past `rows` and k.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int rows, int k, int r0, int k0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < MS_BM * MS_BK / 16 / MS_THREADS; ++i) {
    const int idx = tid + i * MS_THREADS;
    const int r = idx >> 2, c = idx & 3;
    const int row = r0 + r, col = k0 + 16 * c;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = col + 4 * j + e;
        if (row < rows && cc < k)
          word |= (uint32_t)(uint8_t)src[(long long)row * k + cc] << (8 * e);
      }
      v[j] = word;
    }
    *reinterpret_cast<uint4*>(dst + swz(r, c)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <bool F32OUT>
__global__ void __launch_bounds__(MS_THREADS)
    w8a8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ xs,
                    const float* __restrict__ ws,
                    const void* __restrict__ bias, void* __restrict__ out,
                    int m, int n, int k) {
  __shared__ __align__(128) int8_t sA[MS_BM * MS_BK];
  __shared__ __align__(128) int8_t sB[MS_BM * MS_BK];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * MS_BM, n0 = blockIdx.x * MS_BM;

  int acc[MS_MT][MS_NT][4];
#pragma unroll
  for (int i = 0; i < MS_MT; ++i)
#pragma unroll
    for (int j = 0; j < MS_NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int k0 = 0; k0 < k; k0 += MS_BK) {
    __syncthreads();
    load_tile(sA, x, m, k, m0, k0, tid);
    load_tile(sB, w, n, k, n0, k0, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MS_BK / 32; ++ks) {
      const int mi = lane >> 3;
      uint32_t a[MS_MT][4];
#pragma unroll
      for (int i = 0; i < MS_MT; ++i)
        ldmatrix_x4(a[i], sA + swz(wm * MS_WM + 16 * i + ((mi & 1) << 3) +
                                       (lane & 7),
                                   2 * ks + (mi >> 1)));
#pragma unroll
      for (int p = 0; p < MS_NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, sB + swz(wn * MS_WN + 16 * p + ((mi >> 1) << 3) +
                                    (lane & 7),
                                2 * ks + (mi & 1)));
#pragma unroll
        for (int i = 0; i < MS_MT; ++i) {
          mma_s8(acc[i][2 * p], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  const bool vec_out = (n & 1) == 0;
#pragma unroll
  for (int i = 0; i < MS_MT; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * MS_WM + 16 * i + g + 8 * hr;
      if (row >= m) continue;
      const float sx = xs[row];
#pragma unroll
      for (int j = 0; j < MS_NT; ++j) {
        const int col = n0 + wn * MS_WN + 8 * j + 2 * tig;
        if (col >= n) continue;
        const float y0 = rescale(acc[i][j][2 * hr], sx, ws[col]);
        const float y1 =
            col + 1 < n ? rescale(acc[i][j][2 * hr + 1], sx, ws[col + 1])
                        : 0.f;
        store_pair<F32OUT>(out, (long long)row * n + col, y0, y1, bias, col,
                           n, vec_out && col + 1 < n);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// (rows, k) int8, k a multiple of 16: boxes of 128 bytes x `box` rows,
// zeros past the last row and k.
bool map_k_major(CUtensorMap* map, const void* base, int k, int rows,
                 int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t boxes[2] = {WG_BK, (cuuint32_t)box};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides,
                  boxes);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// bf16 (m, n), n % 8 == 0: boxes of 64 columns x 64 rows, 128-byte
// swizzle; a store past m or n writes nothing.
bool map_out(CUtensorMap* map, void* out, int m, int n) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t boxes[2] = {64, 64};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims,
                  strides, boxes);
}

template <bool F32OUT, bool TMA_OUT>
int launch_wgmma(const Gemm& P, int tiles, cudaStream_t st) {
  constexpr int SMEM = WG_SMEM + (TMA_OUT ? 2 * WG_OUT + WG_COLS : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      w8a8_wgmma_kernel<F32OUT, TMA_OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  w8a8_wgmma_kernel<F32OUT, TMA_OUT><<<grid, WG_THREADS, SMEM, st>>>(P);
  return (int)cudaGetLastError();
}

template <bool F32OUT>
int launch(const void* xq, const void* wq, const void* xs, const void* ws,
           const void* bias, void* out, int m, int n, int k, int instance,
           cudaStream_t st) {
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* fx = static_cast<const float*>(xs);
  const float* fw = static_cast<const float*>(ws);
  if (instance == 0) {
    Gemm P;
    if (!(map_k_major(&P.tx, xq, k, m, WG_BM) &&
          map_k_major(&P.tw, wq, k, n, WG_BN)))
      return (int)cudaErrorInvalidValue;
    P.xs = fx;
    P.ws = fw;
    P.bias = bias;
    P.out = out;
    P.m = m;
    P.n = n;
    P.k = k;
    const int tiles = ((m + WG_BM - 1) / WG_BM) * ((n + WG_BN - 1) / WG_BN);
    const bool tma_out = !F32OUT && n % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!tma_out) return launch_wgmma<F32OUT, false>(P, tiles, st);
    if (!map_out(&P.to, out, m, n)) return (int)cudaErrorInvalidValue;
    return launch_wgmma<false, true>(P, tiles, st);
  } else if (instance == 1) {
    const int per = GV_THREADS / 32;
    w8a8_gemv_kernel<F32OUT><<<(n + per - 1) / per, GV_THREADS, 0, st>>>(
        x, w, fx, fw, bias, out, m, n, k);
  } else {
    const dim3 grid((n + MS_BM - 1) / MS_BM, (m + MS_BM - 1) / MS_BM);
    w8a8_mma_kernel<F32OUT><<<grid, MS_THREADS, 0, st>>>(x, w, fx, fw, bias,
                                                         out, m, n, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x_q (m, k) int8 row-major, w_q (n, k) int8 row-major (K-major), x_s (m,)
// f32, w_s (n,) f32, bias (n,) in the output type or null, out (m, n) bf16
// (out_f32 = 0) or f32 (out_f32 = 1). instance: 0 = wgmma, 1 = gemv (both
// need k % 16 == 0 and 16-byte aligned x_q and w_q), 2 = mma (any shape).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int w8a8_gemm(const void* xq, const void* wq, const void* xs,
                         const void* ws, const void* bias, void* out, int m,
                         int n, int k, int out_f32, int instance,
                         void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || instance < 0 || instance > 2)
    return (int)cudaErrorInvalidValue;
  if (instance < 2 && (k % 16 != 0 ||
                       reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
                       reinterpret_cast<uintptr_t>(wq) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<true>(xq, wq, xs, ws, bias, out, m, n, k, instance,
                                st)
                 : launch<false>(xq, wq, xs, ws, bias, out, m, n, k,
                                 instance, st);
}

// W8A8 int8 GEMM for Hopper (sm_90a): y = (x_q @ w_q) * x_s * w_s (+ b).
//
// Replaces _kernel (domainrag_tpu/ops/int8_gemm.py:117), the K-blocked
// int8 x int8 -> int32 Pallas GEMM of every quantized linear of the MMDiT
// under --w8a8 (314 per forward at full width).
//
// Math: x_q (M, K) int8, row-major; w_q (K, N) int8, row-major (N
// contiguous, the (in, out) layout of models.quant); x_s (M,) and w_s (N,)
// f32; the int32 dot is exact (|acc| <= K * 127^2 < 2^31 for K < 133k).
// Epilogue, in this order and with no fused multiply-add: acc -> f32
// (round to nearest) * x_s * w_s, cast to the output type (bf16 or f32),
// then + bias in the output type (bf16 + bf16 computed in f32 and rounded
// once, as torch does). Bitwise equal to w8a8_reference.
//
// Bound on the card: 2*M*N*K int8 operations at 1979 TOP/s, or the bytes
// (x_q, w_q, the scales and bias read once, y written once) at 3.35 TB/s.
// At 1024 px (M = 4096 / 1241 / 5337) the block GEMMs are operation-bound
// (e.g. 5337 x 3072 x 21504: 0.36 ms); the M = 1 modulation GEMMs are
// byte-bound (3072 x 18432 = 57 MB of weight, 17 us).
//
// Design (a simple kernel first; wgmma and TMA are later work):
//  * The int8 tensor cores through mma.sync.m16n8k32.s8.s8.s32. A block of
//    8 warps (2 along M x 4 along N) owns a 128 x 128 output tile; each
//    warp a 64 x 32 tile (4 x 4 MMA tiles, 64 int32 accumulators).
//  * The MMA's B operand wants 4 consecutive k of one column in a 32-bit
//    register, but w_q stores n contiguously and ldmatrix .trans works on
//    16-bit elements only. The weight layout of models.quant is kept (the
//    JAX-quantized tree crosses the bridge unchanged), so the kernel
//    transposes each 64 (k) x 128 (n) weight tile while staging it: a
//    thread reads 4 k-rows x 8 n-bytes, transposes the 4 x 4 byte blocks
//    with __byte_perm and stores 8 words into an n-major shared tile, from
//    which ldmatrix (non-transposed) gives the B fragments. x_q tiles are
//    already k-contiguous and go through cp.async.
//  * Two shared-memory stages (32 KB): the next x tile is copied by
//    cp.async and the next weight tile is held in registers while the
//    current one is multiplied. 16-byte chunks are XOR-swizzled so that
//    ldmatrix reads are free of bank conflicts.
//  * Ragged edges are masked, never padded: rows past M and k past K are
//    zero-filled on load, columns past N are not stored. K % 16 == 0 and
//    N % 8 == 0 with aligned pointers take vector loads; any other shape
//    takes byte loads (a slower, equally exact instance).
//  * M = 1 launches (83 of the 314 per forward) use one row of a 128-row
//    tile; they are byte-bound and their time is written down in PERF.md.

#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int WM = 64;              // warp tile rows
constexpr int WN = 32;              // warp tile columns
constexpr int MT = WM / 16;         // 16-row MMA tiles per warp
constexpr int NT = WN / 8;          // 8-column MMA tiles per warp
constexpr int TILE = BM * BK;       // bytes of one A (or B) stage

// Byte offset of 16-byte chunk c (0..3) of row r in a (rows, 64-byte)
// tile: chunk c lives at c ^ ((r >> 1) & 3), so the 8 rows of an ldmatrix
// read fall in 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

// x rows [m0, m0 + 128) x k [k0, k0 + 64) into a stage, zero-filled past
// M and K.
template <bool VEC>
__device__ __forceinline__ void load_x(int8_t* st, const int8_t* x, int m,
                                       int k, int m0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < BM * BK / 16 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 2, c = idx & 3;
    const int row = m0 + r, col = k0 + 16 * c;
    if (VEC) {
      const bool ok = row < m && col < k;
      cp_async16(st + swz(r, c),
                 ok ? x + (long long)row * k + col : x, ok);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = col + 4 * j + e;
          if (row < m && cc < k)
            v |= (uint32_t)(uint8_t)x[(long long)row * k + cc] << (8 * e);
        }
        w[j] = v;
      }
      *reinterpret_cast<uint4*>(st + swz(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One thread's share of a weight tile: k rows k0 + 4*kq + (0..3), columns
// n0 + 8*ng + (0..7), as 4 x 2 words (row-major bytes).
template <bool VEC>
__device__ __forceinline__ void fetch_w(uint32_t (&r)[4][2], const int8_t* w,
                                        int k, int n, int k0, int n0,
                                        int tid) {
  const int kq = tid >> 4, ng = tid & 15;
  const int col = n0 + 8 * ng;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = k0 + 4 * kq + j;
    if (VEC && row < k && col + 8 <= n) {
      const uint2 v =
          *reinterpret_cast<const uint2*>(w + (long long)row * n + col);
      r[j][0] = v.x;
      r[j][1] = v.y;
    } else {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (row < k && col + e < n) {
          const uint32_t b = (uint8_t)w[(long long)row * n + col + e];
          if (e < 4)
            lo |= b << (8 * e);
          else
            hi |= b << (8 * (e - 4));
        }
      }
      r[j][0] = lo;
      r[j][1] = hi;
    }
  }
}

// Transposes the fetched 4 x 8 bytes into 8 n-rows of 4 k-bytes of the
// n-major stage.
__device__ __forceinline__ void store_w(int8_t* st, const uint32_t (&r)[4][2],
                                        int tid) {
  const int kq = tid >> 4, ng = tid & 15;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // rows a, b, c, d (k) of 4 n-bytes each -> 4 words of 4 k-bytes each
    const uint32_t t0 = __byte_perm(r[0][h], r[1][h], 0x5140);
    const uint32_t t1 = __byte_perm(r[0][h], r[1][h], 0x7362);
    const uint32_t t2 = __byte_perm(r[2][h], r[3][h], 0x5140);
    const uint32_t t3 = __byte_perm(r[2][h], r[3][h], 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nr = 8 * ng + 4 * h + e;
      *reinterpret_cast<uint32_t*>(st + swz(nr, kq >> 2) + 4 * (kq & 3)) =
          o[e];
    }
  }
}

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

template <bool VEC_X, bool VEC_W, bool F32OUT>
__global__ void __launch_bounds__(THREADS)
    w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ xs, const float* __restrict__ ws,
                const void* __restrict__ bias, void* __restrict__ out, int m,
                int n, int k) {
  __shared__ __align__(128) int8_t sA[2][TILE];
  __shared__ __align__(128) int8_t sB[2][TILE];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_n = (k + BK - 1) / BK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  uint32_t wr[4][2];
  load_x<VEC_X>(sA[0], x, m, k, m0, 0, tid);
  cp_async_commit();
  fetch_w<VEC_W>(wr, w, k, n, 0, n0, tid);
  store_w(sB[0], wr, tid);

  for (int kt = 0; kt < kt_n; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < kt_n;
    if (more) {
      load_x<VEC_X>(sA[buf ^ 1], x, m, k, m0, (kt + 1) * BK, tid);
      cp_async_commit();
      fetch_w<VEC_W>(wr, w, k, n, (kt + 1) * BK, n0, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* ta = sA[buf];
    const int8_t* tb = sB[buf];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int mi = lane >> 3;
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], ta + swz(wm * WM + 16 * i + ((mi & 1) << 3) +
                                       (lane & 7),
                                   2 * ks + (mi >> 1)));
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, tb + swz(wn * WN + 16 * p + ((mi >> 1) << 3) +
                                    (lane & 7),
                                2 * ks + (mi & 1)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(acc[i][2 * p], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
    if (more) store_w(sB[buf ^ 1], wr, tid);
  }

  // epilogue: acc -> f32 * x_s * w_s, cast, + bias (in the output type)
  const bool vec_out = (n & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * WM + 16 * i + g + 8 * hr;
      if (row >= m) continue;
      const float sx = xs[row];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + 8 * j + 2 * tig;
        if (col >= n) continue;
        const float y0 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * hr]), sx), ws[col]);
        const float y1 =
            col + 1 < n
                ? __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hr + 1]),
                                      sx),
                            ws[col + 1])
                : 0.f;
        store_pair<F32OUT>(out, (long long)row * n + col, y0, y1, bias, col,
                           n, vec_out && col + 1 < n);
      }
    }
  }
}

template <bool VEC_X, bool VEC_W, bool F32OUT>
int launch(const void* x, const void* w, const void* xs, const void* ws,
           const void* bias, void* out, int m, int n, int k,
           cudaStream_t st) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  w8a8_kernel<VEC_X, VEC_W, F32OUT><<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws), bias,
      out, m, n, k);
  return (int)cudaGetLastError();
}

template <bool VEC_X, bool VEC_W>
int launch_out(const void* x, const void* w, const void* xs, const void* ws,
               const void* bias, void* out, int m, int n, int k, int out_f32,
               cudaStream_t st) {
  return out_f32 ? launch<VEC_X, VEC_W, true>(x, w, xs, ws, bias, out, m, n,
                                              k, st)
                 : launch<VEC_X, VEC_W, false>(x, w, xs, ws, bias, out, m, n,
                                               k, st);
}

}  // namespace

// x_q (m, k) int8 row-major, w_q (k, n) int8 row-major, x_s (m,) f32,
// w_s (n,) f32, bias (n,) in the output type or null, out (m, n) bf16
// (out_f32 = 0) or f32 (out_f32 = 1). Returns the CUDA error code of the
// launch (0 = success).
extern "C" int w8a8_gemm(const void* xq, const void* wq, const void* xs,
                         const void* ws, const void* bias, void* out, int m,
                         int n, int k, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vx = k % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  const bool vw = n % 8 == 0 && reinterpret_cast<uintptr_t>(wq) % 8 == 0;
  if (vx && vw)
    return launch_out<true, true>(xq, wq, xs, ws, bias, out, m, n, k,
                                  out_f32, st);
  if (vx)
    return launch_out<true, false>(xq, wq, xs, ws, bias, out, m, n, k,
                                   out_f32, st);
  if (vw)
    return launch_out<false, true>(xq, wq, xs, ws, bias, out, m, n, k,
                                   out_f32, st);
  return launch_out<false, false>(xq, wq, xs, ws, bias, out, m, n, k,
                                  out_f32, st);
}

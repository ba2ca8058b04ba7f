// LayerNorm (no affine) + AdaLN modulation for Hopper (sm_90a): the Flux
// MMDiT's `_modulate(_ln_no_affine(x), shift, scale)`
// (models/flux/model.py) in one pass over the stream.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA,
// which fuses it on the TPU. Eager PyTorch runs it as ~13 kernels that
// write and read back f32 intermediates (~68 bytes per element); this
// kernel reads each bf16 row once and writes the modulated row once.
// It runs 115 times per full-width forward (4 per double block, 1 per
// single block, 1 in the output layer).
//
// Math per row of width h, with the eager path's roundings:
//   mean = sum(x) / h, var = sum((x - mean)^2) / h       (f32; two passes
//          over the row held in registers, never E[x^2] - E[x]^2)
//   n    = bf16((x - mean) * rsqrt(var + eps))            (f32, rounded)
//   a    = bf16(1 + scale); p = bf16(n * a); out = bf16(p + shift)
// Every product and sum is rounded alone (no fused multiply-add), so the
// output differs from eager only where the f32 sums' order moves n across
// a rounding boundary: by 1 bf16 ulp of n (more of the output's where
// p + shift cancels).
//
// Bound on the card: bytes. x read once and out written once, 4 bytes an
// element (shift and scale are 2h per batch element, cached): the joint
// stream of a 1024 px batch of 5 (5 x 5337 x 3072, 328 MB) takes 0.098 ms
// at 3.35 TB/s, of a 2048 px batch (5 x 17625 x 3072, 1.08 GB) 0.323 ms.
//
// Design. One warp per row, the row held in registers as NV 16-byte
// vectors a lane (NV = ceil(h / 256); 12 at h = 3072, so each lane has 12
// loads in flight before its first add); the warp's butterfly sums give
// every lane the same statistics. A grid-stride walk over the B*S rows
// with as many blocks as fit the card at once. No reduction crosses rows,
// so a row's bits do not depend on the batch or the rows launched. x is
// read through a batch and a row stride (the output layer passes the
// image slice of the joint stream, a view), shift and scale through a
// batch stride (the .chunk views of the (B, 6h) modulation); out is
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;        // rows in flight per block
constexpr int MAX_NV = 16;      // widths up to 16 x 32 lanes x 8 = 4096

__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane adds the same pairs, so every lane ends
  // with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one element: n = bf16((x - mean) * rstd), then the modulation
__device__ __forceinline__ float modulate(float x, float a, float t,
                                          float mean, float rstd) {
  const float n = round_bf16(__fmul_rn(__fsub_rn(x, mean), rstd));
  const float p = round_bf16(__fmul_rn(n, round_bf16(__fadd_rn(1.f, a))));
  return __fadd_rn(p, t);         // rounded to bf16 by the store
}

__device__ __forceinline__ uint32_t modulate2(uint32_t x, uint32_t a,
                                              uint32_t t, float mean,
                                              float rstd) {
  const __nv_bfloat162 o = __floats2bfloat162_rn(
      modulate(lo(x), lo(a), lo(t), mean, rstd),
      modulate(hi(x), hi(a), hi(t), mean, rstd));
  return *reinterpret_cast<const uint32_t*>(&o);
}

struct Args {
  const bf16* x;
  long long x_batch, x_row;       // elements
  const bf16* shift;
  const bf16* scale;
  long long shift_batch, scale_batch;
  bf16* out;                      // (B, S, h), contiguous
  int seq;                        // S
  long long rows;                 // B * S
  int width;                      // h
  float eps;
};

template <int NV>
__global__ void __launch_bounds__(WARPS * 32)
adaln_modulate_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int nvec = a.width >> 3;
  const float inv_w = 1.f / (float)a.width;
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       r < a.rows; r += (long long)gridDim.x * WARPS) {
    const long long b = r / a.seq, s = r - b * a.seq;
    const uint4* src =
        reinterpret_cast<const uint4*>(a.x + b * a.x_batch + s * a.x_row);
    uint4 v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec) v[i] = src[lane + 32 * i];

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i >= nvec) continue;
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum = __fadd_rn(__fadd_rn(sum, lo(w[j])), hi(w[j]));
    }
    const float mean = __fmul_rn(warp_sum(sum), inv_w);

    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i >= nvec) continue;
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d0 = __fsub_rn(lo(w[j]), mean);
        const float d1 = __fsub_rn(hi(w[j]), mean);
        sq = __fadd_rn(__fadd_rn(sq, __fmul_rn(d0, d0)), __fmul_rn(d1, d1));
      }
    }
    const float rstd =
        rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_w), a.eps));

    const uint4* sh = reinterpret_cast<const uint4*>(a.shift +
                                                     b * a.shift_batch);
    const uint4* sc = reinterpret_cast<const uint4*>(a.scale +
                                                     b * a.scale_batch);
    uint4* dst = reinterpret_cast<uint4*>(a.out + r * a.width);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c >= nvec) continue;
      const uint4 g = sc[c], t = sh[c];
      uint4 o;
      o.x = modulate2(v[i].x, g.x, t.x, mean, rstd);
      o.y = modulate2(v[i].y, g.y, t.y, mean, rstd);
      o.z = modulate2(v[i].z, g.z, t.z, mean, rstd);
      o.w = modulate2(v[i].w, g.w, t.w, mean, rstd);
      dst[c] = o;
    }
  }
}

template <int NV>
int launch(const Args& a, cudaStream_t st) {
  // blocks resident per SM for this instance, asked once
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adaln_modulate_kernel<NV>, WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (a.rows + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(need < cap ? need : cap);
  adaln_modulate_kernel<NV><<<grid, WARPS * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const Args&, cudaStream_t);

const LaunchFn LAUNCH[MAX_NV + 1] = {
    nullptr,     launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,
    launch<6>,   launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>,
    launch<12>,  launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

// x: (B, S, h) bf16 with unit lane stride, rows `x_row` and batch
// elements `x_batch` elements apart; shift, scale: (B, h) bf16 with unit
// lane stride, batch elements `*_batch` elements apart; out: (B, S, h)
// bf16, contiguous. h a multiple of 8 up to 4096, every stride a multiple
// of 8 elements and every base 16-byte aligned (the 16-byte vectors'
// rule). Returns the CUDA error code of the launch (0 = success).
extern "C" int adaln_modulate(const void* x, long long x_batch,
                              long long x_row, const void* shift,
                              long long shift_batch, const void* scale,
                              long long scale_batch, void* out, int batch,
                              int seq, int width, float eps, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0 || width % 8 ||
      width > MAX_NV * 256)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), x_batch, x_row,
               static_cast<const bf16*>(shift),
               static_cast<const bf16*>(scale), shift_batch, scale_batch,
               static_cast<bf16*>(out), seq, (long long)batch * seq, width,
               eps};
  return LAUNCH[(width / 8 + 31) / 32](a, static_cast<cudaStream_t>(stream));
}

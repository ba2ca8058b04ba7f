// Fused inner-product GEMM + exact top-k for Hopper (sm_90a): B8.
//
// Replaces _topk_kernel (domainrag_tpu/ops/topk.py:183), reached through
// topk_ip_pallas (:259): the stage-2 first-stage search of L2-normalised
// CLIP queries (Q, d) against the corpus bank (N, d), both f32.
//
// Math: score[q][n] = sum_k query[q][k] * bank[n][k], a true f32 sum of
// products (FFMA on the CUDA cores, one sequential FMA chain per score, k
// ascending; no TF32, which would break the identical-indices-to-FAISS
// contract). Each query row keeps the k best (score, index) pairs in the
// total order (score desc, index asc). A score enters only when it is above
// -FLT_MAX (the Pallas kernel's masked value), and a row with fewer than k
// entries is padded with (-FLT_MAX, 2^31 - 1), as topk_ip_pallas returns
// for k > N. Any k >= 1 (topk_ip_pallas pads k to a multiple of 128 and
// has no upper limit either).
//
// Bound on the card: 2*Q*N*d operations at the f32 FMA peak (67 TFLOP/s),
// or the bytes (queries and bank read once, 8*Q*k written) at 3.35 TB/s.
// At the stage-2 shape, 200 queries x 178,287 bank rows x 512, k = 100:
// 36.5 GFLOP = 0.545 ms of FFMA against 365 MB = 0.109 ms of bytes, so
// operation-bound: the GEMM has to keep the FMA pipes issuing, and the
// selection has to stay off the GEMM's path.
//
// Design (the Pallas kernel's grid carries the running top-k across bank
// tiles in VMEM, which a Hopper grid cannot do across blocks, hence two
// passes):
//  * Pass 1, topk_partial<TQ, WIDE>: the grid is (query tiles of TQ rows) x
//    (bank splits), one block of 8 warps per SM, one wave. A block streams
//    its split in 256-row bank tiles, each as 32-lane (128-byte) chunks of
//    d: thread 0 has the TMA unit load each chunk of the bank tile and of
//    the query tile (128-byte swizzle, zeros past d, N and Q) into a 3-stage
//    ring on mbarriers. A warp's lanes are 4 query rows x 8 bank rows and
//    a thread keeps TMq x TMn scores (4 x 8, 4 x 4, 2 x 4 for TQ = 32, 16,
//    8): per 16-byte chunk of d it reads TMq query and TMn bank float4,
//    each one 128-byte wavefront (the swizzle puts 8 rows' chunks on
//    distinct banks), then 4 FMAs per score.
//  * Selection (FAISS's WarpSelect/BlockSelect idea, Johnson, Douze and
//    Jegou, arXiv:1702.08734): each row keeps its running list sorted in
//    the total order (kp = k rounded up to a power of two, >= 32, padded
//    with fillers) and its threshold, the list's k-th entry. After a bank
//    tile, every score that beats its row's threshold is appended to the
//    row's candidate buffer (a slot from a shared-memory atomic); nothing
//    is shifted. A row whose buffer holds more than FLUSH_AT entries (so
//    that the next tile could overflow it), and every row at the split's
//    end, is merged by one warp: the buffer is bitonic-sorted in chunks of
//    up to 256, each chunk merged into the list (the elementwise better of
//    list[i] and chunk[kp - 1 - i] is the top kp as a bitonic sequence,
//    which a bitonic merge sorts), and the threshold raised. Random data
//    merges a few times per (row, split); an ascending bank, where every
//    candidate beats the threshold, once per tile.
//  * Lists and buffers live in shared memory up to kp = 1024 (TQ 32 rows
//    for kp <= 128, 16 for 256, 8 above); above that (WIDE) each row's
//    list lives in its own slot of the (Q, splits, kp) scratch in global
//    memory (L1-cached; only the owning warp touches it) and the buffers
//    stay in shared memory. Each (row, split) list's first k entries go to
//    the scratch.
//  * Pass 2, topk_merge: one warp per query row merges the sorted split
//    lists by a tournament (warp argmax of the list heads, k times).
//  * Ragged Q, N and d edges are zero-filled by the TMA unit and masked;
//    the wrapper hands d % 4 == 0, 16-byte aligned rows (TMA's strides).

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TN = 256;          // bank rows per tile
constexpr int TK = 32;           // d per ring stage: one 128-byte TMA box
constexpr int THREADS = 256;     // 8 warps
constexpr int STAGES = 3;
constexpr int BUF = 320;         // candidate slots per row
constexpr int FLUSH_AT = BUF - TN;   // more entries: merged before the next
                                     // tile can append TN more
constexpr int CHUNK = 256;       // buffer entries sorted and merged at once
constexpr int KP_SHARED = 1024;  // larger lists live in the scratch
constexpr int MAX_SPLITS = 256;
constexpr int LISTS_PER_LANE = MAX_SPLITS / 32;
constexpr float NEG = -FLT_MAX;
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// acc[i][j] += a[i] . b[j] over four consecutive d: each score's FMA chain
// stays in d order, and the M x N FMAs of each of its 4 steps are
// independent of one another.
template <int M, int N>
__device__ __forceinline__ void fma_chunk(float (&acc)[M][N], float4 (&a)[M],
                                          float4 (&b)[N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
}

// s/id[0 .. len) (len a power of two) sorted in the total order by one
// warp; a power-of-two run starting at a multiple of `size` sorts
// descending when i & size is 0 (and ascending otherwise).
__device__ void warp_sort(float* s, int* id, int len, int lane) {
  for (int size = 2; size <= len; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < len / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const float a = s[i], b = s[j];
        const int ia = id[i], ib = id[j];
        if ((i & size) == 0 ? beats(b, ib, a, ia) : beats(a, ia, b, ib)) {
          s[i] = b; s[j] = a; id[i] = ib; id[j] = ia;
        }
      }
      __syncwarp();
    }
}

// A bitonic s/id[0 .. len) sorted descending in the total order by one warp.
__device__ void warp_merge(float* s, int* id, int len, int lane) {
  for (int stride = len >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < len / 2; t += 32) {
      const int i = 2 * t - (t & (stride - 1)), j = i + stride;
      const float a = s[i], b = s[j];
      const int ia = id[i], ib = id[j];
      if (beats(b, ib, a, ia)) { s[i] = b; s[j] = a; id[i] = ib; id[j] = ia; }
    }
    __syncwarp();
  }
}

// Merges a row's buffer (n entries) into its sorted list (kp entries) and
// sets the row's threshold to the list's k-th entry.
__device__ void flush(float* ls, int* li, float* bs, int* bi, int n, int kp,
                      int k, int lane, float* ts, int* ti) {
  for (int base = 0; base < n; base += CHUNK) {
    const int m = min(CHUNK, n - base);
    int len = 32;
    while (len < m) len <<= 1;
    float* cs = bs + base;
    int* ci = bi + base;
    for (int x = m + lane; x < len; x += 32) { cs[x] = NEG; ci[x] = IMAX; }
    __syncwarp();
    warp_sort(cs, ci, len, lane);
    // the better of list[i] and chunk[kp - 1 - i]: the top kp, bitonic
    for (int i = lane; i < kp; i += 32) {
      const int x = kp - 1 - i;
      if (x < len && beats(cs[x], ci[x], ls[i], li[i])) {
        ls[i] = cs[x];
        li[i] = ci[x];
      }
    }
    __syncwarp();
    warp_merge(ls, li, kp, lane);
  }
  if (lane == 0) {
    *ts = ls[k - 1];
    *ti = li[k - 1];
  }
}

// One block per (query tile, split). part_s/part_i: (nq, splits, kp).
template <int TQ, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
topk_partial(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap bmap,
             float* __restrict__ part_s, int* __restrict__ part_i, int nq,
             int n, int d, int k, int kp, int splits, int split_rows) {
  constexpr int WQ = TQ == 32 ? 2 : 1;    // warps along the query rows
  constexpr int WN = 8 / WQ;              // and along the bank rows
  constexpr int TMq = TQ / (4 * WQ);      // query rows per thread
  constexpr int TMn = TN / (8 * WN);      // bank rows per thread
  constexpr int STAGE = (TN + TQ) * TK;   // floats per ring stage
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  float* buf_s = ring + STAGES * STAGE;               // TQ x BUF
  int* buf_i = reinterpret_cast<int*>(buf_s + TQ * BUF);
  float* lst_s = reinterpret_cast<float*>(buf_i + TQ * BUF);  // TQ x kp
  int* lst_i = reinterpret_cast<int*>(lst_s + (WIDE ? 0 : TQ * kp));
  int* cnt = lst_i + (WIDE ? 0 : TQ * kp);
  float* thr_s = reinterpret_cast<float*>(cnt + TQ);
  int* thr_i = reinterpret_cast<int*>(thr_s + TQ);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y;
  const int nb = split * split_rows;
  const int n_end = min(n, nb + split_rows);
  const int ntiles = (n_end - nb + TN - 1) / TN;
  const int nchunks = (d + TK - 1) / TK;
  const int steps = ntiles * nchunks;
  const int wq = warp % WQ, wn = warp / WQ;
  // the thread's query rows qr + 4 i and bank rows nr + 8 j of a tile
  const int qr = 4 * TMq * wq + (lane >> 3), nr = 8 * TMn * wn + (lane & 7);
  // row r's running list and its slot of the scratch
  auto slot = [&](int r) { return ((size_t)(q0 + r) * splits + split) * kp; };
  auto list_s = [&](int r) { return WIDE ? part_s + slot(r) : lst_s + r * kp; };
  auto list_i = [&](int r) { return WIDE ? part_i + slot(r) : lst_i + r * kp; };

  auto issue = [&](int u) {   // step u: chunk u % nchunks of tile u / nchunks
    const int s = u % STAGES;
    float* dst = ring + s * STAGE;
    const int c = u % nchunks, n0 = nb + (u / nchunks) * TN;
    mbar_expect_tx(&full[s], STAGE * 4);
    tma_2d(dst, &bmap, c * TK, n0, &full[s]);
    tma_2d(dst + TN * TK, &qmap, c * TK, q0, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < STAGES && u < steps; ++u) issue(u);
  }
  for (int r = warp; r < TQ; r += 8) {
    if (lane == 0) { cnt[r] = 0; thr_s[r] = NEG; thr_i[r] = IMAX; }
    if (q0 + r >= nq) continue;
    float* ls = list_s(r);
    int* li = list_i(r);
    for (int x = lane; x < kp; x += 32) { ls[x] = NEG; li[x] = IMAX; }
  }
  __syncthreads();

  float acc[TMq][TMn];
  for (int u = 0; u < steps; ++u) {
    const int s = u % STAGES, c = u % nchunks;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TMq; ++i)
#pragma unroll
        for (int j = 0; j < TMn; ++j) acc[i][j] = 0.f;
    }
    mbar_wait(&full[s], (u / STAGES) & 1);
    const float* bsm = ring + s * STAGE;
    const float* qsm = bsm + TN * TK;
    // the swizzle's XOR is the same for every bank row of the thread
    // (row & 7 = lane & 7) and takes two values over its query rows
    const float* pa = qsm + qr * TK;
    const float* pb = bsm + nr * TK;
#pragma unroll
    for (int c4 = 0; c4 < TK / 4; ++c4) {
      const int xa0 = (c4 ^ (qr & 7)) << 2, xa1 = (c4 ^ ((qr + 4) & 7)) << 2;
      const int xb = (c4 ^ (nr & 7)) << 2;
      float4 a[TMq], b[TMn];
#pragma unroll
      for (int i = 0; i < TMq; ++i)
        a[i] = *reinterpret_cast<const float4*>(pa + 4 * i * TK +
                                                (i & 1 ? xa1 : xa0));
#pragma unroll
      for (int j = 0; j < TMn; ++j)
        b[j] = *reinterpret_cast<const float4*>(pb + 8 * j * TK + xb);
      fma_chunk(acc, a, b);
    }
    __syncthreads();                       // stage s read by every warp
    if (tid == 0 && u + STAGES < steps) issue(u + STAGES);
    if (c != nchunks - 1) continue;

    // the tile's scores: append those that beat their row's threshold
    const int n0 = nb + (u / nchunks) * TN;
#pragma unroll
    for (int i = 0; i < TMq; ++i) {
      const int r = qr + 4 * i;
      if (q0 + r >= nq) break;
      const float ts = thr_s[r];
      const int ti = thr_i[r];
#pragma unroll
      for (int j = 0; j < TMn; ++j) {
        const int col = n0 + nr + 8 * j;
        const float sc = acc[i][j];
        if (col < n_end && sc > NEG && beats(sc, col, ts, ti)) {
          const int at = atomicAdd(&cnt[r], 1);
          buf_s[r * BUF + at] = sc;
          buf_i[r * BUF + at] = col;
        }
      }
    }
    __syncthreads();
    // merge the buffers that could overflow on the next tile (all of them
    // after the last tile); warp w owns rows w, w + 8, ...
    const bool last = u + 1 == steps;
    for (int r = warp; r < TQ && q0 + r < nq; r += 8) {
      const int held = cnt[r];
      if (held > (last ? 0 : FLUSH_AT)) {
        flush(list_s(r), list_i(r), buf_s + r * BUF, buf_i + r * BUF, held,
              kp, k, lane, &thr_s[r], &thr_i[r]);
        __syncwarp();
        if (lane == 0) cnt[r] = 0;
      }
    }
    __syncthreads();
  }

  if (!WIDE) {
    for (int r = warp; r < TQ && q0 + r < nq; r += 8) {
      const float* ls = list_s(r);
      const int* li = list_i(r);
      const size_t out = slot(r);
      for (int j = lane; j < k; j += 32) {
        part_s[out + j] = ls[j];
        part_i[out + j] = li[j];
      }
    }
  }
}

// One warp per query row: the k best of its sorted split lists (each kp
// apart in the scratch).
__global__ void __launch_bounds__(128)
topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
           float* __restrict__ out_s, int* __restrict__ out_i, int nq,
           int splits, int k, int kp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= nq) return;
  const float* ps = part_s + (size_t)row * splits * kp;
  const int* pi = part_i + (size_t)row * splits * kp;
  int pos[LISTS_PER_LANE];
  float hs[LISTS_PER_LANE];
  int hi[LISTS_PER_LANE];
#pragma unroll
  for (int j = 0; j < LISTS_PER_LANE; ++j) {
    const int l = lane + 32 * j;
    pos[j] = 0;
    hs[j] = -INFINITY;
    hi[j] = IMAX;
    if (l < splits) { hs[j] = ps[(size_t)l * kp]; hi[j] = pi[(size_t)l * kp]; }
  }
  for (int t = 0; t < k; ++t) {
    float bs = hs[0];
    int bi = hi[0], bj = 0;
#pragma unroll
    for (int j = 1; j < LISTS_PER_LANE; ++j)
      if (beats(hs[j], hi[j], bs, bi)) { bs = hs[j]; bi = hi[j]; bj = j; }
    int bl = lane;
    float ws = bs;
    int wi = bi;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, ws, off);
      const int oi = __shfl_xor_sync(FULL, wi, off);
      const int ol = __shfl_xor_sync(FULL, bl, off);
      if (beats(os, oi, ws, wi) || (os == ws && oi == wi && ol < bl)) {
        ws = os; wi = oi; bl = ol;
      }
    }
    if (lane == 0) {
      out_s[(size_t)row * k + t] = ws;
      out_i[(size_t)row * k + t] = wi;
    }
    if (lane == bl) {
#pragma unroll
      for (int j = 0; j < LISTS_PER_LANE; ++j) {
        if (j != bj) continue;
        const int l = lane + 32 * j;
        ++pos[j];
        hs[j] = -INFINITY;
        hi[j] = IMAX;
        if (pos[j] < k) {
          hs[j] = ps[(size_t)l * kp + pos[j]];
          hi[j] = pi[(size_t)l * kp + pos[j]];
        }
      }
    }
  }
}

// The list length (k rounded up to a power of two, at least 32) and the
// query rows per block for k.
void list_plan(int k, int* kp, int* tq) {
  *kp = 32;
  while (*kp < k) *kp <<= 1;
  *tq = *kp <= 128 ? 32 : *kp <= 256 ? 16 : 8;
}

// (splits, rows per split) of the bank: one wave of (query tile, split)
// blocks, one per SM, each split a whole number of TN-row tiles.
void split_plan(int nq, int n, int tq, int sm_count, int* splits,
                int* split_rows) {
  const int q_tiles = (nq + tq - 1) / tq;
  const int tiles = (n + TN - 1) / TN;
  const int s = std::max(1, std::min(std::min(MAX_SPLITS, tiles),
                                     sm_count / q_tiles));
  *split_rows = (tiles + s - 1) / s * TN;
  *splits = (n + *split_rows - 1) / *split_rows;
}

// rows x d f32 (d % 4 == 0, 16-byte aligned) as a tensor map: boxes of
// `box` rows x 32 lanes, 128-byte swizzle, zeros past d and rows.
bool map_f32(CUtensorMap* map, const void* base, int d, int rows, int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t boxes[2] = {(cuuint32_t)TK, (cuuint32_t)box};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims,
                  strides, boxes);
}

template <int TQ, bool WIDE>
cudaError_t launch_partial(const CUtensorMap& qm, const CUtensorMap& bm,
                           float* part_s, int* part_i, int nq, int n, int d,
                           int k, int kp, int splits, int split_rows,
                           cudaStream_t st) {
  const size_t smem = 1024 + (size_t)STAGES * (TN + TQ) * TK * 4 +
                      (size_t)TQ * BUF * 8 + (WIDE ? 0 : (size_t)TQ * kp * 8) +
                      (size_t)TQ * 12;
  auto kern = topk_partial<TQ, WIDE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((nq + TQ - 1) / TQ, splits), THREADS, smem, st>>>(
      qm, bm, part_s, part_i, nq, n, d, k, kp, splits, split_rows);
  return cudaGetLastError();
}

}  // namespace

// Scratch entries per query topk_ip_fused needs for these sizes: its
// part_s / part_i hold (nq, splits, kp) entries, returned as splits * kp.
extern "C" int topk_ip_fused_slots(int nq, int n, int k, int sm_count) {
  if (nq <= 0 || n <= 0 || k <= 0 || sm_count <= 0) return 0;
  int kp, tq, splits, split_rows;
  list_plan(k, &kp, &tq);
  split_plan(nq, n, tq, sm_count, &splits, &split_rows);
  return splits * kp;
}

// Both passes on `stream`. q (nq, d) and bank (n, d): f32, contiguous,
// d % 4 == 0, 16-byte aligned; part_s/part_i: topk_ip_fused_slots(...)
// entries per query; out_s / out_i: (nq, k). Returns the first CUDA error,
// 0 on success.
extern "C" int topk_ip_fused(const void* q, const void* bank, void* part_s,
                             void* part_i, void* out_s, void* out_i, int nq,
                             int n, int d, int k, int sm_count, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || k <= 0 || sm_count <= 0 || d % 4 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bank) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int kp, tq, splits, split_rows;
  list_plan(k, &kp, &tq);
  split_plan(nq, n, tq, sm_count, &splits, &split_rows);
  CUtensorMap qm, bm;
  if (!(map_f32(&qm, q, d, nq, tq) && map_f32(&bm, bank, d, n, TN)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  cudaError_t e;
  if (kp > KP_SHARED)
    e = launch_partial<8, true>(qm, bm, ps, pi, nq, n, d, k, kp, splits,
                                split_rows, st);
  else if (tq == 32)
    e = launch_partial<32, false>(qm, bm, ps, pi, nq, n, d, k, kp, splits,
                                  split_rows, st);
  else if (tq == 16)
    e = launch_partial<16, false>(qm, bm, ps, pi, nq, n, d, k, kp, splits,
                                  split_rows, st);
  else
    e = launch_partial<8, false>(qm, bm, ps, pi, nq, n, d, k, kp, splits,
                                 split_rows, st);
  if (e != cudaSuccess) return (int)e;
  topk_merge<<<(nq + 3) / 4, 128, 0, st>>>(ps, pi, static_cast<float*>(out_s),
                                           static_cast<int*>(out_i), nq,
                                           splits, k, kp);
  return (int)cudaGetLastError();
}

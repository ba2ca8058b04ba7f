// Fused inner-product GEMM + exact top-k for Hopper (sm_90a): B8.
//
// Replaces _topk_kernel (domainrag_tpu/ops/topk.py:183), reached through
// topk_ip_pallas (:259): the stage-2 first-stage search of L2-normalised
// CLIP queries (Q, d) against the corpus bank (N, d), both f32.
//
// Math: score[q][n] = sum_k query[q][k] * bank[n][k], a true f32 sum of
// products (FFMA on the CUDA cores, k ascending; no TF32, which would break
// the identical-indices-to-FAISS contract). Each query row keeps the k best
// (score, index) pairs in the total order (score desc, index asc). A score
// enters only when it is above -FLT_MAX (the Pallas kernel's masked value),
// and a row with fewer than k entries is padded with (-FLT_MAX, 2^31 - 1),
// as topk_ip_pallas returns for k > N. Any k >= 1 (topk_ip_pallas pads k to
// a multiple of 128 and has no upper limit either).
//
// Bound on the card: 2*Q*N*d operations at the f32 FMA peak (67 TFLOP/s),
// or the bytes (queries and bank read once, 8*Q*k written) at 3.35 TB/s.
// At the stage-2 shape, 200 queries x 178,287 bank rows x 512, k = 100:
// 36.5 GFLOP = 0.545 ms against 365 MB = 0.109 ms, so operation-bound.
//
// Design (a simple kernel that is right first; the Pallas kernel's grid
// carries the running top-k across bank tiles in VMEM, which a Hopper grid
// cannot do across blocks, hence two passes):
//  * Pass 1, topk_partial: the grid is (query tiles of 32 rows) x (bank
//    splits), query tiles fastest so the blocks of one split run together
//    and read its bank rows through L2 once. A block of 4 warps streams
//    its split in 128-row bank tiles; each tile's 32 x 128 scores come from
//    a register-tiled f32 GEMM (4 x 8 accumulators per thread) over d in
//    chunks of 16, staged transposed in shared memory with the next chunk's
//    global loads in flight while the current one is multiplied. The score
//    tile then goes to shared memory (over the staging buffers) and each
//    warp updates its 8 rows' running lists (shared memory, sorted): a
//    candidate is inserted only if it beats the row's k-th entry (the
//    Pallas kernel's threshold gate, :219-228), so after the first tiles
//    almost every candidate is rejected by one compare. Insertions are one
//    at a time by the warp (ballot for the position, shift, re-prune).
//    Each (row, split) list is written to scratch. For k > K_MAX the lists
//    (32 x k x 8 bytes per block) no longer fit beside the staging buffers,
//    so the WIDE instance keeps each row's running list in its own (row,
//    split) slot of that scratch, in global memory (L1-cached; only the
//    owning warp touches it, and __syncwarp orders its lanes' accesses),
//    with the same insertions: the same result, slower per insertion.
//  * Pass 2, topk_merge: one warp per query row merges the sorted split
//    lists by a tournament (warp argmax of the list heads, k times).
//  * Ragged Q, N and d edges are masked in the kernel (zero-filled loads,
//    columns past the split not entered); nothing is padded or copied.
//    d % 4 == 0 with 16-byte aligned rows takes float4 loads, any other
//    shape scalar loads (a slower, equally exact instance).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TQ = 32;       // query rows per block
constexpr int TN = 128;      // bank rows per tile
constexpr int TK = 16;       // d per staged chunk
constexpr int THREADS = 128;
constexpr int LDA = TQ + 4;  // transposed query chunk [k][q]
constexpr int LDB = TN + 4;  // transposed bank chunk [k][n]
constexpr int LDS = TN + 4;  // score tile [q][n]
constexpr int BUF = TK * LDA + TK * LDB;   // floats per staging buffer
constexpr int K_MAX = 256;   // larger k: the lists live in the scratch
constexpr int MAX_SPLITS = 256;
constexpr int BLOCKS_PER_SM = 3;   // (query tile, split) blocks in flight
constexpr int LISTS_PER_LANE = MAX_SPLITS / 32;
constexpr float NEG = -FLT_MAX;
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

static_assert(TQ * LDS <= 2 * BUF, "the score tile lives over the buffers");

__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// row[k .. k+3], zero past d or for a masked row.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int k, int d,
                                        bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok) return v;
  if (VEC) {
    if (k < d) v = __ldg(reinterpret_cast<const float4*>(row + k));
  } else {
    if (k < d) v.x = __ldg(row + k);
    if (k + 1 < d) v.y = __ldg(row + k + 1);
    if (k + 2 < d) v.z = __ldg(row + k + 2);
    if (k + 3 < d) v.w = __ldg(row + k + 3);
  }
  return v;
}

struct Stage {
  float4 a;       // one float4 of the query chunk
  float4 b[4];    // four float4 of the bank chunk
};

// Global loads of the chunk (bank rows n0.., dims k0..k0+TK) into regs.
template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& st, const float* q,
                                           const float* bank, int q0, int nq,
                                           int n0, int n_end, int k0, int d,
                                           int tid) {
  const int m = tid >> 2, kq = (tid & 3) * 4;
  st.a = load4<VEC>(q + (size_t)(q0 + m) * d, k0 + kq, d, q0 + m < nq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = m + 32 * i;
    st.b[i] = load4<VEC>(bank + (size_t)(n0 + n) * d, k0 + kq, d,
                         n0 + n < n_end);
  }
}

// Registers -> a staging buffer, transposed to [k][row].
__device__ __forceinline__ void store_stage(const Stage& st, float* buf,
                                            int tid) {
  const int m = tid >> 2, kq = (tid & 3) * 4;
  float* as = buf;
  float* bs = buf + TK * LDA;
  as[(kq + 0) * LDA + m] = st.a.x;
  as[(kq + 1) * LDA + m] = st.a.y;
  as[(kq + 2) * LDA + m] = st.a.z;
  as[(kq + 3) * LDA + m] = st.a.w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = m + 32 * i;
    bs[(kq + 0) * LDB + n] = st.b[i].x;
    bs[(kq + 1) * LDB + n] = st.b[i].y;
    bs[(kq + 2) * LDB + n] = st.b[i].z;
    bs[(kq + 3) * LDB + n] = st.b[i].w;
  }
}

template <bool VEC, bool WIDE>
__global__ void __launch_bounds__(THREADS, 4)
topk_partial(const float* __restrict__ q, const float* __restrict__ bank,
             float* __restrict__ part_s, int* __restrict__ part_i, int nq,
             int n, int d, int k, int splits, int split_rows) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* ssm = sm;                              // score tile (over buffers)
  const int lk = WIDE ? 0 : TQ * k;             // the lists in shared memory
  float* lists_s = sm + 2 * BUF;
  int* lists_i = reinterpret_cast<int*>(lists_s + lk);
  int* counts = lists_i + lk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;       // 16 x 8 thread grid
  const int q0 = blockIdx.x * TQ, split = blockIdx.y;
  const int nb = split * split_rows;
  const int n_end = min(n, nb + split_rows);
  const int ntiles = (n_end - nb + TN - 1) / TN;
  const int nchunks = (d + TK - 1) / TK;
  // row r's running list and its slot of the scratch
  auto slot = [&](int r) { return ((size_t)(q0 + r) * splits + split) * k; };
  auto list_s = [&](int r) {
    return WIDE ? part_s + slot(r) : lists_s + r * k;
  };
  auto list_i = [&](int r) {
    return WIDE ? part_i + slot(r) : lists_i + r * k;
  };

  if (tid < TQ) counts[tid] = 0;
  Stage st;
  load_stage<VEC>(st, q, bank, q0, nq, nb, n_end, 0, d, tid);
  store_stage(st, sm, tid);
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int n0 = nb + t * TN;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c = 0; c < nchunks; ++c) {
      const bool next_in_tile = c + 1 < nchunks;
      if (next_in_tile)
        load_stage<VEC>(st, q, bank, q0, nq, n0, n_end, (c + 1) * TK, d,
                        tid);
      else if (t + 1 < ntiles)
        load_stage<VEC>(st, q, bank, q0, nq, n0 + TN, n_end, 0, d, tid);
      const float* as = sm + (c & 1) * BUF;
      const float* bs = as + TK * LDA;
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(as + kk * LDA +
                                                          ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LDB +
                                                           tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * LDB +
                                                           64 + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (next_in_tile) store_stage(st, sm + ((c + 1) & 1) * BUF, tid);
      __syncthreads();
    }

    // scores -> shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = ssm + (ty * 4 + i) * LDS;
      *reinterpret_cast<float4*>(row + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

    // running top-k: warp w owns rows w, w + 4, ...
    for (int r = warp; r < TQ; r += 4) {
      if (q0 + r >= nq) break;
      float* ls = list_s(r);
      int* li = list_i(r);
      int cnt = counts[r];
      float ts = NEG;
      int ti = IMAX;
      if (cnt == k) { ts = ls[k - 1]; ti = li[k - 1]; }
      float cs[4];
      int ci[4];
      unsigned pend = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = lane + 32 * j;
        cs[j] = ssm[r * LDS + col];
        ci[j] = n0 + col;
        if (n0 + col < n_end && cs[j] > NEG && beats(cs[j], ci[j], ts, ti))
          pend |= 1u << j;
      }
      while (true) {
        const unsigned who = __ballot_sync(FULL, pend != 0);
        if (!who) break;
        const int leader = __ffs(who) - 1;
        const int bit = __ffs(pend) - 1;
        float s = cs[0];
        int id = ci[0];
        if (bit == 1) { s = cs[1]; id = ci[1]; }
        if (bit == 2) { s = cs[2]; id = ci[2]; }
        if (bit == 3) { s = cs[3]; id = ci[3]; }
        s = __shfl_sync(FULL, s, leader);
        id = __shfl_sync(FULL, id, leader);
        if (lane == leader) pend &= pend - 1;
        // position = number of entries ordering before the candidate
        int p = 0;
        for (int base = 0; base < cnt; base += 32) {
          const int j = base + lane;
          const bool b = j < cnt && beats(ls[j], li[j], s, id);
          p += __popc(__ballot_sync(FULL, b));
        }
        // shift [p, last) one place right, highest chunk first
        const int last = cnt < k ? cnt : k - 1;
        for (int c = (last - p - 1) >> 5; c >= 0; --c) {
          const int j = p + 32 * c + lane;
          const bool ok = j < last;
          float v = 0.f;
          int vi = 0;
          if (ok) { v = ls[j]; vi = li[j]; }
          __syncwarp();
          if (ok) { ls[j + 1] = v; li[j + 1] = vi; }
          __syncwarp();
        }
        if (lane == 0) { ls[p] = s; li[p] = id; }
        cnt = cnt < k ? cnt + 1 : k;
        __syncwarp();
        if (cnt == k) { ts = ls[k - 1]; ti = li[k - 1]; }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (((pend >> j) & 1u) && !beats(cs[j], ci[j], ts, ti))
            pend &= ~(1u << j);
      }
      if (lane == 0) counts[r] = cnt;
    }
    __syncthreads();
    if (t + 1 < ntiles) {
      store_stage(st, sm, tid);
      __syncthreads();
    }
  }

  for (int r = warp; r < TQ; r += 4) {
    if (q0 + r >= nq) break;
    const int cnt = counts[r];
    const float* ls = list_s(r);
    const int* li = list_i(r);
    const size_t out = slot(r);
    for (int j = lane; j < k; j += 32) {   // in place when WIDE
      part_s[out + j] = j < cnt ? ls[j] : NEG;
      part_i[out + j] = j < cnt ? li[j] : IMAX;
    }
  }
}

// One warp per query row: the k best of its sorted split lists.
__global__ void __launch_bounds__(128)
topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
           float* __restrict__ out_s, int* __restrict__ out_i, int nq,
           int splits, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= nq) return;
  const float* ps = part_s + (size_t)row * splits * k;
  const int* pi = part_i + (size_t)row * splits * k;
  int pos[LISTS_PER_LANE];
  float hs[LISTS_PER_LANE];
  int hi[LISTS_PER_LANE];
#pragma unroll
  for (int j = 0; j < LISTS_PER_LANE; ++j) {
    const int l = lane + 32 * j;
    pos[j] = 0;
    hs[j] = -INFINITY;
    hi[j] = IMAX;
    if (l < splits) { hs[j] = ps[(size_t)l * k]; hi[j] = pi[(size_t)l * k]; }
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
          hs[j] = ps[(size_t)l * k + pos[j]];
          hi[j] = pi[(size_t)l * k + pos[j]];
        }
      }
    }
  }
}

// (splits, rows per split) of the bank: enough (query tile, split) blocks
// for ~3 per SM, each split a whole number of TN-row tiles.
void split_plan(int nq, int n, int sm_count, int* splits, int* split_rows) {
  const int q_tiles = (nq + TQ - 1) / TQ;
  const int tiles = (n + TN - 1) / TN;
  const int want = (BLOCKS_PER_SM * sm_count + q_tiles - 1) / q_tiles;
  const int s = std::max(1, std::min(std::min(MAX_SPLITS, tiles), want));
  *split_rows = (tiles + s - 1) / s * TN;
  *splits = (n + *split_rows - 1) / *split_rows;
}

}  // namespace

// The number of bank splits topk_ip_fused uses for these sizes: its
// scratch holds (nq, splits, k) entries.
extern "C" int topk_ip_fused_splits(int nq, int n, int sm_count) {
  if (nq <= 0 || n <= 0 || sm_count <= 0) return 0;
  int splits, split_rows;
  split_plan(nq, n, sm_count, &splits, &split_rows);
  return splits;
}

// Both passes on `stream`. part_s/part_i: (Q, splits, k) scratch, splits
// from topk_ip_fused_splits(nq, n, sm_count); out_s / out_i: (Q, k).
// d % 4 == 0 with 16-byte aligned q and bank takes the float4 loads;
// k > K_MAX the WIDE instance (running lists in part_s / part_i).
// Returns the first CUDA error, 0 on success.
extern "C" int topk_ip_fused(const void* q, const void* bank, void* part_s,
                             void* part_i, void* out_s, void* out_i, int nq,
                             int n, int d, int k, int sm_count, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || k <= 0 || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  int splits, split_rows;
  split_plan(nq, n, sm_count, &splits, &split_rows);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bank) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = k > K_MAX;
  const size_t lists = wide ? 0 : (size_t)TQ * k;
  const size_t smem = (size_t)2 * BUF * sizeof(float) +
                      lists * (sizeof(float) + sizeof(int)) +
                      TQ * sizeof(int);
  auto kern = vec ? (wide ? topk_partial<true, true>
                          : topk_partial<true, false>)
                  : (wide ? topk_partial<false, true>
                          : topk_partial<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((nq + TQ - 1) / TQ, splits);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(bank),
      static_cast<float*>(part_s), static_cast<int*>(part_i), nq, n, d, k,
      splits, split_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  topk_merge<<<(nq + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), nq, splits, k);
  return (int)cudaGetLastError();
}

// Exact inner-product top-k search over an embedding bank (host side).
//
// First-party replacement for the reference's FAISS IndexFlatIP usage
// (retrieval/clip100_resnet_style_all_shots.py:425-434): the reference
// rebuilt the index for every query; this scans a resident bank once per
// query batch, multithreaded, with a bounded min-heap per query.
//
// Ordering contract matches ops/topk.py: score descending,
// ties broken toward the lower bank index.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Entry {
  float score;
  int32_t index;
};

// true if a orders strictly before b (score desc, index asc)
inline bool beats(const Entry& a, const Entry& b) {
  return a.score > b.score || (a.score == b.score && a.index < b.index);
}

// min-heap on "beats": the root is the *worst* kept entry
inline bool heap_cmp(const Entry& a, const Entry& b) { return beats(a, b); }

void search_rows(const float* queries, const float* bank, float* out_scores,
                 int32_t* out_idx, int64_t n_queries, int64_t n_bank,
                 int64_t dim, int64_t k, int64_t row_begin, int64_t row_end) {
  std::vector<Entry> heap;
  heap.reserve(static_cast<size_t>(k));
  for (int64_t qi = row_begin; qi < row_end; ++qi) {
    const float* q = queries + qi * dim;
    heap.clear();
    for (int64_t bi = 0; bi < n_bank; ++bi) {
      const float* v = bank + bi * dim;
      float s = 0.f;
      for (int64_t d = 0; d < dim; ++d) s += q[d] * v[d];
      Entry e{s, static_cast<int32_t>(bi)};
      if (static_cast<int64_t>(heap.size()) < k) {
        heap.push_back(e);
        std::push_heap(heap.begin(), heap.end(), heap_cmp);
      } else if (beats(e, heap.front())) {
        std::pop_heap(heap.begin(), heap.end(), heap_cmp);
        heap.back() = e;
        std::push_heap(heap.begin(), heap.end(), heap_cmp);
      }
    }
    // sort_heap orders by the comparator ("beats" = orders-before), so the
    // result is already winner-first.
    std::sort_heap(heap.begin(), heap.end(), heap_cmp);
    const int64_t kk = static_cast<int64_t>(heap.size());
    for (int64_t i = 0; i < kk; ++i) {
      out_scores[qi * k + i] = heap[i].score;
      out_idx[qi * k + i] = heap[i].index;
    }
    for (int64_t i = kk; i < k; ++i) {
      out_scores[qi * k + i] = -3.402823466e38f;
      out_idx[qi * k + i] = -1;
    }
  }
}

}  // namespace

extern "C" {

// queries: (n_queries, dim) f32 row-major; bank: (n_bank, dim) f32.
// out_scores/out_idx: (n_queries, k).
void drtpu_topk_ip(const float* queries, const float* bank, float* out_scores,
                   int32_t* out_idx, int64_t n_queries, int64_t n_bank,
                   int64_t dim, int64_t k, int32_t n_threads) {
  if (n_threads <= 1 || n_queries <= 1) {
    search_rows(queries, bank, out_scores, out_idx, n_queries, n_bank, dim, k,
                0, n_queries);
    return;
  }
  int64_t nt = std::min<int64_t>(n_threads, n_queries);
  std::vector<std::thread> threads;
  int64_t per = (n_queries + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t begin = t * per;
    int64_t end = std::min(begin + per, n_queries);
    if (begin >= end) break;
    threads.emplace_back(search_rows, queries, bank, out_scores, out_idx,
                         n_queries, n_bank, dim, k, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

// Nearest-neighbor-chain agglomerative clustering, C++ core.
//
// A copy of spectralcluster_tpu/native/ahc.cc, so that the port builds its
// own library (native/ahc_native.py) and never loads the JAX package's.
//
// Replaces the merge loop of sklearn.cluster.AgglomerativeClustering (the
// reference's native dependency for pre-clustering and fallback clustering,
// spectral_clusterer.py:184-188, fallback_clusterer.py:110-115). The O(N^2)
// distance matrix is computed on the accelerator; this host loop is the
// inherently-sequential part (SURVEY.md §7 hard part 2).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

enum Linkage { kComplete = 0, kAverage = 1, kSingle = 2 };

}  // namespace

extern "C" {

// Compute the dendrogram with the nearest-neighbor-chain algorithm.
//   dist:    n*n symmetric distance matrix (row-major), diagonal ignored.
//   linkage: 0=complete, 1=average, 2=single (all reducible -> nn-chain
//            yields the same dendrogram as greedy agglomeration).
//   merges_out: (n-1)*3 doubles [id_a, id_b, height] in chain order;
//               scipy-style ids (originals 0..n-1, merge i creates n+i).
// Returns 0 on success.
int sct_nn_chain_linkage(const double* dist, int64_t n, int linkage,
                         double* merges_out) {
  if (n < 2) return 1;
  std::vector<double> d(dist, dist + n * n);
  for (int64_t i = 0; i < n; ++i) d[i * n + i] = kInf;
  std::vector<int64_t> size(n, 1);
  std::vector<int64_t> slot_id(n);
  std::iota(slot_id.begin(), slot_id.end(), 0);
  std::vector<char> active(n, 1);
  std::vector<int64_t> chain;
  chain.reserve(n);
  int64_t next_id = n;
  int64_t first_active = 0;

  for (int64_t m = 0; m < n - 1; ++m) {
    if (chain.empty()) {
      while (!active[first_active]) ++first_active;
      chain.push_back(first_active);
    }
    int64_t x, y;
    double height;
    for (;;) {
      x = chain.back();
      const double* row = &d[x * n];
      double best = kInf;
      int64_t besty = -1;
      for (int64_t j = 0; j < n; ++j) {
        if (j == x || !active[j]) continue;
        if (row[j] < best) {
          best = row[j];
          besty = j;
        }
      }
      y = besty;
      // Prefer the previous chain element on ties (termination guarantee).
      if (chain.size() > 1) {
        int64_t prev = chain[chain.size() - 2];
        if (row[prev] == best) y = prev;
      }
      if (chain.size() > 1 && y == chain[chain.size() - 2]) {
        height = best;
        chain.pop_back();
        chain.pop_back();
        break;
      }
      chain.push_back(y);
    }
    merges_out[m * 3 + 0] = static_cast<double>(slot_id[x]);
    merges_out[m * 3 + 1] = static_cast<double>(slot_id[y]);
    merges_out[m * 3 + 2] = height;
    const int64_t sx = size[x], sy = size[y];
    double* rx = &d[x * n];
    const double* ry = &d[y * n];
    switch (linkage) {
      case kComplete:
        for (int64_t j = 0; j < n; ++j) rx[j] = std::max(rx[j], ry[j]);
        break;
      case kAverage: {
        const double wx = static_cast<double>(sx) / (sx + sy);
        const double wy = static_cast<double>(sy) / (sx + sy);
        for (int64_t j = 0; j < n; ++j) rx[j] = wx * rx[j] + wy * ry[j];
        break;
      }
      default:
        for (int64_t j = 0; j < n; ++j) rx[j] = std::min(rx[j], ry[j]);
    }
    for (int64_t j = 0; j < n; ++j) d[j * n + x] = rx[j];
    rx[x] = kInf;
    active[y] = 0;
    size[x] = sx + sy;
    slot_id[x] = next_id++;
  }
  return 0;
}

// Cut the dendrogram into flat labels.
//   Either n_clusters > 0 (fixed-count cut) or use_threshold != 0 with
//   `threshold` (merge all pairs with height < threshold).
//   labels_out: n int64 labels, first-appearance relabeled to 0..k-1.
int sct_ahc_labels(const double* dist, int64_t n, int linkage,
                   int64_t n_clusters, double threshold, int use_threshold,
                   int64_t* labels_out) {
  if (n == 1) {
    labels_out[0] = 0;
    return 0;
  }
  if (n_clusters > 0 && n_clusters >= n) {
    for (int64_t i = 0; i < n; ++i) labels_out[i] = i;
    return 0;
  }
  std::vector<double> merges((n - 1) * 3);
  int rc = sct_nn_chain_linkage(dist, n, linkage, merges.data());
  if (rc != 0) return rc;

  // Stable sort merge indices by height (the dendrogram order).
  std::vector<int64_t> order(n - 1);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return merges[a * 3 + 2] < merges[b * 3 + 2];
  });

  std::vector<char> apply(n - 1, 0);
  if (use_threshold) {
    for (int64_t k = 0; k < n - 1; ++k) {
      if (merges[order[k] * 3 + 2] < threshold) apply[order[k]] = 1;
    }
  } else {
    for (int64_t k = 0; k < n - n_clusters; ++k) apply[order[k]] = 1;
  }

  // Union-find over applied merges, in chain order (children precede parents).
  std::vector<int64_t> parent(2 * n - 1);
  std::iota(parent.begin(), parent.end(), 0);
  auto find = [&](int64_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  };
  int64_t next_id = n;
  for (int64_t i = 0; i < n - 1; ++i) {
    if (apply[i]) {
      parent[find(static_cast<int64_t>(merges[i * 3 + 0]))] = next_id;
      parent[find(static_cast<int64_t>(merges[i * 3 + 1]))] = next_id;
    }
    ++next_id;
  }
  // First-appearance relabel.
  std::vector<int64_t> remap(2 * n - 1, -1);
  int64_t next_label = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = find(i);
    if (remap[r] < 0) remap[r] = next_label++;
    labels_out[i] = remap[r];
  }
  return 0;
}

}  // extern "C"

// Host binning data plane of mmlspark_tpu_torch: the edge finding and bin
// application of BinMapper, threaded over features (edges) and rows (bins).
//
// A copy of the three binning functions of the JAX package's native data
// plane (native/mmlspark_native.cpp, bin_edges_feature, mm_bin_edges and
// mm_bin_apply), kept verbatim so that the port's edges and host bins are
// the reference's bit for bit: lightgbm/binning.py takes this route by the
// reference's own predicate.  kernels/_build.py compiles it with g++ and the
// reference Makefile's flags at first use; utils/native_loader.py binds it
// with ctypes.  Note what mm_bin_apply does with a non-finite edge: it
// counts only the LEADING finite edges of a feature, so a fitted edge row
// that starts with -inf (a column holding -inf) bins every row to 0.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Quantile binning (BinMapper hot path).  The reference bins inside LightGBM
// C++ before any training touches the data; here edge FINDING and bin
// APPLICATION run multithreaded over features so the 1M x 200 ingest fixed
// cost stops being a Python/numpy bottleneck.  Semantics match the numpy
// path in lightgbm/binning.py: per-feature sorted-unique midpoints when
// distinct values <= B, else linear-interpolated quantiles (np.quantile
// default), deduped as float32, +inf padding; NaN ignored at fit, bin 0 at
// transform (missing-goes-left).  Interpolation here runs in double and is
// stored float32 — an edge may differ from numpy's by 1 ulp, which can flip
// the bin of a value EXACTLY on that edge (the parity test covers real data
// at atol=1e-5; exact-tie behavior across the two paths is not guaranteed).
// ---------------------------------------------------------------------------

static void bin_edges_feature(const float* X, int64_t n, int64_t F, int64_t f,
                              int B, float* edges_row) {
  const float inf = std::numeric_limits<float>::infinity();
  for (int i = 0; i < B - 1; ++i) edges_row[i] = inf;
  std::vector<float> col;
  col.reserve(n);
  for (int64_t r = 0; r < n; ++r) {
    float v = X[r * F + f];
    if (!std::isnan(v)) col.push_back(v);
  }
  if (col.empty()) return;
  std::sort(col.begin(), col.end());
  // count distinct
  int64_t distinct = 1;
  for (size_t i = 1; i < col.size(); ++i)
    if (col[i] != col[i - 1]) ++distinct;
  if (distinct <= 1) return;
  if (distinct <= B) {
    int k = 0;
    for (size_t i = 1; i < col.size(); ++i)
      if (col[i] != col[i - 1] && k < B - 1)
        edges_row[k++] = (col[i] + col[i - 1]) / 2.0f;
    return;
  }
  // np.quantile linear interpolation at the B-1 interior quantiles of
  // linspace(0, 1, B+1), computed in double then stored float32
  std::vector<float> q(B - 1);
  for (int i = 0; i < B - 1; ++i) {
    double p = static_cast<double>(i + 1) / B;
    double pos = p * (col.size() - 1);
    size_t lo = static_cast<size_t>(pos);
    double frac = pos - lo;
    double v = col[lo] * (1.0 - frac) +
               col[std::min(lo + 1, col.size() - 1)] * frac;
    q[i] = static_cast<float>(v);
  }
  std::sort(q.begin(), q.end());
  int k = 0;
  for (int i = 0; i < B - 1; ++i)
    if (i == 0 || q[i] != q[i - 1]) edges_row[k++] = q[i];
}

void mm_bin_edges(const float* X, int64_t n, int64_t F, int B,
                  float* edges /* (F, B-1) */, int n_threads) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = static_cast<int>(std::min<int64_t>(n_threads, F));
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([=]() {
      for (int64_t f = t; f < F; f += n_threads)
        bin_edges_feature(X, n, F, f, B, edges + f * (B - 1));
    });
  }
  for (auto& th : pool) th.join();
}

void mm_bin_apply(const float* X, int64_t n, int64_t F,
                  const float* edges /* (F, B-1) */, int B,
                  uint8_t* out /* (n, F) */, int n_threads) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  // per-feature finite-edge counts once
  std::vector<int> n_edges(F);
  for (int64_t f = 0; f < F; ++f) {
    const float* e = edges + f * (B - 1);
    int m = 0;
    while (m < B - 1 && std::isfinite(e[m])) ++m;
    n_edges[f] = m;
  }
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=, &n_edges]() {
      for (int64_t r = lo; r < hi; ++r) {
        for (int64_t f = 0; f < F; ++f) {
          float v = X[r * F + f];
          const float* e = edges + f * (B - 1);
          if (std::isnan(v)) { out[r * F + f] = 0; continue; }
          // branchless-ish binary search: first edge >= v
          int loi = 0, hii = n_edges[f];
          while (loi < hii) {
            int mid = (loi + hii) >> 1;
            if (e[mid] < v) loi = mid + 1; else hii = mid;
          }
          out[r * F + f] = static_cast<uint8_t>(loi);
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"

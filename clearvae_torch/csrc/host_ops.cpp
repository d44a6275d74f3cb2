// Host op of clearvae_torch: the KSG mutual information of continuous
// feature columns against discrete labels (Ross 2014), the building block of
// MIG, in C++17 with a plain C interface for ctypes. Built with
// g++ -O3 -std=c++17 -shared -fPIC by clearvae_torch/native/bindings.py.
//
// The port's own copy of ksg_mi_cd from clearvae_tpu/native/host_ops.cpp,
// the digamma helper and the KSG loop the same in every operation, so the
// two libraries give the same bits. It follows sklearn's _compute_mi_cd:
// radius = distance to the k-th same-class neighbour shrunk one ulp; m =
// points within the radius, self included; singleton classes dropped.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// digamma via upward recurrence + asymptotic series (abs err < 1e-12 for x>0)
double digamma(double x) {
  double result = 0.0;
  while (x < 6.0) {
    result -= 1.0 / x;
    x += 1.0;
  }
  const double inv = 1.0 / x, inv2 = inv * inv;
  result += std::log(x) - 0.5 * inv
            - inv2 * (1.0 / 12 - inv2 * (1.0 / 120 - inv2 * (1.0 / 252 - inv2 / 240)));
  return result;
}

}  // namespace

extern "C" {

// x: [n, f] float64 (already std-scaled + noise-dithered by the caller),
// y: [n] int64, out: [f] float64. Returns 0 on success.
int ksg_mi_cd(const double* x, const int64_t* y, int64_t n, int64_t f,
              int64_t n_neighbors, double* out) {
  if (n <= 0 || f <= 0) return 1;

  // group sample indices by label
  std::vector<int64_t> labels(y, y + n);
  std::vector<int64_t> uniq(labels);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());

  std::vector<std::vector<int64_t>> groups(uniq.size());
  for (int64_t i = 0; i < n; ++i) {
    auto it = std::lower_bound(uniq.begin(), uniq.end(), y[i]);
    groups[it - uniq.begin()].push_back(i);
  }

  std::vector<double> count_of(n), k_of(n);
  std::vector<char> valid(n, 0);
  for (const auto& g : groups) {
    for (int64_t i : g) count_of[i] = (double)g.size();
    if (g.size() > 1) {
      int64_t k = std::min<int64_t>(n_neighbors, (int64_t)g.size() - 1);
      for (int64_t i : g) { k_of[i] = (double)k; valid[i] = 1; }
    }
  }
  double n_eff = 0;
  for (int64_t i = 0; i < n; ++i) n_eff += valid[i];
  if (n_eff == 0) { for (int64_t j = 0; j < f; ++j) out[j] = 0.0; return 0; }

  std::vector<double> dists;
  std::vector<double> col(n), radius(n);
  std::vector<double> valid_vals;
  valid_vals.reserve(n);

  for (int64_t j = 0; j < f; ++j) {
    for (int64_t i = 0; i < n; ++i) col[i] = x[i * f + j];

    // radius: distance to the k-th nearest same-class neighbour, one ulp down
    for (const auto& g : groups) {
      if (g.size() <= 1) continue;
      int64_t k = std::min<int64_t>(n_neighbors, (int64_t)g.size() - 1);
      dists.resize(g.size() - 1);
      for (size_t a = 0; a < g.size(); ++a) {
        size_t m = 0;
        for (size_t b = 0; b < g.size(); ++b)
          if (a != b) dists[m++] = std::abs(col[g[a]] - col[g[b]]);
        std::nth_element(dists.begin(), dists.begin() + (k - 1), dists.end());
        radius[g[a]] = std::nextafter(dists[k - 1], 0.0);
      }
    }

    // m_i: points (valid only, self included) within radius_i — the valid
    // column values sorted once, then binary search per sample
    valid_vals.clear();
    for (int64_t i = 0; i < n; ++i)
      if (valid[i]) valid_vals.push_back(col[i]);
    std::sort(valid_vals.begin(), valid_vals.end());

    double sum_dg_m = 0, sum_dg_k = 0, sum_dg_cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (!valid[i]) continue;
      // conservative window via binary search, then the exact |v-c|<=r
      // predicate (c±r rounding must not admit the k-th neighbour itself,
      // whose distance is one ulp above radius)
      const double c = col[i], r = radius[i];
      auto lo = std::lower_bound(valid_vals.begin(), valid_vals.end(), c - r);
      while (lo != valid_vals.begin() && std::abs(*(lo - 1) - c) <= r) --lo;
      auto hi = std::upper_bound(valid_vals.begin(), valid_vals.end(), c + r);
      double m = 0;
      for (auto it = lo; it != hi; ++it)
        if (std::abs(*it - c) <= r) m += 1.0;
      sum_dg_m += digamma(std::max(m, 1.0));
      sum_dg_k += digamma(k_of[i]);
      sum_dg_cnt += digamma(count_of[i]);
    }
    double mi = digamma(n_eff) + sum_dg_k / n_eff - sum_dg_cnt / n_eff
                - sum_dg_m / n_eff;
    out[j] = std::max(0.0, mi);
  }
  return 0;
}

}  // extern "C"

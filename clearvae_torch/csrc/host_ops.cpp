// Host ops of clearvae_torch, in C++17 with a plain C interface for ctypes:
// the KSG mutual information of continuous feature columns against discrete
// labels (Ross 2014), the building block of MIG, and corrupt_batch, K3's
// seven deterministic styles on the host. Built with
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
#include <cstring>
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

// ---------------------------------------------------------------------------
// K3's deterministic styles on the host (28x28 float32, 0..255), batched: the
// port's own copy of corrupt_batch from clearvae_tpu/native/host_ops.cpp, the
// same in every operation
// ---------------------------------------------------------------------------

static inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// style codes: 0 identity, 1 stripe, 2 brightness(sev), 3 inverse,
// 4 quantize(sev), 5 contrast(sev), 6 scale(sev)
int corrupt_batch(float* imgs, const int32_t* style, int64_t b, int64_t h,
                  int64_t w, int32_t severity) {
  const float bright_c[5] = {0.1f, 0.2f, 0.3f, 0.4f, 0.5f};
  const int quant_bits[5] = {5, 4, 3, 2, 1};
  const float contr_c[5] = {0.4f, 0.3f, 0.2f, 0.1f, 0.05f};
  const float scale_c[5] = {1.f / 0.9f, 1.f / 0.8f, 1.f / 0.7f, 1.f / 0.6f,
                            1.f / 0.5f};
  const int sev = std::min(std::max(severity, 1), 5) - 1;
  std::vector<float> tmp(h * w);

  for (int64_t i = 0; i < b; ++i) {
    float* im = imgs + i * h * w;
    switch (style[i]) {
      case 0:
        break;
      case 1:  // stripe: invert cols [0,7) and [21,w)
        for (int64_t r = 0; r < h; ++r)
          for (int64_t c = 0; c < w; ++c)
            if (c < 7 || c >= 21) im[r * w + c] = 255.f - im[r * w + c];
        break;
      case 2:  // brightness: clip(x/255 + c) * 255
        for (int64_t p = 0; p < h * w; ++p)
          im[p] = clampf(im[p] / 255.f + bright_c[sev], 0.f, 1.f) * 255.f;
        break;
      case 3:  // inverse
        for (int64_t p = 0; p < h * w; ++p) im[p] = 255.f - im[p];
        break;
      case 4: {  // quantize
        const float levels = (float)((1 << quant_bits[sev]) - 1);
        for (int64_t p = 0; p < h * w; ++p)
          im[p] = std::round(im[p] * levels / 255.f) * (255.f / levels);
        break;
      }
      case 5: {  // contrast: (x - mean)*c + mean in [0,1]
        double mean = 0;
        for (int64_t p = 0; p < h * w; ++p) mean += im[p] / 255.0;
        mean /= (double)(h * w);
        for (int64_t p = 0; p < h * w; ++p)
          im[p] = clampf(((im[p] / 255.f - (float)mean) * contr_c[sev]
                          + (float)mean), 0.f, 1.f) * 255.f;
        break;
      }
      case 6: {  // scale: center-preserving zoom-out, bilinear, cval 0
        const float s = scale_c[sev];
        const float t = 13.5f * (1.f - s);
        for (int64_t r = 0; r < h; ++r) {
          for (int64_t c = 0; c < w; ++c) {
            const float sc = s * (float)c + t;
            const float sr = s * (float)r + t;
            const float fr = std::floor(sr), fc = std::floor(sc);
            const float dr = sr - fr, dc = sc - fc;
            float acc = 0.f;
            const float ws[4] = {(1 - dr) * (1 - dc), (1 - dr) * dc,
                                 dr * (1 - dc), dr * dc};
            const int rr[4] = {(int)fr, (int)fr, (int)fr + 1, (int)fr + 1};
            const int cc[4] = {(int)fc, (int)fc + 1, (int)fc, (int)fc + 1};
            for (int q = 0; q < 4; ++q)
              if (rr[q] >= 0 && rr[q] < h && cc[q] >= 0 && cc[q] < w)
                acc += ws[q] * (im[rr[q] * w + cc[q]] / 255.f);
            tmp[r * w + c] = clampf(acc, 0.f, 1.f) * 255.f;
          }
        }
        std::memcpy(im, tmp.data(), sizeof(float) * h * w);
        break;
      }
      default:
        return 2;  // unknown style
    }
  }
  return 0;
}

}  // extern "C"

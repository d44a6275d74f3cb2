// K1, the fused CLEAR latent loss, for Hopper (sm_90a): one cooperative
// launch forward, one elementwise launch backward, fp32 on the CUDA cores;
// and K2f and K2b, the SNN loss and the SNN gradient of one half, as the
// one-half modes of K1's kernel.
//
// Replaces, in clearvae_tpu/ops/pallas/fused_loss.py:
//   clear_latent_fwdgrad <- _clear_fwdgrad_kernel (K1, pallas_call at :296):
//                           KL_c, KL_s, SNN(mu_c), SNN or PS-SNN(mu_s) and the
//                           unit-cotangent SNN gradients of both halves;
//   clear_latent_bwd     <- _fused_clear_bwd (:314), the combine of those
//                           gradients with the closed-form KL gradients;
//   snn_fwd              <- _fwd_kernel (K2f, pallas_call at :169):
//                           the SNN or PS-SNN loss of one half;
//   snn_bwd              <- _bwd_kernel (K2b, pallas_call at :187):
//                           g * dSNN/dmu of one half, g a device scalar.
//
// What bounds it. Per half the function needs B(B-1) pairs, each a z-deep
// dot product for S and another for (G + G^T) mu_n (~2.7e8 fp32 operations
// at B = 2048, z = 8: ~4 us at 67 TFLOP/s), and one IEEE expf (one MUFU.EX2,
// 16 a clock per SM) per entry of each of its two masked softmaxes
// (~1.3e7 at ten balanced labels with PS on, ~3 us). This kernel does not
// store the [B, B] softmaxes: it recomputes them, every entry in pass A and
// both G_ij and G_ji in pass B, ~9 exps a pair over both halves (~3.8e7,
// ~9 us of MUFU at B = 2048); the instructions around each exp (range
// reduction, the dot product, selects) take more issue slots than the exps
// take MUFU slots, so the issue rate is its practical floor. At the main
// path's B = 128 the whole call is ~0.3 MFLOP: launch and memory latency
// bound it.
//
// Design. Grid (T, 2); blockIdx.y is the half (c: SNN; s: SNN or PS-SNN),
// and the halves share nothing. A CTA has `slices` warps (16 for z <= 16,
// four a scheduler to hide the exp and shared-memory latencies; 8 above,
// where the registers of 512 threads do not hold a row and its
// accumulator). A row group is 32 rows, one per lane; warp w takes the
// columns j = w mod slices, so the 32 lanes of a warp read the same staged
// column: a shared-memory broadcast, no bank conflicts. A CTA owns row
// groups blockIdx.x, blockIdx.x + T, ...
//   stage   cp.async copies the half's mu (the flat [B*z] block in 16-byte
//           chunks with a 4-byte tail: rows of 7 floats are not 16-byte
//           aligned) and its int64 labels to shared memory, then normalizes
//           the rows there: r = |mu|, mu_n = mu / max(r, 1e-8). When the half
//           fits the 227 KB a block may use, it is one tile, staged once for
//           both passes, and own rows are read from it; beyond that, column
//           tiles of TJ rows stream through a two-stage ring in each pass
//           (B = 2048, z = 64: 10 tiles of 224). The CTA's share of the KL
//           terms is summed while the copies are in flight.
//   pass A  each lane keeps two online logsumexps over its slice of the
//           columns, over the valid pairs (j != i) and over the positive ones
//           (same label; other label for PS-SNN). The slices merge in a
//           fixed order through shared memory. The CTA writes lse_all,
//           lse_pos and has_pos of its rows to a global exchange buffer, and
//           its partial sums (rows with a positive, the row losses, the KL
//           terms; in double) to its own slot. No atomics.
//   grid.sync()
//   pass B  warp 0 sums the half's T slots in a fixed order (n_finite, the
//           loss and KL; CTA 0 writes them) while the other warps stage the
//           exchange arrays of all B columns. Each lane rebuilds
//           tau n_finite (G_ij + G_ji) = ok_i (p_all_ij - p_pos_ij) +
//           ok_j (p_all_ji - p_pos_ji) per pair from them, accumulates it
//           times mu_n_j per slice, merges the slices in order, divides by
//           tau n_finite once and applies the normalization projection
//           (dmu_n - (dmu_n . mu_n) mu_n [r > 1e-8]) / max(r, 1e-8).
// The pair loops have no branches: every exp of a pair is computed and
// selects drop what a mask excludes (one divergent exp would cost a warp
// both sides). Every sum is taken in a fixed order, so two calls are
// bit-identical. T = min(ceil(B / 32), co-resident CTAs / 2), from the
// occupancy of the (B, z) shape's shared memory, computed once per shape.
//
// K2b is the same kernel with Params::single = 1, launched on grid (T, 1):
// one half (mu, SNN or PS-SNN by ps), no KL sums and no loss written, and
// the gradient of pass B multiplied by the cotangent g, read on the device.
// A flag and not a template parameter: the branches it adds are uniform
// and cost nothing beside the pair loops, while a template mode would double
// the eight instances that dominate this file's build time. T, TJ and the
// column-tile ring are K1's (configure), so K2b takes every (B, z) that K1
// takes, and two calls are bit-identical for the same reason.
//
// K2f is K2b's launch with Params::single = 2, the loss only: pass A as
// above, without the exchange arrays (nothing reads them), then the grid
// barrier, and CTA 0's warp 0 reduces the T partial slots in the same fixed
// order as K1 and writes loss / max(n_finite, 1) to out4[0]; every other
// warp returns at the barrier, and none runs pass B. Every CTA reaches the
// one grid.sync() (none returns before it), so the barrier is K1's. A last-CTA-reduces ticket would drop
// the cooperative launch but needs a counter zeroed before each call (a
// second launch) or kept across calls (unsafe for two streams).
//
// The tensor cores are not used: S = mu_n mu_n^T has contraction depth z = 8,
// a TF32 mma misses rtol 2e-5 without a 3xTF32 split, and it would save only
// the 2z FMAs of a pair, while the exps and the issue slots around them set
// the floor. The masking constants are the TPU kernel's: -1e30 fill, -1e29
// max floor, 1e-37 sum floor. IEEE expf, logf and division, no fast-math;
// s = dot * (1 / tau) is within 1.5 ulp of the twin's dot / tau, and the
// gradient's division by tau n_finite comes after the sum over j, not
// before it (both well inside the tolerances: rtol 2e-5 on the terms).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (clearvae_torch/ops/kernels/_build.py). Every entry point launches on
// the given stream, does not synchronise, and returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-8f;        // torch cosine_similarity norm clamp
constexpr float kNeg = -1e30f;       // masked-entry fill
constexpr float kMaxFloor = -1e29f;  // max floor for empty rows
constexpr float kSumFloor = 1e-37f;  // sum floor for empty rows
constexpr int kRows = 32;            // rows of a row group, one per lane
constexpr unsigned kFull = 0xffffffffu;

// Warps of a CTA; warp w takes the columns j = w mod slices. 16 (four warps
// a scheduler, to hide the exp and shared-memory latencies) where the own
// row and its accumulator fit the registers of 512 threads, else 8.
__host__ __device__ constexpr int slices_for(int z) { return z <= 16 ? 16 : 8; }

struct Params {
  const float* mu[2];       // [B, z] of each half
  const float* lv[2];       // [B, z] log-variances
  const long long* label;   // [B]
  float* dmu[2];            // [B, z] unit-cotangent SNN gradients
  float* out4;              // kl_c, kl_s, snn(mu_c), snn or ps-snn(mu_s)
  float* ex;                // [halves][3][Bp]: lse_all, lse_pos, has_pos
  double* part;             // [halves][T][3]: positive rows, row losses, KL
  const float* g;           // K2b: the cotangent [1]; K1, K2f: null
  float tau;
  int B, Bp, z, T, TJ, ntiles, ps;
  // one half (mu[0]), no KL: 1 = K2b, the gradient scaled by *g; 2 = K2f,
  // the loss only, to out4[0]
  int single;
};

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Shared memory of one CTA, in floats from the base (16-byte aligned):
// the ring (1 or 2 stages of [TJp * z] floats of mu and [TJp] int64 labels),
// the row norms [Bp] (one tile only), the exchange arrays [3][Bp], the
// slice-merge area [32 * slices * max(z, 5)], then slices * 3 + 3 doubles
// for the reductions.
struct Layout {
  int stage;  // floats per ring stage
  int nrm, ex, merge, red;
  size_t bytes;
};

__host__ __device__ inline Layout layout(int Bp, int z, int TJ, int ntiles) {
  Layout L;
  const int tjp = round_up(TJ, 4);
  const int slices = slices_for(z);
  L.stage = tjp * z + 2 * tjp;
  L.nrm = (ntiles > 1 ? 2 : 1) * L.stage;
  L.ex = L.nrm + Bp;
  L.merge = L.ex + 3 * Bp;
  L.red = L.merge + kRows * slices * (z > 5 ? z : 5);
  L.bytes = (size_t)L.red * 4 + (slices * 3 + 3) * sizeof(double);
  return L;
}

// The online logsumexp update of the four-pass kernels, applied where take
// holds, without a branch: one exp whichever side a lane takes.
__device__ __forceinline__ void online_add_if(bool take, float& m, float& s,
                                             float x) {
  const float e = expf(fminf(m, x) - fmaxf(m, x));
  const float s_new = x > m ? s * e + 1.f : s + e;
  s = take ? s_new : s;
  m = take ? fmaxf(m, x) : m;
}

__device__ __forceinline__ void online_merge(float& m, float& s, float m2,
                                             float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

__device__ __forceinline__ float finish_lse(float m, float s) {
  const float m_safe = fmaxf(m, kMaxFloor);
  return logf(fmaxf(s, kSumFloor)) + m_safe;
}

// A row of z floats into registers; EXACT (z == ZM, 16-byte aligned rows)
// reads float4s.
template <int ZM, bool EXACT>
__device__ __forceinline__ void load_row(float (&v)[ZM], const float* x,
                                         int z) {
  if constexpr (EXACT) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
    for (int q = 0; q < ZM / 4; ++q) {
      const float4 t = x4[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ZM; ++k) v[k] = k < z ? x[k] : 0.f;
  }
}

template <int ZM, bool EXACT>
__device__ __forceinline__ void store_row(float* x, const float (&v)[ZM],
                                          int z) {
  if constexpr (EXACT) {
    float4* x4 = reinterpret_cast<float4*>(x);
#pragma unroll
    for (int q = 0; q < ZM / 4; ++q)
      x4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < ZM; ++k)
      if (k < z) x[k] = v[k];
  }
}

// mu_n = mu / max(|mu|, 1e-8) in place, the squares summed in k order;
// returns |mu|. Own rows and staged columns go through this one function,
// so a row's mu_n is the same bits in both roles.
template <int ZM>
__device__ __forceinline__ float normalize(float (&v)[ZM], int z) {
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < ZM; ++k)
    if (k < z) ss = fmaf(v[k], v[k], ss);
  const float r = sqrtf(ss);
  const float rc = fmaxf(r, kEps);
#pragma unroll
  for (int k = 0; k < ZM; ++k) v[k] = k < z ? v[k] / rc : 0.f;
  return r;
}

// xi . xj in k order, the staged column xj read where it lies.
template <int ZM, bool EXACT>
__device__ __forceinline__ float dot_col(const float (&xi)[ZM],
                                         const float* xj, int z) {
  float d = 0.f;
  if constexpr (EXACT) {
    const float4* x4 = reinterpret_cast<const float4*>(xj);
#pragma unroll
    for (int q = 0; q < ZM / 4; ++q) {
      const float4 t = x4[q];
      d = fmaf(xi[4 * q], t.x, d);
      d = fmaf(xi[4 * q + 1], t.y, d);
      d = fmaf(xi[4 * q + 2], t.z, d);
      d = fmaf(xi[4 * q + 3], t.w, d);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ZM; ++k)
      if (k < z) d = fmaf(xi[k], xj[k], d);
  }
  return d;
}

// acc += c xj, the staged column xj read where it lies.
template <int ZM, bool EXACT>
__device__ __forceinline__ void axpy_col(float (&acc)[ZM], float c,
                                         const float* xj, int z) {
  if constexpr (EXACT) {
    const float4* x4 = reinterpret_cast<const float4*>(xj);
#pragma unroll
    for (int q = 0; q < ZM / 4; ++q) {
      const float4 t = x4[q];
      acc[4 * q] = fmaf(c, t.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(c, t.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(c, t.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(c, t.w, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ZM; ++k)
      if (k < z) acc[k] = fmaf(c, xj[k], acc[k]);
  }
}

// nbytes (a multiple of 4) from global src to 16-byte aligned shared dst,
// with cp.async: 16-byte chunks where src is 16-byte aligned, then 4-byte
// pieces for the tail (or for all of it where src is not).
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int nbytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    const int n16 = nbytes >> 4;
    for (int c = threadIdx.x; c < n16; c += blockDim.x)
      __pipeline_memcpy_async(d + 16 * c, s + 16 * c, 16);
    done = n16 << 4;
  }
  for (int c = (done >> 2) + threadIdx.x; c < (nbytes >> 2); c += blockDim.x)
    __pipeline_memcpy_async(d + 4 * c, s + 4 * c, 4);
}

// One half's operands, picked out of Params with selects: indexing Params'
// arrays by blockIdx.y would copy all of Params to local memory.
struct Half {
  const float* mu;
  const float* lv;
  const long long* label;
  float* dmu;
  float* ex;  // [3][Bp]: lse_all, lse_pos, has_pos
  int B, Bp, z, TJ, ntiles, stage, lab_off;
};

// Issues the copies of column tile t into ring stage buf.
__device__ __forceinline__ void stage_tile(const Half& h, float* sm, int t,
                                           int buf) {
  float* smu = sm + buf * h.stage;
  const int j0 = t * h.TJ;
  const int n = min(h.TJ, h.B - j0);
  copy_async(smu, h.mu + (size_t)j0 * h.z, n * h.z * 4);
  copy_async(smu + h.lab_off, h.label + j0, n * 8);
}

// Normalizes the n staged rows in place; their norms go to nrm if given.
template <int ZM, bool EXACT>
__device__ __forceinline__ void normalize_tile(float* smu, float* nrm, int n,
                                               int z) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float v[ZM];
    load_row<ZM, EXACT>(v, smu + r * z, z);
    const float norm = normalize<ZM>(v, z);
    store_row<ZM, EXACT>(smu + r * z, v, z);
    if (nrm != nullptr) nrm[r] = norm;
  }
}

// Calls body(mu_n tile, label tile, first column, columns) for every column
// tile of the half. One tile: it was staged at the start of the kernel.
// More: the tiles stream through the two-stage ring, tile t + 1 in flight
// while tile t is normalized and used. Every thread of the CTA must call it.
template <int ZM, bool EXACT, class Body>
__device__ __forceinline__ void sweep(const Half& h, float* sm, Body&& body) {
  if (h.ntiles == 1) {
    body(sm, reinterpret_cast<const long long*>(sm + h.lab_off), 0, h.B);
    return;
  }
  stage_tile(h, sm, 0, 0);
  __pipeline_commit();
  for (int t = 0; t < h.ntiles; ++t) {
    if (t + 1 < h.ntiles) stage_tile(h, sm, t + 1, (t + 1) & 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    float* smu = sm + (t & 1) * h.stage;
    const int j0 = t * h.TJ;
    const int n = min(h.TJ, h.B - j0);
    normalize_tile<ZM, EXACT>(smu, nullptr, n, h.z);
    __syncthreads();
    body(smu, reinterpret_cast<const long long*>(smu + h.lab_off), j0, n);
    __syncthreads();
  }
}

// The own row i into registers, normalized; returns |mu_i| (0 past B).
template <int ZM>
__device__ __forceinline__ float own_row(float (&xi)[ZM], const float* mu,
                                         int i, bool valid, int z) {
  if (!valid) {
#pragma unroll
    for (int k = 0; k < ZM; ++k) xi[k] = 0.f;
    return 0.f;
  }
  load_row<ZM, false>(xi, mu + (size_t)i * z, z);
  return normalize<ZM>(xi, z);
}

template <int ZM, bool EXACT>
__global__ void __launch_bounds__(kRows * slices_for(ZM), 1)
    clear_latent_fwdgrad_kernel(const Params p) {
  constexpr int SL = slices_for(ZM);
  constexpr int NT = kRows * SL;
  extern __shared__ __align__(16) float sm[];
  const int half = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int B = p.B, Bp = p.Bp, z = p.z;
  const Layout L = layout(Bp, z, p.TJ, p.ntiles);
  Half h;
  h.mu = half ? p.mu[1] : p.mu[0];
  h.lv = half ? p.lv[1] : p.lv[0];
  h.dmu = half ? p.dmu[1] : p.dmu[0];
  h.label = p.label;
  h.ex = p.ex + (size_t)half * 3 * Bp;
  h.B = B;
  h.Bp = Bp;
  h.z = z;
  h.TJ = p.TJ;
  h.ntiles = p.ntiles;
  h.stage = L.stage;
  h.lab_off = round_up(p.TJ, 4) * z;
  const bool one_tile = h.ntiles == 1;
  const bool ps = (half == 1 || p.single) && p.ps != 0;
  // s = (mu_n_i . mu_n_j) * (1 / tau): within 1.5 ulp of the division
  const float inv_tau = 1.f / p.tau;
  const int groups = (B + kRows - 1) / kRows;
  float* const nrm = sm + L.nrm;
  float* const mg = sm + L.merge;
  double* const red = reinterpret_cast<double*>(sm + L.red);
  const long long* const lab1 =
      reinterpret_cast<const long long*>(sm + h.lab_off);

  if (one_tile) stage_tile(h, sm, 0, 0);
  __pipeline_commit();
  // this CTA's share of the KL terms, its loads in flight with the staging
  double kl = 0.0;
  const int n_kl = p.single ? 0 : B * z;
  for (int e = blockIdx.x * NT + threadIdx.x; e < n_kl; e += gridDim.x * NT) {
    const float lv = h.lv[e], m = h.mu[e];
    kl += (double)(1.f + lv - m * m - expf(lv));
  }
  if (one_tile) {
    __pipeline_wait_prior(0);
    __syncthreads();
    normalize_tile<ZM, EXACT>(sm, nrm, B, z);
    __syncthreads();
  }

  // ---- pass A: row logsumexps and row losses
  double cnt = 0.0, lsum = 0.0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int i = g * kRows + lane;
    const bool valid = i < B;
    float xi[ZM];
    long long li = -1;
    if (one_tile && valid) {
      load_row<ZM, EXACT>(xi, sm + i * z, z);
      li = lab1[i];
    } else {
      own_row<ZM>(xi, h.mu, i, valid, z);
      if (valid) li = h.label[i];
    }
    float m_all = kNeg, s_all = 0.f, m_pos = kNeg, s_pos = 0.f;
    int any_pos = 0;
    sweep<ZM, EXACT>(h, sm, [&](const float* smu, const long long* slab,
                                int j0, int n) {
      if (!valid) return;
#pragma unroll(ZM <= 16 ? 4 : 1)
      for (int jj = w; jj < n; jj += SL) {
        const float s = dot_col<ZM, EXACT>(xi, smu + jj * z, z) * inv_tau;
        const bool pos = ps ? (slab[jj] != li) : (slab[jj] == li);
        const bool other = j0 + jj != i;
        online_add_if(other, m_all, s_all, s);
        online_add_if(other && pos, m_pos, s_pos, s);
        any_pos |= other && pos;
      }
    });
    // merge the slices in slice order: mg[field][slice][lane]
    mg[(0 * SL + w) * kRows + lane] = m_all;
    mg[(1 * SL + w) * kRows + lane] = s_all;
    mg[(2 * SL + w) * kRows + lane] = m_pos;
    mg[(3 * SL + w) * kRows + lane] = s_pos;
    mg[(4 * SL + w) * kRows + lane] = any_pos ? 1.f : 0.f;
    __syncthreads();
    if (w == 0 && valid) {
      for (int v = 1; v < SL; ++v) {
        online_merge(m_all, s_all, mg[(0 * SL + v) * kRows + lane],
                     mg[(1 * SL + v) * kRows + lane]);
        online_merge(m_pos, s_pos, mg[(2 * SL + v) * kRows + lane],
                     mg[(3 * SL + v) * kRows + lane]);
        any_pos |= mg[(4 * SL + v) * kRows + lane] > 0.5f;
      }
      const float la = finish_lse(m_all, s_all);
      const float lp = finish_lse(m_pos, s_pos);
      if (p.single != 2) {
        h.ex[i] = la;
        h.ex[Bp + i] = lp;
        h.ex[2 * Bp + i] = any_pos ? 1.f : 0.f;
      }
      if (any_pos) {
        cnt += 1.0;
        lsum += (double)(-lp + la);
      }
    }
    __syncthreads();  // the merge area is reused by the next row group
  }
  // this CTA's partial sums, reduced in a fixed order, to its own slot
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, off);
    lsum += __shfl_xor_sync(kFull, lsum, off);
    kl += __shfl_xor_sync(kFull, kl, off);
  }
  if (lane == 0) {
    red[w * 3] = cnt;
    red[w * 3 + 1] = lsum;
    red[w * 3 + 2] = kl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double c = 0.0, l = 0.0, k = 0.0;
    for (int v = 0; v < SL; ++v) {
      c += red[v * 3];
      l += red[v * 3 + 1];
      k += red[v * 3 + 2];
    }
    double* slot = p.part + ((size_t)half * p.T + blockIdx.x) * 3;
    slot[0] = c;
    slot[1] = l;
    slot[2] = k;
  }

  cg::this_grid().sync();
  // K2f: only CTA 0's warp 0 is left, to reduce and write the loss
  if (p.single == 2 && (blockIdx.x != 0 || w != 0)) return;

  // ---- pass B: the half's totals, then the gradient of the CTA's rows
  double* const tot = red + SL * 3;
  float* const sx = sm + L.ex;  // staged exchange: [3][Bp]
  if (w == 0) {  // lane l sums slots l, l + 32, ...; then a fixed shuffle tree
    double c = 0.0, l = 0.0, k = 0.0;
    const double* pp = p.part + (size_t)half * p.T * 3;
    for (int t = lane; t < p.T; t += 32) {
      c += __ldcg(pp + 3 * t);
      l += __ldcg(pp + 3 * t + 1);
      k += __ldcg(pp + 3 * t + 2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(kFull, c, off);
      l += __shfl_xor_sync(kFull, l, off);
      k += __shfl_xor_sync(kFull, k, off);
    }
    if (lane == 0) {
      tot[0] = c;
      if (blockIdx.x == 0 && p.single != 1) {
        const float nf = (float)fmax(c, 1.0);
        if (!p.single) p.out4[half] = (float)(-0.5 * k) / (float)B;
        p.out4[p.single ? 0 : 2 + half] = (float)l / nf;
      }
    }
  } else {  // the other warps stage the exchange arrays meanwhile
    for (int e = threadIdx.x - 32; e < B; e += NT - 32) {
      sx[e] = __ldcg(h.ex + e);
      sx[Bp + e] = __ldcg(h.ex + Bp + e);
      sx[2 * Bp + e] = __ldcg(h.ex + 2 * Bp + e);
    }
  }
  if (p.single == 2) return;  // K2f: the loss is written; no pass B
  __syncthreads();
  const float denom = p.tau * (float)fmax(tot[0], 1.0);
  const float gv = p.single ? *p.g : 1.f;  // K1's unit cotangent: exact
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int i = g * kRows + lane;
    const bool valid = i < B;
    float xi[ZM], acc[ZM];
    float r = 0.f;
    long long li = -1;
    if (one_tile && valid) {
      load_row<ZM, EXACT>(xi, sm + i * z, z);
      r = nrm[i];
      li = lab1[i];
    } else {
      r = own_row<ZM>(xi, h.mu, i, valid, z);
      if (valid) li = h.label[i];
    }
#pragma unroll
    for (int k = 0; k < ZM; ++k) acc[k] = 0.f;
    const bool ok_i = valid && sx[2 * Bp + i] > 0.5f;
    const float la_i = valid ? sx[i] : 0.f;
    const float lp_i = valid ? sx[Bp + i] : 0.f;
    // acc = sum_j tau n_finite (G_ij + G_ji) mu_n_j; the division by
    // tau n_finite waits for the row's sum
    sweep<ZM, EXACT>(h, sm, [&](const float* smu, const long long* slab,
                                int j0, int n) {
      if (!valid) return;
#pragma unroll(ZM <= 16 ? 4 : 1)
      for (int jj = w; jj < n; jj += SL) {
        const int j = j0 + jj;
        const float* xj = smu + jj * z;
        const float s = dot_col<ZM, EXACT>(xi, xj, z) * inv_tau;
        const bool pos = ps ? (slab[jj] != li) : (slab[jj] == li);
        // all four exps, then selects: no branch (an exp that a select
        // drops may be inf, e.g. for a row without a positive)
        const float ea_i = expf(s - la_i), ep_i = expf(s - lp_i);
        const float ea_j = expf(s - sx[j]), ep_j = expf(s - sx[Bp + j]);
        float c = ok_i ? 0.f + (ea_i - (pos ? ep_i : 0.f)) : 0.f;
        c += sx[2 * Bp + j] > 0.5f ? ea_j - (pos ? ep_j : 0.f) : 0.f;
        if (j != i) axpy_col<ZM, EXACT>(acc, c, xj, z);
      }
    });
    // merge the slices in slice order: mg[slice][k][lane]
#pragma unroll
    for (int k = 0; k < ZM; ++k)
      if (k < z) mg[(w * z + k) * kRows + lane] = acc[k];
    __syncthreads();
    if (w == 0 && valid) {
      for (int v = 1; v < SL; ++v) {
#pragma unroll
        for (int k = 0; k < ZM; ++k)
          if (k < z) acc[k] += mg[(v * z + k) * kRows + lane];
      }
      float inner = 0.f;
#pragma unroll
      for (int k = 0; k < ZM; ++k) {
        acc[k] = k < z ? acc[k] / denom : 0.f;
        inner = fmaf(acc[k], xi[k], inner);
      }
      const float proj = r > kEps ? inner : 0.f;
      const float rc = fmaxf(r, kEps);
      float* out = h.dmu + (size_t)i * z;
#pragma unroll
      for (int k = 0; k < ZM; ++k)
        if (k < z) out[k] = gv * (acc[k] - proj * xi[k]) / rc;
    }
    __syncthreads();  // the merge area is reused by the next row group
  }
}

// dmu = g_kl mu / B + g_snn dsnn, dlv = g_kl (-0.5) (1 - exp(lv)) / B for
// both halves, term for term as _fused_clear_bwd (no contraction into FMAs).
__global__ void clear_latent_bwd_kernel(const float* __restrict__ mu_c,
                                        const float* __restrict__ lv_c,
                                        const float* __restrict__ mu_s,
                                        const float* __restrict__ lv_s,
                                        const float* __restrict__ dsnn_c,
                                        const float* __restrict__ dsnn_s,
                                        const float* __restrict__ g, int n,
                                        float fb, float* __restrict__ dmu_c,
                                        float* __restrict__ dlv_c,
                                        float* __restrict__ dmu_s,
                                        float* __restrict__ dlv_s) {
  const float g_klc = g[0], g_kls = g[1], g_c = g[2], g_s = g[3];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    dmu_c[e] = __fadd_rn(__fdiv_rn(__fmul_rn(g_klc, mu_c[e]), fb),
                         __fmul_rn(g_c, dsnn_c[e]));
    dlv_c[e] = __fdiv_rn(
        __fmul_rn(__fmul_rn(g_klc, -0.5f), __fsub_rn(1.f, expf(lv_c[e]))), fb);
    dmu_s[e] = __fadd_rn(__fdiv_rn(__fmul_rn(g_kls, mu_s[e]), fb),
                         __fmul_rn(g_s, dsnn_s[e]));
    dlv_s[e] = __fdiv_rn(
        __fmul_rn(__fmul_rn(g_kls, -0.5f), __fsub_rn(1.f, expf(lv_s[e]))), fb);
  }
}

using FwdKernel = void (*)(Params);

FwdKernel pick(int z) {
  if (z == 8) return clear_latent_fwdgrad_kernel<8, true>;
  if (z < 8) return clear_latent_fwdgrad_kernel<8, false>;
  if (z == 16) return clear_latent_fwdgrad_kernel<16, true>;
  if (z < 16) return clear_latent_fwdgrad_kernel<16, false>;
  if (z == 32) return clear_latent_fwdgrad_kernel<32, true>;
  if (z < 32) return clear_latent_fwdgrad_kernel<32, false>;
  if (z == 64) return clear_latent_fwdgrad_kernel<64, true>;
  return clear_latent_fwdgrad_kernel<64, false>;
}

// The launch shape of one (device, B, z), computed once.
struct Config {
  int dev, B, z;
  int T, TJ, ntiles;
  size_t smem;
};

std::mutex g_lock;
constexpr int kCache = 16;
Config g_cache[kCache];
int g_cached = 0;
FwdKernel g_opted_in[8];  // kernels whose dynamic shared memory limit is raised
int g_n_opted = 0;

#define RETURN_IF(call)                          \
  do {                                           \
    const cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

int configure(int B, int z, Config* out) {
  int dev;
  RETURN_IF(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> guard(g_lock);
  for (int c = 0; c < g_cached && c < kCache; ++c) {
    const Config& k = g_cache[c];
    if (k.dev == dev && k.B == B && k.z == z) {
      *out = k;
      return 0;
    }
  }
  const FwdKernel kern = pick(z);
  int optin, n_sm;
  RETURN_IF(cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  RETURN_IF(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev));
  bool opted = false;
  for (int k = 0; k < g_n_opted; ++k) opted |= g_opted_in[k] == kern;
  if (!opted) {
    RETURN_IF(cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
    g_opted_in[g_n_opted++] = kern;
  }
  Config c = {dev, B, z, 0, B, 1, 0};
  const int Bp = round_up(B, 4);
  c.smem = layout(Bp, z, B, 1).bytes;
  if (c.smem > (size_t)optin) {  // column tiles through a two-stage ring
    const size_t fixed = layout(Bp, z, 0, 2).bytes;
    const size_t per_row = 2 * (4 * (size_t)z + 8);
    if (fixed + 32 * per_row > (size_t)optin) return (int)cudaErrorInvalidValue;
    c.TJ = (int)((optin - fixed) / per_row) / 32 * 32;
    c.ntiles = (B + c.TJ - 1) / c.TJ;
    c.smem = layout(Bp, z, c.TJ, c.ntiles).bytes;
  }
  int per_sm = 0;
  RETURN_IF(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kRows * slices_for(z), c.smem));
  c.T = std::min((B + kRows - 1) / kRows, per_sm * n_sm / 2);
  if (c.T < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  g_cache[g_cached++ % kCache] = c;
  *out = c;
  return 0;
}

// One cooperative launch of the forward kernel on grid (T, halves).
int launch(const Params& p, const Config& c, int halves, cudaStream_t st) {
  Params q = p;
  void* args[] = {&q};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)pick(p.z), dim3(c.T, halves), dim3(kRows * slices_for(p.z)),
      args, c.smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so it does not surface in a later call
    return (int)e;
  }
  return (int)cudaGetLastError();
}

Params base_params(int B, int z, float tau, int ps, const Config& c) {
  Params p = {};
  p.tau = tau;
  p.B = B;
  p.Bp = round_up(B, 4);
  p.z = z;
  p.T = c.T;
  p.TJ = c.TJ;
  p.ntiles = c.ntiles;
  p.ps = ps ? 1 : 0;
  return p;
}

}  // namespace

extern "C" {

// The forward's launch shape for (B, z) on the current device: out[0] = T
// (CTAs per half), out[1] = TJ (columns per tile), out[2] = tiles, out[3] =
// dynamic shared memory bytes per CTA.
int clear_latent_config(int B, int z, int* out) {
  if (B < 1 || z < 1 || z > 64) return (int)cudaErrorInvalidValue;
  Config c;
  const int err = configure(B, z, &c);
  if (err != 0) return err;
  out[0] = c.T;
  out[1] = c.TJ;
  out[2] = c.ntiles;
  out[3] = (int)c.smem;
  return 0;
}

// K1 forward, one cooperative launch. out4 = [kl_c, kl_s, snn(mu_c), snn or
// ps-snn(mu_s)]; dsnn_c, dsnn_s [B, z] are the unit-cotangent gradients of
// the two SNN terms. ex holds 6 * round_up(B, 4) floats and part
// 6 * ceil(B / 32) doubles of scratch; the caller allocates both.
int clear_latent_fwdgrad(const float* mu_c, const float* lv_c,
                         const float* mu_s, const float* lv_s,
                         const long long* label, int B, int z, float tau,
                         int ps, float* out4,
                         float* dsnn_c, float* dsnn_s, float* ex,
                         double* part, void* stream) {
  if (B < 1 || z < 1 || z > 64 || !(tau > 0.f))
    return (int)cudaErrorInvalidValue;
  Config c;
  const int err = configure(B, z, &c);
  if (err != 0) return err;
  Params p = base_params(B, z, tau, ps, c);
  p.mu[0] = mu_c;
  p.mu[1] = mu_s;
  p.lv[0] = lv_c;
  p.lv[1] = lv_s;
  p.label = label;
  p.dmu[0] = dsnn_c;
  p.dmu[1] = dsnn_s;
  p.out4 = out4;
  p.ex = ex;
  p.part = part;
  return launch(p, c, 2, (cudaStream_t)stream);
}

// K2b, one cooperative launch on grid (T, 1): dmu [B, z] = g[0] * dSNN/dmu,
// SNN or (ps) PS-SNN of mu, with g a device scalar. ex holds
// 3 * round_up(B, 4) floats and part 3 * ceil(B / 32) doubles of scratch;
// the caller allocates both.
int snn_bwd(const float* mu, const long long* label, const float* g, int B,
            int z, float tau, int ps, float* dmu, float* ex, double* part,
            void* stream) {
  if (B < 1 || z < 1 || z > 64 || !(tau > 0.f))
    return (int)cudaErrorInvalidValue;
  Config c;
  const int err = configure(B, z, &c);
  if (err != 0) return err;
  Params p = base_params(B, z, tau, ps, c);
  p.mu[0] = p.mu[1] = mu;
  p.label = label;
  p.dmu[0] = p.dmu[1] = dmu;
  p.ex = ex;
  p.part = part;
  p.g = g;
  p.single = 1;
  return launch(p, c, 1, (cudaStream_t)stream);
}

// K2f, one cooperative launch on grid (T, 1): out[0] = the SNN or (ps)
// PS-SNN loss of mu. part holds 3 * ceil(B / 32) doubles of scratch; the
// caller allocates it.
int snn_fwd(const float* mu, const long long* label, int B, int z, float tau,
            int ps, float* out, double* part, void* stream) {
  if (B < 1 || z < 1 || z > 64 || !(tau > 0.f))
    return (int)cudaErrorInvalidValue;
  Config c;
  const int err = configure(B, z, &c);
  if (err != 0) return err;
  Params p = base_params(B, z, tau, ps, c);
  p.mu[0] = p.mu[1] = mu;
  p.label = label;
  p.out4 = out;
  p.part = part;
  p.single = 2;
  return launch(p, c, 1, (cudaStream_t)stream);
}

// K1 backward, one launch: dmu_c, dlv_c, dmu_s, dlv_s [B, z] from the
// forward's inputs and SNN gradients and the cotangent g [4] of out4, read on
// the device.
int clear_latent_bwd(const float* mu_c, const float* lv_c, const float* mu_s,
                     const float* lv_s, const float* dsnn_c,
                     const float* dsnn_s, const float* g, int B, int z,
                     float* dmu_c, float* dlv_c, float* dmu_s, float* dlv_s,
                     void* stream) {
  if (B < 1 || z < 1) return (int)cudaErrorInvalidValue;
  const int n = B * z;
  const int threads = 256;
  const int blocks = std::min((n + threads - 1) / threads, 1024);
  clear_latent_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      mu_c, lv_c, mu_s, lv_s, dsnn_c, dsnn_s, g, n, (float)B, dmu_c, dlv_c,
      dmu_s, dlv_s);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The fused SNN loss kernel K2f for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel of clearvae_tpu/ops/pallas/fused_loss.py:
//   snn_fwd               <- _fwd_kernel (K2f): the SNN / PS-SNN loss of one
//                            half, with no gradient work.
// K1 (_clear_fwdgrad_kernel) and K2b (_bwd_kernel) are clear_latent.cu, one
// cooperative launch each.
//
// What bounds it. The TPU kernels hold whole [n, n] similarity matrices in
// VMEM; a Hopper SM has 227 KB of shared memory, which holds that only up to
// B ~ 128. At B = 128, z = 8 one call moves a few KB and does ~0.3 MFLOP: it
// is bound by launch latency, not by bytes or FLOPs. At B = 2048 the pair
// work (~0.1 GFLOP of fp32 FMAs and exps) starts to count.
//
// Design. Nothing [B, B] is ever stored. Blocks run in parallel and share no
// state, so the work is split into passes, each a grid of independent warps:
//   normalize  one thread per row: mu_n = mu / max(|mu|, 1e-8).
//   rowstats   one warp per row i (8 rows per block): the lanes walk the
//              columns j, build s_ij = mu_n_i . mu_n_j / tau on the fly (z <= 64
//              lives in registers) and keep two online logsumexps, over the
//              valid pairs (j != i) and over the positive ones (same label for
//              SNN, other label for PS-SNN); a warp shuffle merges the lanes.
//              Writes lse_all[i], lse_pos[i], has_pos[i].
//   reduce     one block: n_finite = max(#rows with a positive, 1), the mean
//              row loss and, for K1, the two KL sums (accumulated in double).
// The passes still take a second half (blockIdx.y) and a KL term, which only
// the four-pass K1 used.
// The masking constants are the TPU kernel's: -1e30 fill, -1e29 max floor,
// 1e-37 sum floor.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (clearvae_torch/ops/kernels/_build.py). Every entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-8f;        // torch cosine_similarity norm clamp
constexpr float kNeg = -1e30f;       // masked-entry fill
constexpr float kMaxFloor = -1e29f;  // max floor for empty rows
constexpr float kSumFloor = 1e-37f;  // sum floor for empty rows
constexpr int kWarps = 8;            // rows (warps) per block in the row passes
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Half {
  const float* mu;  // [B, z]
  const float* lv;  // [B, z] log-variance for the KL term, or null
  float* mu_n;      // [B, z] scratch: normalized rows
  float* lse_all;   // [B] scratch
  float* lse_pos;   // [B] scratch
  float* has_pos;   // [B] scratch: 1 if the row has a positive pair
  float* nf;        // [1] scratch: n_finite
  float* loss;      // [1] output or null
  float* kl;        // [1] output or null
  int ps;           // 1: positives are the other-label pairs (PS-SNN)
};

struct Halves {
  Half h[2];
};

__device__ __forceinline__ Half pick(const Halves& hs, int which) {
  return which ? hs.h[1] : hs.h[0];
}

__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
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

__global__ void fused_loss_normalize(Halves hs, int B, int z) {
  const Half h = pick(hs, blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float* m = h.mu + (size_t)i * z;
  float ss = 0.f;
  for (int k = 0; k < z; ++k) ss = fmaf(m[k], m[k], ss);
  const float rc = fmaxf(sqrtf(ss), kEps);
  for (int k = 0; k < z; ++k) h.mu_n[(size_t)i * z + k] = m[k] / rc;
}

template <int ZM>
__device__ __forceinline__ float row_dot(const float (&xi)[ZM],
                                         const float* __restrict__ xj, int z) {
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < ZM; ++k)
    if (k < z) dot = fmaf(xi[k], xj[k], dot);
  return dot;
}

template <int ZM>
__global__ void fused_loss_rowstats(Halves hs, const int* __restrict__ label,
                                int B, int z, float tau) {
  const Half h = pick(hs, blockIdx.y);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= B) return;  // uniform across the warp
  float xi[ZM];
#pragma unroll
  for (int k = 0; k < ZM; ++k) xi[k] = k < z ? h.mu_n[(size_t)i * z + k] : 0.f;
  const int li = label[i];
  float m_all = kNeg, s_all = 0.f, m_pos = kNeg, s_pos = 0.f;
  int any_pos = 0;
  for (int j = lane; j < B; j += 32) {
    if (j == i) continue;
    const float s = row_dot<ZM>(xi, h.mu_n + (size_t)j * z, z) / tau;
    online_add(m_all, s_all, s);
    const bool pos = h.ps ? (label[j] != li) : (label[j] == li);
    if (pos) {
      online_add(m_pos, s_pos, s);
      any_pos = 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ma = __shfl_xor_sync(kFull, m_all, off);
    const float sa = __shfl_xor_sync(kFull, s_all, off);
    const float mp = __shfl_xor_sync(kFull, m_pos, off);
    const float sp = __shfl_xor_sync(kFull, s_pos, off);
    online_merge(m_all, s_all, ma, sa);
    online_merge(m_pos, s_pos, mp, sp);
  }
  any_pos = __any_sync(kFull, any_pos);
  if (lane == 0) {
    h.lse_all[i] = finish_lse(m_all, s_all);
    h.lse_pos[i] = finish_lse(m_pos, s_pos);
    h.has_pos[i] = any_pos ? 1.f : 0.f;
  }
}

__device__ double block_sum(double v, double* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  const double out = buf[0];
  __syncthreads();
  return out;
}

__global__ void fused_loss_reduce(Halves hs, int n_halves, int B, int z) {
  __shared__ double buf[kReduceThreads];
  for (int which = 0; which < n_halves; ++which) {
    const Half h = pick(hs, which);
    double cnt = 0.0, lsum = 0.0;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      if (h.has_pos[i] > 0.5f) {
        cnt += 1.0;
        lsum += (double)(-h.lse_pos[i] + h.lse_all[i]);
      }
    }
    cnt = block_sum(cnt, buf);
    lsum = block_sum(lsum, buf);
    double kl = 0.0;
    if (h.lv != nullptr) {
      const int n = B * z;
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const float lv = h.lv[e], mu = h.mu[e];
        kl += (double)(1.f + lv - mu * mu - expf(lv));
      }
      kl = block_sum(kl, buf);
    }
    if (threadIdx.x == 0) {
      const float nf = (float)fmax(cnt, 1.0);
      h.nf[0] = nf;
      if (h.loss != nullptr) h.loss[0] = (float)lsum / nf;
      if (h.kl != nullptr) h.kl[0] = (float)(-0.5 * kl) / (float)B;
    }
  }
}

// Per-half scratch layout, in floats: mu_n [B*z], lse_all, lse_pos,
// has_pos [B each], nf [1].
int scratch_per_half(int B, int z) { return B * z + 3 * B + 1; }

void carve(Half& h, float* scratch, int B, int z) {
  h.mu_n = scratch;
  h.lse_all = h.mu_n + (size_t)B * z;
  h.lse_pos = h.lse_all + B;
  h.has_pos = h.lse_pos + B;
  h.nf = h.has_pos + B;
}

template <int ZM>
void launch_rowstats(const Halves& hs, int nh, const int* label, int B, int z,
                     float tau, cudaStream_t st) {
  dim3 grid((B + kWarps - 1) / kWarps, nh);
  fused_loss_rowstats<ZM><<<grid, 32 * kWarps, 0, st>>>(hs, label, B, z, tau);
}

#define RETURN_IF_ERROR()                          \
  do {                                             \
    const cudaError_t err_ = cudaGetLastError();   \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

// normalize -> rowstats -> reduce over nh halves.
int run(const Halves& hs, int nh, const int* label, int B, int z, float tau,
        cudaStream_t st) {
  if (B < 1 || z < 1 || z > 64 || !(tau > 0.f)) return (int)cudaErrorInvalidValue;
  dim3 ngrid((B + 255) / 256, nh);
  fused_loss_normalize<<<ngrid, 256, 0, st>>>(hs, B, z);
  RETURN_IF_ERROR();
  if (z <= 8) launch_rowstats<8>(hs, nh, label, B, z, tau, st);
  else if (z <= 16) launch_rowstats<16>(hs, nh, label, B, z, tau, st);
  else if (z <= 32) launch_rowstats<32>(hs, nh, label, B, z, tau, st);
  else launch_rowstats<64>(hs, nh, label, B, z, tau, st);
  RETURN_IF_ERROR();
  fused_loss_reduce<<<1, kReduceThreads, 0, st>>>(hs, nh, B, z);
  RETURN_IF_ERROR();
  return 0;
}

Half half_of(const float* mu, const float* lv, int ps, float* scratch, int B,
             int z) {
  Half h = {};
  h.mu = mu;
  h.lv = lv;
  h.ps = ps;
  carve(h, scratch, B, z);
  return h;
}

}  // namespace

extern "C" {

// Floats of scratch one half needs; the caller allocates it.
int fused_loss_scratch_floats(int B, int z) { return scratch_per_half(B, z); }

// K2f. loss [1] = SNN or PS-SNN of mu.
int snn_fwd(const float* mu, const int* label, int B, int z, float tau, int ps,
            float* loss, float* scratch, void* stream) {
  Halves hs;
  hs.h[0] = half_of(mu, nullptr, ps ? 1 : 0, scratch, B, z);
  hs.h[0].loss = loss;
  hs.h[1] = hs.h[0];
  return run(hs, 1, label, B, z, tau, (cudaStream_t)stream);
}

}  // extern "C"

// K3, the fused deterministic Styled-MNIST styler, for Hopper (sm_90a), fp32
// on the CUDA cores.
//
// Replaces the Pallas TPU kernel _style_kernel of
// clearvae_tpu/ops/pallas/style_kernel.py: a [B, H, H] float32 batch on the
// 0..255 scale is styled per sample by a code (0 identity, 1 stripe,
// 2 brightness, 3 inverse, 4 quantize, 5 contrast, 6 scale; any other code
// leaves the sample as it is), all at one severity whose constants the caller
// passes in (clearvae_torch/ops/kernels/style.py).
//
// What bounds it. Each pixel is read once and written once: at B = 128 and
// H = 28 that is 0.4 MB each way, 0.24 us at 3.35 TB/s. The most arithmetic is
// scale's two products with the [H, H] zoom matrix A, 2 * 2 * H operations a
// pixel, 0.2 us at the 67 TFLOP/s fp32 peak if every sample were scaled. So
// it is bound by bytes on paper, and in practice by the launch itself.
//
// Design. The Pallas kernel holds the whole batch in VMEM and computes all
// seven candidates for every pixel, then selects. Here one block styles one
// image (B blocks, 256 threads looping over the H * H pixels) and computes
// only the branch its sample's code selects; the code is uniform in a block,
// so the branch and its __syncthreads never diverge.
//   - elementwise codes read and write global memory directly, coalesced;
//   - contrast stages x / 255 in shared memory and reduces its sum in the
//     block (warp shuffles, then one warp over the warp sums);
//   - scale stages x / 255 in shared memory, forms T = A x01 in a second
//     shared buffer, then writes clip(T A^T) * 255; A (at most 2 nonzeros a
//     row) is read through the read-only cache.
// Shared memory is 2 * H * H floats, 32 KB at the largest H of 64.
// Parity with the JAX package: rintf rounds half to even as jnp.round does;
// the _rn intrinsics keep nvcc from contracting the contrast and brightness
// arithmetic into FMAs; x / 255 is an IEEE division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (clearvae_torch/ops/kernels/_build.py). style_batch launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ float to01(float v) { return __fdiv_rn(v, 255.f); }

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  return warp_sums[0];
}

__global__ void __launch_bounds__(kThreads)
style_kernel(const float* __restrict__ x, const int* __restrict__ code,
             const float* __restrict__ a, int h, int w, float bright,
             float q_mul, float q_div, float contr, float* __restrict__ out) {
  extern __shared__ float smem[];  // [h * w] x / 255, then [h * w] A x01
  __shared__ float warp_sums[kThreads / 32];
  const int n = h * w;
  const float* xb = x + static_cast<size_t>(blockIdx.x) * n;
  float* ob = out + static_cast<size_t>(blockIdx.x) * n;
  const int c = code[blockIdx.x];
  const int tid = threadIdx.x;

  if (c == 5 || c == 6) {
    float* x01 = smem;
    float part = 0.f;
    for (int p = tid; p < n; p += kThreads) {
      x01[p] = to01(xb[p]);
      part += x01[p];
    }
    if (c == 5) {  // contrast, around the image's mean
      const float mean = __fdiv_rn(block_sum(part, warp_sums),
                                   static_cast<float>(n));
      for (int p = tid; p < n; p += kThreads) {
        const float v = __fadd_rn(__fmul_rn(__fsub_rn(x01[p], mean), contr),
                                  mean);
        ob[p] = __fmul_rn(clip01(v), 255.f);
      }
      return;
    }
    // scale: T = A x01 (rows), then out = clip(T A^T) * 255 (columns)
    float* t = smem + n;
    __syncthreads();
    for (int p = tid; p < n; p += kThreads) {
      const int i = p / w, k = p - i * w;
      float acc = 0.f;
      for (int j = 0; j < h; ++j) acc = fmaf(__ldg(a + i * h + j), x01[j * w + k], acc);
      t[p] = acc;
    }
    __syncthreads();
    for (int p = tid; p < n; p += kThreads) {
      const int i = p / w, k = p - i * w;
      float acc = 0.f;
      for (int l = 0; l < w; ++l) acc = fmaf(t[i * w + l], __ldg(a + k * h + l), acc);
      ob[p] = __fmul_rn(clip01(acc), 255.f);
    }
    return;
  }

  for (int p = tid; p < n; p += kThreads) {
    const float v = xb[p];
    float r;
    switch (c) {
      case 1: {  // stripe
        const int col = p % w;
        r = (col < 7 || col >= 21) ? 255.f - v : v;
        break;
      }
      case 2:  // brightness
        r = __fmul_rn(clip01(__fadd_rn(to01(v), bright)), 255.f);
        break;
      case 3:  // inverse
        r = 255.f - v;
        break;
      case 4:  // quantize
        r = __fmul_rn(rintf(__fmul_rn(v, q_mul)), q_div);
        break;
      default:  // identity, and any code the kernel does not know
        r = v;
    }
    ob[p] = r;
  }
}

}  // namespace

extern "C" int style_batch(const float* x, const int* code, const float* a,
                           int b, int h, int w, float bright, float q_mul,
                           float q_div, float contr, float* out, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(h) * w * sizeof(float);
  style_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, code, a, h, w, bright, q_mul, q_div, contr, out);
  return static_cast<int>(cudaGetLastError());
}

// K3, the fused deterministic Styled-MNIST styler, for Hopper (sm_90a), fp32
// on the CUDA cores.
//
// Replaces the Pallas TPU kernel _style_kernel of
// clearvae_tpu/ops/pallas/style_kernel.py: a [B, H, H] float32 batch on the
// 0..255 scale is styled per sample by a code (0 identity, 1 stripe,
// 2 brightness, 3 inverse, 4 quantize, 5 contrast, 6 scale; a code above 6
// copies the sample), all at one severity whose constants the caller passes
// in (clearvae_torch/ops/kernels/style.py). A negative code means the row is
// not this kernel's: its block reads nothing and writes nothing, so the
// caller styles a whole batch into its own output in one launch and other
// routes fill the rows that K3 leaves.
//
// What bounds it. Each pixel is read once and written once: at H = 28 that
// is 0.4 MB each way at B = 128 (0.24 us at 3.35 TB/s) and 1.6 MB at the
// B = 512 chunks (0.96 us). Scale, the heaviest code, needs 2 * 2 taps of
// the bilinear zoom per output pixel, a few operations, so bytes bound it
// on paper. At these sizes a call is a few memory round trips plus the
// launch; scale adds its gathers and the IEEE divisions x / 255, which the
// design keeps to one a pixel.
//
// Design. One block styles one image: B = 128 batches are one wave of 128
// CTAs on 132 SMs, B = 512 chunks 512 CTAs at ~4 a SM, all co-resident (an
// SM holds more than 4 CTAs of 224 threads, 3 KB of shared memory and < 64
// registers a thread), so no CTA waits for another, and a thread loads,
// computes and stores its own pixels once. Threads map to (row, column group) through a 2-D block: threadIdx.y
// is the row, threadIdx.x a group of V consecutive pixels of it (V = 4 with
// 16-byte vector loads and stores where W % 4 == 0 and the pointers are
// 16-byte aligned: H = 28 gives 7 float4s a 112-byte row; else V = 1).
// blockDim.x is the groups of a row rounded up to a power of two (8 at
// H = 28), blockDim.y the rows, so every warp is full (224 threads at
// H = 28, 28 of 32 lanes a warp busy) and no pixel index is divided.
//   - elementwise codes (identity, stripe, brightness, inverse, quantize,
//     and codes above 6) read and write their pixels, coalesced;
//   - contrast sums x / 255 of the image in a fixed order (each thread's
//     pixels in order, a warp xor tree, the warp sums in warp order, read by
//     every thread), so two calls are bit-identical; the pixels are read
//     again from L1 for the output;
//   - scale uses a table of the zoom's taps, made once per (H, severity) on
//     the host: for each output index the first source index, the second,
//     and their weights (weight 0 and a clamped index where a tap falls
//     outside the image). Output pixel (i, k) is the two row taps of the two
//     column taps of x / 255: T(i, l) = w1_i x(r1_i, l) + w0_i x(r0_i, l)
//     for l = the two column taps of k, then out = w1_k T(i, c1_k) +
//     w0_k T(i, c0_k), each an fmaf chain from 0 in ascending source index.
//     That is the dense A x A^T of the TPU kernel (and of this kernel's
//     first design) with its exact zeros dropped: the same rounding, so the
//     same bits on finite inputs, in 6 FMAs a pixel instead of 2 * 2H. The
//     taps gather each source pixel about four times, so each thread first
//     stages x / 255 of its own pixels in shared memory (one division a
//     pixel, not four; H * H floats, 3 KB at H = 28, 16 KB at 64), one
//     barrier, then gathers from there.
// Parity with the JAX package: rintf rounds half to even as jnp.round does;
// the _rn intrinsics keep nvcc from contracting the contrast and brightness
// arithmetic into FMAs; x / 255 is an IEEE division.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (clearvae_torch/ops/kernels/_build.py). style_batch launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

struct Consts {
  float bright, q_mul, q_div, contr;
};

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ float to01(float v) { return __fdiv_rn(v, 255.f); }

// Sum of v over the block, in a fixed order; every thread gets the result.
// The block's threads are whole warps.
__device__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int nw = blockDim.x * blockDim.y / 32;
  if ((t & 31) == 0) warp_sums[t >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int q = 0; q < nw; ++q) s += warp_sums[q];
  return s;
}

// One pixel of an elementwise code at column col.
__device__ __forceinline__ float elementwise(int c, float v, int col,
                                             const Consts& k) {
  switch (c) {
    case 1:  // stripe
      return (col < 7 || col >= 21) ? 255.f - v : v;
    case 2:  // brightness
      return __fmul_rn(clip01(__fadd_rn(to01(v), k.bright)), 255.f);
    case 3:  // inverse
      return 255.f - v;
    case 4:  // quantize
      return __fmul_rn(rintf(__fmul_rn(v, k.q_mul)), k.q_div);
    default:  // identity, and any code above 6
      return v;
  }
}

// A zoom tap pair: source indices r0 <= r1 (clamped into the image) and
// their weights, as four 32-bit words.
struct Tap {
  int r0, r1;
  float w0, w1;
};

__device__ __forceinline__ Tap load_tap(const int4* taps, int i) {
  const int4 t = __ldg(taps + i);
  return {t.x, t.y, __int_as_float(t.z), __int_as_float(t.w)};
}

// Output pixel (row tap ti, column tap tk) of scale from the image's x / 255
// (s, rows of w), before the clip.
__device__ __forceinline__ float zoom_pixel(const float* s, int w,
                                            const Tap& ti, const Tap& tk) {
  const float* x0 = s + ti.r0 * w;
  const float* x1 = s + ti.r1 * w;
  const float t0 = fmaf(ti.w1, x1[tk.r0], fmaf(ti.w0, x0[tk.r0], 0.f));
  const float t1 = fmaf(ti.w1, x1[tk.r1], fmaf(ti.w0, x0[tk.r1], 0.f));
  return fmaf(tk.w1, t1, fmaf(tk.w0, t0, 0.f));
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void get(const float* p, float (&v)[1]) { v[0] = *p; }
  __device__ static void put(float* p, const float (&v)[1]) { *p = v[0]; }
};
template <>
struct Vec<4> {
  __device__ static void get(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void put(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
style_kernel(const float* __restrict__ x, const int* __restrict__ code,
             const int4* __restrict__ taps, int h, int w, Consts k,
             float* __restrict__ out) {
  __shared__ float warp_sums[kMaxThreads / 32];
  extern __shared__ float x01[];  // scale: [h * w] x / 255 of the image
  const int c = code[blockIdx.x];
  if (c < 0) return;  // not K3's row: left as the caller has it
  const size_t n = static_cast<size_t>(h) * w;
  const float* xb = x + blockIdx.x * n;
  float* ob = out + blockIdx.x * n;
  const int col0 = threadIdx.x * V;
  const bool active = col0 < w;
  float v[V];

  if (c == 5) {  // contrast, around the image's mean
    float part = 0.f;
    if (active)
      for (int i = threadIdx.y; i < h; i += blockDim.y) {
        Vec<V>::get(xb + i * w + col0, v);
#pragma unroll
        for (int q = 0; q < V; ++q) part += to01(v[q]);
      }
    const float mean =
        __fdiv_rn(block_sum(part, warp_sums), static_cast<float>(n));
    if (!active) return;
    for (int i = threadIdx.y; i < h; i += blockDim.y) {
      Vec<V>::get(xb + i * w + col0, v);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float r = __fadd_rn(
            __fmul_rn(__fsub_rn(to01(v[q]), mean), k.contr), mean);
        v[q] = __fmul_rn(clip01(r), 255.f);
      }
      Vec<V>::put(ob + i * w + col0, v);
    }
    return;
  }
  if (c == 6) {  // scale: the two row taps of the two column taps
    Tap tk[V];
    if (active) {
#pragma unroll
      for (int q = 0; q < V; ++q) tk[q] = load_tap(taps, col0 + q);
      for (int i = threadIdx.y; i < h; i += blockDim.y) {
        Vec<V>::get(xb + i * w + col0, v);
#pragma unroll
        for (int q = 0; q < V; ++q) x01[i * w + col0 + q] = to01(v[q]);
      }
    }
    __syncthreads();
    if (!active) return;
    for (int i = threadIdx.y; i < h; i += blockDim.y) {
      const Tap ti = load_tap(taps, i);
#pragma unroll
      for (int q = 0; q < V; ++q)
        v[q] = __fmul_rn(clip01(zoom_pixel(x01, w, ti, tk[q])), 255.f);
      Vec<V>::put(ob + i * w + col0, v);
    }
    return;
  }
  if (!active) return;
  for (int i = threadIdx.y; i < h; i += blockDim.y) {
    Vec<V>::get(xb + i * w + col0, v);
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = elementwise(c, v[q], col0 + q, k);
    Vec<V>::put(ob + i * w + col0, v);
  }
}

// The block for one image of width w in groups of V pixels: the groups of a
// row rounded up to a power of two (to a multiple of 32 past 32), and as many
// rows as fit 1,024 threads, rounded so that the block is whole warps.
dim3 block_for(int h, int w, int vec) {
  const int groups = (w + vec - 1) / vec;
  int bx = 1;
  while (bx < groups && bx < 32) bx <<= 1;
  if (groups > 32) bx = (groups + 31) / 32 * 32;
  const int row_mult = bx < 32 ? 32 / bx : 1;
  int by = (h + row_mult - 1) / row_mult * row_mult;
  if (by * bx > kMaxThreads) by = kMaxThreads / bx;
  return dim3(bx, by);
}

}  // namespace

extern "C" int style_batch(const float* x, const int* code, const int* taps,
                           int b, int h, int w, float bright, float q_mul,
                           float q_div, float contr, float* out, void* stream) {
  if (b < 1 || h < 1 || w < 1 || w > 64) return (int)cudaErrorInvalidValue;
  const Consts k = {bright, q_mul, q_div, contr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* t4 = reinterpret_cast<const int4*>(taps);
  const size_t smem = sizeof(float) * h * w;  // 16 KB at the largest H
  const bool vec4 = w % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (vec4)
    style_kernel<4><<<b, block_for(h, w, 4), smem, st>>>(x, code, t4, h, w, k,
                                                         out);
  else
    style_kernel<1><<<b, block_for(h, w, 1), smem, st>>>(x, code, t4, h, w, k,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

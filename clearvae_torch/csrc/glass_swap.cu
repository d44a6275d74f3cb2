// K5, glass_blur's pixel swaps, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU the swaps are the lax.scan of
// clearvae_tpu/ops/corruptions.py glass_blur, one step a coordinate. The
// port first wrote that scan as a Python loop of torch ops over the batch's
// flat rows (clearvae_torch/ops/kernels/glass.py glass_swaps_plain, its
// plain twin): a gather, two where, a slice write and a scatter a
// coordinate, ~6,760 kernels of 128 elements a call at severity 1 (1,352
// coordinates). Here one launch does every swap of the batch.
//
// The swaps of an image, in the reference's raster order: swap j exchanges
// pixel p = base[j] (the flat index r * W + c of its coordinate) with
// q = p + dy * W + dx, (dx, dy) = deltas[image, j], where flag[image, j] is
// set. Each swap reads both pixels before it writes either, and writes p
// first, then q, as the loop does; a swap whose partner is its own pixel,
// or whose flag is clear, leaves the image as it is.
//
// Design. One block an image. Its threads stage the image's H * W float32
// pixels in shared memory, and beside them one 32-bit word a swap: p in the
// low 16 bits, q in the high, with q = p where the flag is clear (the same
// no-op; a p or q outside the image also becomes a no-op, so no input reads
// or writes outside the block's row). One barrier; then one thread walks
// the n swaps in order over shared memory, reading the words kChunk at a
// time ahead of their swaps and skipping the no-ops; one barrier; then all
// threads write the image out. Loads and stores are
// coalesced. The image is read whole before any of it is written, so the
// output may be the input (in place).
//
// What bounds it. The walk is a chain of n dependent shared-memory
// read-then-write pairs, ~30 cycles each, against ~0.4 MB of pixels each way
// at B = 128 (~0.3 us at 3.35 TB/s). B = 128 images are one wave of 128
// blocks on 132 SMs, so a call costs about one image's chain: 31.9 us at
// n = 1,352 (severity 1) and 20.1 us at n = 800 (severity 5) on an H100 at
// 700 W. Neither bytes nor FLOPs bound it: the serial chain does. Reading
// the words ahead halved it: read one at a time, each waited behind the
// previous swap's writes (61.4 us at severity 1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (clearvae_torch/ops/kernels/_build.py). glass_swaps launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(); it is capturable in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;   // swap words the walk reads ahead
// dynamic shared memory a block may take without opting in
constexpr long long kSmemBytes = 48 * 1024;
constexpr long long kMaxPixels = 1 << 16;   // p and q fit in 16 bits

__global__ void __launch_bounds__(kThreads)
    glass_swap_kernel(const float* x, float* out,
                      const int64_t* __restrict__ deltas,
                      const uint8_t* __restrict__ flag,
                      const int64_t* __restrict__ base, int hw, int width,
                      int n) {
  extern __shared__ uint32_t smem[];
  float* pix = reinterpret_cast<float*>(smem);
  uint32_t* pq = smem + hw;
  const int64_t img = blockIdx.x;
  const float* src = x + img * hw;
  const int64_t* d = deltas + img * n * 2;
  const uint8_t* f = flag + img * n;
  for (int i = threadIdx.x; i < hw; i += kThreads) pix[i] = src[i];
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int64_t p = base[j];
    const int64_t q = p + d[2 * j + 1] * width + d[2 * j];
    const bool inside = p >= 0 && p < hw && q >= 0 && q < hw;
    const uint32_t p16 = inside ? static_cast<uint32_t>(p) : 0u;
    const uint32_t q16 = inside && f[j] ? static_cast<uint32_t>(q) : p16;
    pq[j] = p16 | (q16 << 16);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // kChunk words read ahead of the chunk's swaps: the words and the
    // pixels share one shared array, so the compiler would not move a
    // word's read above an earlier swap's writes by itself
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      uint32_t w[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) w[k] = j0 + k < n ? pq[j0 + k] : 0u;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const uint32_t p = w[k] & 0xffffu, q = w[k] >> 16;
        if (p != q) {
          const float a = pix[p], b = pix[q];
          pix[p] = b;
          pix[q] = a;
        }
      }
    }
  }
  __syncthreads();
  float* dst = out + img * hw;
  for (int i = threadIdx.x; i < hw; i += kThreads) dst[i] = pix[i];
}

}  // namespace

// x, out: [batch, hw] float32 (out may be x); deltas: [batch, n, 2] int64
// (dx, dy); flag: [batch, n] bool; base: [n] int64.
extern "C" int glass_swaps(const float* x, float* out, const int64_t* deltas,
                           const uint8_t* flag, const int64_t* base,
                           int64_t batch, int64_t hw, int64_t width,
                           int64_t n, void* stream) {
  const long long smem = 4LL * (hw + n);
  if (batch < 1 || batch > 0x7fffffffLL || hw < 1 || hw > kMaxPixels ||
      width < 1 || n < 0 || smem > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  glass_swap_kernel<<<static_cast<unsigned>(batch), kThreads,
                      static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      x, out, deltas, flag, base, static_cast<int>(hw),
      static_cast<int>(width), static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

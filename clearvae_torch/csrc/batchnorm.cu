// K6, BatchNorm with its input cast, its output cast and the activation
// after it, for Hopper (sm_90a): one kernel pair forward, one backward.
//
// Replaces no Pallas kernel: on the TPU XLA fuses flax's BatchNorm, its
// casts and the activation (clearvae_tpu/models/layers.py). The port wrote
// the layer as torch ops (clearvae_torch/ops/kernels/batchnorm.py
// batch_norm_plain, its plain twin): a cast to float32, two means, the
// variance, rsqrt, three broadcast passes, the cast back, then ReLU or
// sigmoid, and autograd's backward of all of it: ~35 kernels a layer, each
// a pass over the activations in float32.
//
// What it computes, for x viewed as [n, c, hw] (a 2-D [n, c] input has
// hw = 1), in float32 whatever x's dtype T (float or bfloat16):
//   stats       sum x and sum x^2 per channel; mean = sum / cnt, var =
//               E[x^2] - mean^2 (kept unclamped, so the backward can mask
//               as the clamp does; every reader takes max(var, 0)); with
//               running statistics given, running = running * (1 - m) +
//               m * stat, the variance clamped and biased (flax's).
//   apply       y = (x - mean) * (w * rsqrt(var + eps)) + b, rounded to T,
//               then the activation (none, ReLU, sigmoid) on that T value,
//               its result rounded to T again: the roundings of a float32
//               result cast to T and F.relu / torch.sigmoid applied to it.
//   grad_reduce g = dy times the activation's derivative (recomputed from
//               x, with the forward's roundings; sigmoid's dy * (1 - s) * s
//               rounded to T after each operation, as torch's CUDA
//               sigmoid_backward rounds it on a bf16 tensor); per
//               channel sum g (= dbias) and sum g * xhat (= dweight), xhat =
//               (x - mean) * rstd.
//   grad_apply  dx = w * rstd * (g - sum g / cnt - xhat * sum g xhat / cnt),
//               the last term dropped where var < 0 (the clamp's mask) and
//               both means dropped in eval mode; rounded to T, which is the
//               rounding of the gradient's cast back.
//
// What bounds it. Memory: stats reads x, apply reads x and writes y,
// grad_reduce reads dy and x, grad_apply reads dy and x and writes dx: 8
// element passes a layer, ~16 B an element in bfloat16. The layers are
// small (0.26-4.2 M elements at B = 128), so launch latency and the
// reduction's tail matter as much as bandwidth.
//
// Design. x is read in the order it lies in memory: an NCHW tensor as
// [N, C, H·W], a channels-last one (the port's conv stacks run
// channels-last: the models permute their NHWC inputs) as [N·H·W, C, 1], a
// 2-D one as [N, C, 1]. The reductions (stats, grad_reduce) split every
// channel over row chunks as well as over channels, so that 3 channels of
// 4,096 x 128 and 512 channels of 4 both fill the 132 SMs: grid (channel
// tiles, chunks). Planes of hw >= 32 ("planes" path): one block a channel
// and a chunk of rows, its threads walking the chunk's hw-long runs with
// 16-byte loads. Smaller planes and hw = 1 ("rows" path): one block a tile
// of whole channels and a chunk of rows; each thread holds one fixed
// 16-byte slot of the tile's span of a row and the block covers as many
// rows at once as its threads allow, so a warp's loads are contiguous; the
// slots are then summed a channel at a time in shared memory. Each block
// writes one float pair a channel into a partials buffer; the block that
// arrives last (an integer counter, reset by that block) sums each
// channel's partials in a fixed order (fixed lanes, a fixed shuffle tree)
// and finalises. No float atomics anywhere: a call repeats bit for bit.
// The elementwise stages walk the tensor with 16-byte vectors of one
// channel (hw a multiple of the vector) or of consecutive channels (hw =
// 1), and one element a thread elsewhere.
//
// The arrival counters are one per reduction in this library's device
// memory: calls on one device must not overlap on two streams.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (clearvae_torch/ops/kernels/_build.py). bn_launch launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError(); it is capturable in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kApplyBlocksPerSm = 16;
constexpr int kSms = 132;
constexpr unsigned kRowsHw = 32;  // planes below this take the rows path
constexpr int kUnroll = 4;        // loads a thread issues before summing
constexpr int kLoads = 8;         // partials a lane reads at once

enum Stage { kStats = 0, kApply = 1, kGradReduce = 2, kGradApply = 3 };
enum Act { kNone = 0, kRelu = 1, kSigmoid = 2 };
enum Dtype { kFloat32 = 0, kBFloat16 = 1 };

// one arrival counter a reduction stage; the last block resets its own
__device__ unsigned int g_arrivals[2] = {0u, 0u};

struct Params {
  const void* x;
  const void* dy;
  void* out;            // y (apply) or dx (grad_apply)
  const float* mean;    // [c]
  const float* var;     // [c], unclamped in train mode
  const float* weight;  // [c]
  const float* bias;    // [c]
  const float* sums;    // [2, c]: grad_reduce's sum g, sum g xhat
  float* partial;       // [chunks, 2, c]
  float* result;        // [2, c]: the reduction's output
  float* running_mean;  // [c] or null
  float* running_var;   // [c] or null
  unsigned n, c, hw;    // x as [n, c, hw]
  unsigned rows;        // rows a chunk
  unsigned cpt;         // channels a tile (rows path), 1 on the planes path
  int act;
  int train;
  float eps, momentum, keep;  // keep = 1 - momentum, rounded once on the host
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// a float32 value as T holds it
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// one channel's normalisation, as the plain twin computes it
struct Channel {
  float mean, rstd, mul, bias, var;
  Channel() = default;
  __device__ __forceinline__ Channel(const Params& p, unsigned c) {
    mean = p.mean[c];
    var = p.var[c];
    rstd = rsqrtf(__fadd_rn(fmaxf(var, 0.f), p.eps));
    mul = __fmul_rn(p.weight[c], rstd);
    bias = p.bias[c];
  }
  // the normalised value in float32, before any rounding
  __device__ __forceinline__ float y(float x) const {
    return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
  }
  __device__ __forceinline__ float xhat(float x) const {
    return __fmul_rn(__fsub_rn(x, mean), rstd);
  }
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// the activation of y rounded to T, as T holds its result
template <typename T>
__device__ __forceinline__ float activate(float y, int act) {
  const float v = rnd<T>(y);
  if (act == kRelu) return v < 0.f ? 0.f : v;
  if (act == kSigmoid) return rnd<T>(sigmoid(v));
  return v;
}

// dy times the activation's derivative at y, rounded as torch's backward
// of the activation on a T tensor rounds it
template <typename T>
__device__ __forceinline__ float act_grad(float dy, float y, int act) {
  const float v = rnd<T>(y);
  if (act == kRelu) return v <= 0.f ? 0.f : dy;
  if (act == kSigmoid) {
    // torch's sigmoid_backward on a T tensor (CUDA): dy * (1 - s) * s with
    // each of its three results rounded to T
    const float s = rnd<T>(sigmoid(v));
    const float t = rnd<T>(__fmul_rn(dy, rnd<T>(__fsub_rn(1.f, s))));
    return rnd<T>(__fmul_rn(t, s));
  }
  return dy;
}

// grad_reduce's two values of one element, g and g * xhat, added to (a, b)
template <typename T>
__device__ __forceinline__ void accumulate_grad(const Channel& ch, float x,
                                                float dy, int act, float& a,
                                                float& b) {
  const float g = act_grad<T>(dy, ch.y(x), act);
  a += g;
  b += g * ch.xhat(x);
}

// The last block of a reduction's grid sums each channel's partials over
// the chunks in a fixed order (g lanes a channel, each lane a fixed stride
// of chunks, then a fixed xor tree) and finalises it.
template <bool kGrad>
__device__ void finish(const Params& p, int slot) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    last = atomicAdd(&g_arrivals[slot], 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned c_all = p.c, chunks = gridDim.y;
  unsigned g = 32;
  while (g > 1 && g * c_all > kThreads) g >>= 1;
  const unsigned lane = threadIdx.x % g, groups = kThreads / g;
  const float cnt = static_cast<float>(p.n) * static_cast<float>(p.hw);
  for (unsigned c0 = 0; c0 < c_all; c0 += groups) {
    const unsigned c = c0 + threadIdx.x / g;
    float a = 0.f, b = 0.f;
    if (c < c_all) {
      // kLoads chunks at once, so that a round's loads are in flight
      // together
      for (unsigned s0 = lane; s0 < chunks; s0 += kLoads * g) {
        float va[kLoads], vb[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const unsigned s = s0 + u * g;
          va[u] = s < chunks ? __ldcg(p.partial + (2 * s) * c_all + c) : 0.f;
          vb[u] =
              s < chunks ? __ldcg(p.partial + (2 * s + 1) * c_all + c) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          a += va[u];
          b += vb[u];
        }
      }
    }
    for (unsigned o = g / 2; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (c < c_all && lane == 0) {
      if (kGrad) {
        p.result[c] = a;
        p.result[c_all + c] = b;
      } else {
        const float mean = a / cnt;
        const float var = __fsub_rn(b / cnt, __fmul_rn(mean, mean));
        p.result[c] = mean;
        p.result[c_all + c] = var;
        if (p.running_mean != nullptr) {
          p.running_mean[c] = __fadd_rn(__fmul_rn(p.running_mean[c], p.keep),
                                        __fmul_rn(p.momentum, mean));
          p.running_var[c] =
              __fadd_rn(__fmul_rn(p.running_var[c], p.keep),
                        __fmul_rn(p.momentum, fmaxf(var, 0.f)));
        }
      }
    }
  }
  if (threadIdx.x == 0) atomicExch(&g_arrivals[slot], 0u);
}

// kUnroll V-wide loads of x (and dy) at offsets off(u), u = 0..kUnroll-1,
// those with live(u) issued together, then summed into (a, b) lane by lane
// in u's order; lane k's channel is ch(k)
template <typename T, int V, bool kGrad, typename Off, typename Live,
          typename Ch>
__device__ __forceinline__ void sum_batch(const Params& p, const T* x,
                                          const T* dy, Off off, Live live,
                                          Ch ch, float (&a)[V],
                                          float (&b)[V]) {
  Pack<T, V> xv[kUnroll], gv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (live(u)) {
      xv[u] = *reinterpret_cast<const Pack<T, V>*>(x + off(u));
      if (kGrad) gv[u] = *reinterpret_cast<const Pack<T, V>*>(dy + off(u));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (!live(u)) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_f(xv[u].v[k]);
      if (kGrad) {
        accumulate_grad<T>(ch(k), v, to_f(gv[u].v[k]), p.act, a[k], b[k]);
      } else {
        a[k] += v;
        b[k] += v * v;
      }
    }
  }
}

// Planes path: block (channel, chunk); the chunk's rows' hw-long runs of
// the channel, walked V elements a thread at a time.
template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kThreads) bn_reduce_planes(Params p) {
  __shared__ float sh[2 * kWarps];
  const unsigned c = blockIdx.x, s = blockIdx.y;
  const unsigned r0 = s * p.rows;
  const unsigned r1 = min(p.n, r0 + p.rows);
  const unsigned hw = p.hw, count = (r1 - r0) * hw;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
  Channel ch;
  if (kGrad) ch = Channel(p, c);
  for (unsigned f0 = threadIdx.x * V; f0 < count;
       f0 += kUnroll * kThreads * V) {
    sum_batch<T, V, kGrad>(
        p, x, dy,
        [&](int u) {
          const unsigned f = f0 + u * kThreads * V;
          return (static_cast<size_t>(r0 + f / hw) * p.c + c) * hw + f % hw;
        },
        [&](int u) { return f0 + u * kThreads * V < count; },
        [&](int) -> const Channel& { return ch; }, a, b);
  }
  float ta = 0.f, tb = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ta += a[k];
    tb += b[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ta += __shfl_xor_sync(0xffffffffu, ta, o);
    tb += __shfl_xor_sync(0xffffffffu, tb, o);
  }
  const unsigned warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sh[warp] = ta;
    sh[kWarps + warp] = tb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ta = tb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      ta += sh[w];
      tb += sh[kWarps + w];
    }
    p.partial[(2 * s) * p.c + c] = ta;
    p.partial[(2 * s + 1) * p.c + c] = tb;
  }
  finish<kGrad>(p, kGrad ? 1 : 0);
}

// Rows path (planes of hw < 32, and hw = 1: [n, c] or channels-last
// [N·H·W, C]): block (tile of cpt whole channels, chunk). The tile's span
// of a row is cpt·hw elements, V to a thread; the block's threads cover
// kThreads / (span / V) rows at once, each thread one fixed V-wide slot of
// the span, so a warp's loads are contiguous. Then the row groups are
// summed by a fixed halving tree in shared memory, and each channel's
// positions in order.
template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kThreads) bn_reduce_rows(Params p) {
  __shared__ float sa[kThreads * V], sb[kThreads * V];
  const unsigned s = blockIdx.y, hw = p.hw, row = p.c * hw;
  const unsigned c0 = blockIdx.x * p.cpt;
  const unsigned cpt = min(p.cpt, p.c - c0), span = cpt * hw;
  const unsigned slots = span / V, groups = kThreads / slots;
  const unsigned slot = threadIdx.x % slots, q = threadIdx.x / slots;
  const unsigned r0 = s * p.rows;
  const unsigned r1 = min(p.n, r0 + p.rows);
  const unsigned col = c0 * hw + slot * V;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  if (q < groups) {
    float a[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    Channel ch[V];
    if (kGrad) {
#pragma unroll
      for (int k = 0; k < V; ++k) ch[k] = Channel(p, (col + k) / hw);
    }
    for (unsigned r = r0 + q; r < r1; r += kUnroll * groups) {
      sum_batch<T, V, kGrad>(
          p, x, dy,
          [&](int u) {
            return static_cast<size_t>(r + u * groups) * row + col;
          },
          [&](int u) { return r + u * groups < r1; },
          [&](int k) -> const Channel& { return ch[k]; }, a, b);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sa[q * span + slot * V + k] = a[k];
      sb[q * span + slot * V + k] = b[k];
    }
  }
  __syncthreads();
  unsigned top = 1;
  while (top < groups) top <<= 1;
  for (unsigned h = top / 2; h > 0; h >>= 1) {
    for (unsigned i = threadIdx.x; i < h * span; i += kThreads) {
      if (i / span + h < groups) {
        sa[i] += sa[i + h * span];
        sb[i] += sb[i + h * span];
      }
    }
    __syncthreads();
  }
  for (unsigned j = threadIdx.x; j < cpt; j += kThreads) {
    float ta = 0.f, tb = 0.f;
    for (unsigned i = 0; i < hw; ++i) {
      ta += sa[j * hw + i];
      tb += sb[j * hw + i];
    }
    p.partial[(2 * s) * p.c + c0 + j] = ta;
    p.partial[(2 * s + 1) * p.c + c0 + j] = tb;
  }
  finish<kGrad>(p, kGrad ? 1 : 0);
}

// apply (kGrad false: y) or grad_apply (kGrad true: dx) over the whole
// tensor, V elements a thread at a time: of one channel (hw a multiple of
// V), or of V consecutive channels (kLanes: hw = 1, c a multiple of V)
template <typename T, int V, bool kGrad, bool kLanes>
__global__ void __launch_bounds__(kThreads) bn_elementwise(Params p) {
  const unsigned nvec = p.n * p.c * p.hw / V;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  T* out = static_cast<T*>(p.out);
  const float cnt = static_cast<float>(p.n) * static_cast<float>(p.hw);
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += gridDim.x * kThreads) {
    const unsigned c = kLanes ? i * V % p.c : (i * V / p.hw) % p.c;
    const Channel one(p, c);
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[i];
    Pack<T, V> ov;
    if (kGrad) {
      const Pack<T, V> gv = reinterpret_cast<const Pack<T, V>*>(dy)[i];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const Channel ch = kLanes ? Channel(p, c + k) : one;
        const unsigned ck = kLanes ? c + k : c;
        float mg = 0.f, mgx = 0.f;
        if (p.train) {
          mg = p.sums[ck] / cnt;
          mgx = ch.var < 0.f ? 0.f : p.sums[p.c + ck] / cnt;
        }
        const float xf = to_f(xv.v[k]);
        const float g = act_grad<T>(to_f(gv.v[k]), ch.y(xf), p.act);
        const float t =
            __fsub_rn(__fsub_rn(g, mg), __fmul_rn(ch.xhat(xf), mgx));
        ov.v[k] = from_f<T>(__fmul_rn(ch.mul, t));
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const Channel ch = kLanes ? Channel(p, c + k) : one;
        ov.v[k] = from_f<T>(activate<T>(ch.y(to_f(xv.v[k])), p.act));
      }
    }
    reinterpret_cast<Pack<T, V>*>(out)[i] = ov;
  }
}

template <typename T, int V, bool kLanes>
void launch_elementwise(bool grad, const Params& p, cudaStream_t stream) {
  const unsigned nvec = p.n * p.c * p.hw / V;
  const unsigned want = (nvec + kThreads - 1) / kThreads;
  const unsigned most = kSms * kApplyBlocksPerSm;
  const unsigned blocks = want < most ? want : most;
  if (grad)
    bn_elementwise<T, V, true, kLanes><<<blocks, kThreads, 0, stream>>>(p);
  else
    bn_elementwise<T, V, false, kLanes><<<blocks, kThreads, 0, stream>>>(p);
}

template <typename T, int V>
void launch_v(int stage, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.c + p.cpt - 1) / p.cpt, (p.n + p.rows - 1) / p.rows);
  const bool grad = stage == kGradReduce || stage == kGradApply;
  if (stage == kApply || stage == kGradApply) {
    if (V > 1 && p.hw % V != 0)
      launch_elementwise<T, V, true>(grad, p, stream);
    else
      launch_elementwise<T, V, false>(grad, p, stream);
  } else if (p.hw < kRowsHw) {
    if (grad)
      bn_reduce_rows<T, V, true><<<grid, kThreads, 0, stream>>>(p);
    else
      bn_reduce_rows<T, V, false><<<grid, kThreads, 0, stream>>>(p);
  } else if (grad) {
    bn_reduce_planes<T, V, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    bn_reduce_planes<T, V, false><<<grid, kThreads, 0, stream>>>(p);
  }
}

template <typename T>
int launch_t(int stage, const Params& p, int vec, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (vec == kV)
    launch_v<T, kV>(stage, p, stream);
  else if (vec == 1)
    launch_v<T, 1>(stage, p, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// whether a stage takes this grid and vector width (see bn_launch)
bool valid(int stage, long long n, long long c, long long hw, long long rows,
           long long cpt, int vec) {
  if (n < 1 || c < 1 || hw < 1 || n * c * hw > 0x7fffffffLL || rows < 1 ||
      cpt < 1 || vec < 1 || (n + rows - 1) / rows > 65535)
    return false;
  if (stage == kApply || stage == kGradApply)
    return vec == 1 || hw % vec == 0 || (hw == 1 && c % vec == 0);
  if (hw >= kRowsHw) return cpt == 1 && hw % vec == 0;
  return cpt * hw <= kThreads * vec && (c * hw) % vec == 0 &&
         (cpt >= c || (cpt * hw) % vec == 0);
}

}  // namespace

// One stage of K6 on x viewed as [n, c, hw] (dense, float32 or bfloat16
// by dtype): an NCHW tensor is [N, C, H·W], a channels-last one [N·H·W, C,
// 1], a 2-D one [N, C, 1]. The reductions (stats, grad_reduce) run on a
// grid of ceil(c / cpt) tiles by ceil(n / rows) chunks and need partial:
// [chunks, 2, c] float32; planes of hw >= 32 take one channel a tile (cpt
// = 1) and need hw a multiple of vec; smaller ones take the rows path,
// cpt·hw <= 256·vec, c·hw and (unless one tile holds every channel)
// cpt·hw multiples of vec. The elementwise stages (apply, grad_apply) take
// vec = 1, or hw a multiple of vec, or hw = 1 and c a multiple of vec.
// vec is 16 / element size or 1, and x, dy and out are then 16-byte
// aligned. running_mean and running_var are updated by stats where not
// null.
extern "C" int bn_launch(int stage, int dtype, int act, int train,
                         const void* x, const void* dy, void* out,
                         const float* mean, const float* var,
                         const float* weight, const float* bias,
                         const float* sums, float* partial, float* result,
                         float* running_mean, float* running_var,
                         long long n, long long c, long long hw,
                         long long rows, long long cpt, int vec, float eps,
                         float momentum, float keep, void* stream) {
  if (stage < kStats || stage > kGradApply || act < kNone || act > kSigmoid ||
      !valid(stage, n, c, hw, rows, cpt, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.dy = dy;
  p.out = out;
  p.mean = mean;
  p.var = var;
  p.weight = weight;
  p.bias = bias;
  p.sums = sums;
  p.partial = partial;
  p.result = result;
  p.running_mean = running_mean;
  p.running_var = running_var;
  p.n = static_cast<unsigned>(n);
  p.c = static_cast<unsigned>(c);
  p.hw = static_cast<unsigned>(hw);
  p.rows = static_cast<unsigned>(rows);
  p.cpt = static_cast<unsigned>(cpt);
  p.act = act;
  p.train = train;
  p.eps = eps;
  p.momentum = momentum;
  p.keep = keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_t<float>(stage, p, vec, st);
  if (dtype == kBFloat16) return launch_t<__nv_bfloat16>(stage, p, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

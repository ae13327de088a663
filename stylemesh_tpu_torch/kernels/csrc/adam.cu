// The texture's update: Adam, then the clamp to the Gatys range, over every
// layer of the atlas in one launch, with the texture regularizer's gradient
// folded in; and the regularizer's value in one read of the atlas.
//
// Replaces the TPU path's optax.adam and clamp_texture (an XLA fusion there;
// no pallas_call), which the port ran as eleven PyTorch elementwise kernels
// a layer. For each element of each layer, in float32 and in this order:
//   g = g + c * p                             (only where the layer's c != 0)
//   m = m * b1 + (1 - b1) * g
//   v = v * b2 + (1 - b2) * g * g
//   p = p - (m / bc1) * lr / (sqrt(v / bc2) + eps)
//   p = clamp(p, lo, hi)                      (a NaN stays NaN)
// with the roundings of that chain: each product, quotient, root and sum
// rounded to float32 as its own kernel rounded it, the two moment updates as
// fused multiply-adds (their PyTorch kernels compute a + alpha * b). The
// scheduled rate and the bias corrections are read from device memory,
// scalars = {lr, bc1, bc2}, so that a CUDA graph that captured the launch
// reads the values written before each replay; b1, b2, eps and the clamp's
// bounds are launch constants. c is layer l's coefficient of the texture
// regularizer sum_l w_l * mean(p_l^2) (times its loss weight): its gradient
// is c_l * p, added here to the rest of the loss's gradient g, so that
// autograd never runs the regularizer's atlas-sized passes. The product and
// the sum are rounded apart, as autograd rounded them: its backward of
// mean(p^2) * w times the loss weight is (2 p) * (weight * w / N), the
// same product as c * p (c = 2 weight w / N, a power of two apart), and
// the engine then added it to g. A layer whose c is 0 skips the term (a
// branch uniform over the layer), so g keeps its bits, the sign of a zero
// included.
//
// What bounds it on an H100: bytes. Every element of p, g, m and v is read
// once and p, m and v written once: 28 bytes an element, 1.87 GB a step at
// the bench atlas (4096^2 ... 512^2 x 3), 0.559 ms at 3.35 TB/s; the fold
// adds no byte (p is read anyway). The three
// divisions and the root are IEEE-exact (not the approximate forms), some
// 40 instructions an element, well under the bytes' time.
// - 16-byte loads and stores: four elements of each array a thread and
//   iteration; a layer whose count is not a multiple of four ends in a
//   scalar tail. The wrapper checks 16-byte alignment.
// - One grid-stride loop a layer over a persistent grid (as many blocks as
//   fit on the card, fewer for a small atlas), layers in table order: every
//   thread streams through each layer in turn, so no layer waits on a
//   block that a larger one holds.
// Nothing is allocated and nothing synchronizes the host; the launch goes
// on PyTorch's current stream.
//
// The regularizer's value, sum_l s_l * sum(p_l^2) with s_l = w_l / N_l (the
// caller's weights over the full layers' sizes), one float32 on the device:
// - tex_reg_partials_kernel: the same persistent grid and layer table; each
//   thread sums the squares of its elements of a layer in double (a float's
//   square is exact there), scales the sum by s_l and adds it to its own
//   total; each block sums its threads' totals in a fixed tree and writes
//   one partial;
// - tex_reg_finish_kernel: one block sums the partials in a fixed order and
//   writes the float32 value.
// No atomics, so the value has the same bits from run to run on one card.
// Bound by bytes: every element read once, 4 bytes, 267 MB at the bench
// atlas, 0.080 ms at 3.35 TB/s. The partials are the caller's scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;

struct Table {
  float* p[kMaxLayers];
  const float* g[kMaxLayers];
  float* m[kMaxLayers];
  float* v[kMaxLayers];
  long long n[kMaxLayers];  // elements
  float c[kMaxLayers];      // the regularizer's gradient coefficient, or 0
  int count;
};

struct SquareTable {
  const float* p[kMaxLayers];
  long long n[kMaxLayers];  // elements
  double s[kMaxLayers];     // the weight over the full layer's size
  int count;
};

struct Consts {
  float b1, a1, b2, a2, eps, lo, hi;  // a1 = 1 - b1, a2 = 1 - b2
};

__device__ __forceinline__ void adam_clamp(float& p, float g, float& m,
                                           float& v, float reg, float lr,
                                           float bc1, float bc2,
                                           const Consts& c) {
  if (reg != 0.f) g = __fadd_rn(g, __fmul_rn(reg, p));
  m = fmaf(c.a1, g, __fmul_rn(m, c.b1));
  v = fmaf(c.a2, __fmul_rn(g, g), __fmul_rn(v, c.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps);
  const float step = __fmul_rn(__fdiv_rn(m, bc1), lr);
  const float q = __fsub_rn(p, __fdiv_rn(step, denom));
  p = q < c.lo ? c.lo : (q > c.hi ? c.hi : q);
}

__global__ void __launch_bounds__(kThreads)
    adam_clamp_kernel(const Table t, const float* __restrict__ scalars,
                      const Consts c) {
  const float lr = scalars[0], bc1 = scalars[1], bc2 = scalars[2];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int l = 0; l < t.count; ++l) {
    const long long n = t.n[l], n4 = n >> 2;
    const float reg = t.c[l];
    float4* p4 = reinterpret_cast<float4*>(t.p[l]);
    const float4* g4 = reinterpret_cast<const float4*>(t.g[l]);
    float4* m4 = reinterpret_cast<float4*>(t.m[l]);
    float4* v4 = reinterpret_cast<float4*>(t.v[l]);
    for (long long i = first; i < n4; i += stride) {
      float4 p = p4[i], m = m4[i], v = v4[i];
      const float4 g = __ldg(g4 + i);
      adam_clamp(p.x, g.x, m.x, v.x, reg, lr, bc1, bc2, c);
      adam_clamp(p.y, g.y, m.y, v.y, reg, lr, bc1, bc2, c);
      adam_clamp(p.z, g.z, m.z, v.z, reg, lr, bc1, bc2, c);
      adam_clamp(p.w, g.w, m.w, v.w, reg, lr, bc1, bc2, c);
      p4[i] = p;
      m4[i] = m;
      v4[i] = v;
    }
    for (long long i = (n4 << 2) + first; i < n; i += stride) {
      float p = t.p[l][i], m = t.m[l][i], v = t.v[l][i];
      adam_clamp(p, __ldg(t.g[l] + i), m, v, reg, lr, bc1, bc2, c);
      t.p[l][i] = p;
      t.m[l][i] = m;
      t.v[l][i] = v;
    }
  }
}

// The block's sum of one double a thread, thread 0's to keep: warp shuffles
// then the warps' sums, in a fixed order.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    x = warps[0];
    for (int w = 1; w < kThreads / 32; ++w) x += warps[w];
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
    tex_reg_partials_kernel(const SquareTable t,
                            double* __restrict__ partials) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  double total = 0.0;
  for (int l = 0; l < t.count; ++l) {
    const long long n = t.n[l], n4 = n >> 2;
    const float4* p4 = reinterpret_cast<const float4*>(t.p[l]);
    double sum = 0.0;
    for (long long i = first; i < n4; i += stride) {
      const float4 p = __ldg(p4 + i);
      sum = fma((double)p.x, (double)p.x, sum);
      sum = fma((double)p.y, (double)p.y, sum);
      sum = fma((double)p.z, (double)p.z, sum);
      sum = fma((double)p.w, (double)p.w, sum);
    }
    for (long long i = (n4 << 2) + first; i < n; i += stride) {
      const double p = __ldg(t.p[l] + i);
      sum = fma(p, p, sum);
    }
    total = fma(t.s[l], sum, total);
  }
  total = block_sum(total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    tex_reg_finish_kernel(const double* __restrict__ partials, int count,
                          float* __restrict__ out) {
  double x = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) x += partials[i];
  x = block_sum(x);
  if (threadIdx.x == 0) *out = (float)x;
}

// Blocks of kThreads that fit on the card at once running ``kernel``.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, 0)) != cudaSuccess)
    return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

}  // namespace

// Adam and the clamp, in place, on n_layers (1..8) layers: ps[k], ms[k] and
// vs[k] updated from gs[k] + cs[k] * ps[k], each of ns[k] float32 elements,
// 16-byte aligned; scalars a device float32[3] {lr, bc1, bc2}. Returns the
// launch's cudaError_t.
extern "C" int stylemesh_adam_clamp(void* const* ps, void* const* gs,
                                    void* const* ms, void* const* vs,
                                    const long long* ns, const float* cs,
                                    int n_layers,
                                    const void* scalars, float b1, float a1,
                                    float b2, float a2, float eps, float lo,
                                    float hi, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || scalars == nullptr)
    return (int)cudaErrorInvalidValue;
  Table t = {};
  t.count = n_layers;
  long long vec = 0;  // the largest layer's 4-element groups, at least 1
  for (int k = 0; k < n_layers; ++k) {
    if (ns[k] < 0) return (int)cudaErrorInvalidValue;
    t.p[k] = (float*)ps[k];
    t.g[k] = (const float*)gs[k];
    t.m[k] = (float*)ms[k];
    t.v[k] = (float*)vs[k];
    t.n[k] = ns[k];
    t.c[k] = cs[k];
    const long long groups = (ns[k] + 3) / 4;
    vec = groups > vec ? groups : vec;
  }
  if (vec == 0) return 0;
  static int cache = 0;  // blocks that fit on the card
  if (cache == 0) {
    const cudaError_t err = resident_blocks(adam_clamp_kernel, &cache);
    if (err != cudaSuccess) return (int)err;
  }
  const long long want = (vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < cache ? want : cache);
  const Consts c = {b1, a1, b2, a2, eps, lo, hi};
  adam_clamp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, (const float*)scalars, c);
  return (int)cudaGetLastError();
}

// The texture regularizer's value, sum_k ss[k] * sum(ps[k]^2), into the
// device float out, for n_layers (1..8) layers of ns[k] float32 elements,
// 16-byte aligned; partials a device scratch of max_partials doubles (one a
// block). Two launches; returns the last error.
extern "C" int stylemesh_tex_reg_value(void* const* ps, const long long* ns,
                                       const double* ss, int n_layers,
                                       void* partials, int max_partials,
                                       void* out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || partials == nullptr ||
      max_partials < 1 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  SquareTable t = {};
  t.count = n_layers;
  long long vec = 1;  // the largest layer's 4-element groups, at least 1
  for (int k = 0; k < n_layers; ++k) {
    if (ns[k] < 0) return (int)cudaErrorInvalidValue;
    t.p[k] = (const float*)ps[k];
    t.n[k] = ns[k];
    t.s[k] = ss[k];
    const long long groups = (ns[k] + 3) / 4;
    vec = groups > vec ? groups : vec;
  }
  static int cache = 0;  // blocks that fit on the card
  if (cache == 0) {
    const cudaError_t err = resident_blocks(tex_reg_partials_kernel, &cache);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (vec + kThreads - 1) / kThreads;
  blocks = blocks < cache ? blocks : cache;
  blocks = blocks < max_partials ? blocks : max_partials;
  const cudaStream_t s = (cudaStream_t)stream;
  tex_reg_partials_kernel<<<(int)blocks, kThreads, 0, s>>>(
      t, (double*)partials);
  tex_reg_finish_kernel<<<1, kThreads, 0, s>>>((const double*)partials,
                                               (int)blocks, (float*)out);
  return (int)cudaGetLastError();
}

// The texture's update: Adam, then the clamp to the Gatys range, over every
// layer of the atlas in one launch.
//
// Replaces the TPU path's optax.adam and clamp_texture (an XLA fusion there;
// no pallas_call), which the port ran as eleven PyTorch elementwise kernels
// a layer. For each element of each layer, in float32 and in this order:
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
// bounds are launch constants.
//
// What bounds it on an H100: bytes. Every element of p, g, m and v is read
// once and p, m and v written once: 28 bytes an element, 1.87 GB a step at
// the bench atlas (4096^2 ... 512^2 x 3), 0.559 ms at 3.35 TB/s. The three
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
  int count;
};

struct Consts {
  float b1, a1, b2, a2, eps, lo, hi;  // a1 = 1 - b1, a2 = 1 - b2
};

__device__ __forceinline__ void adam_clamp(float& p, float g, float& m,
                                           float& v, float lr, float bc1,
                                           float bc2, const Consts& c) {
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
    float4* p4 = reinterpret_cast<float4*>(t.p[l]);
    const float4* g4 = reinterpret_cast<const float4*>(t.g[l]);
    float4* m4 = reinterpret_cast<float4*>(t.m[l]);
    float4* v4 = reinterpret_cast<float4*>(t.v[l]);
    for (long long i = first; i < n4; i += stride) {
      float4 p = p4[i], m = m4[i], v = v4[i];
      const float4 g = __ldg(g4 + i);
      adam_clamp(p.x, g.x, m.x, v.x, lr, bc1, bc2, c);
      adam_clamp(p.y, g.y, m.y, v.y, lr, bc1, bc2, c);
      adam_clamp(p.z, g.z, m.z, v.z, lr, bc1, bc2, c);
      adam_clamp(p.w, g.w, m.w, v.w, lr, bc1, bc2, c);
      p4[i] = p;
      m4[i] = m;
      v4[i] = v;
    }
    for (long long i = (n4 << 2) + first; i < n; i += stride) {
      float p = t.p[l][i], m = t.m[l][i], v = t.v[l][i];
      adam_clamp(p, __ldg(t.g[l] + i), m, v, lr, bc1, bc2, c);
      t.p[l][i] = p;
      t.m[l][i] = m;
      t.v[l][i] = v;
    }
  }
}

}  // namespace

// Adam and the clamp, in place, on n_layers (1..8) layers: ps[k], ms[k] and
// vs[k] updated from gs[k], each of ns[k] float32 elements, 16-byte aligned;
// scalars a device float32[3] {lr, bc1, bc2}. Returns the launch's
// cudaError_t.
extern "C" int stylemesh_adam_clamp(void* const* ps, void* const* gs,
                                    void* const* ms, void* const* vs,
                                    const long long* ns, int n_layers,
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
    const long long groups = (ns[k] + 3) / 4;
    vec = groups > vec ? groups : vec;
  }
  if (vec == 0) return 0;
  static int cache = 0;  // blocks that fit on the card
  if (cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaSuccess;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, adam_clamp_kernel, kThreads, 0)) != cudaSuccess)
      return (int)err;
    cache = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < cache ? want : cache);
  const Consts c = {b1, a1, b2, a2, eps, lo, hi};
  adam_clamp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, (const float*)scalars, c);
  return (int)cudaGetLastError();
}

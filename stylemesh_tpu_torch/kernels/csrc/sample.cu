// K1 / K2: bilinear texture gather and its scatter-add (splat) backward.
//
// Replaces the TPU kernels ops/splat_pallas.py::gather_pallas (_gather_kernel)
// and ops/splat_pallas.py::splat_pallas (_splat_kernel), reached through
// ops/grid_sample.py::grid_sample_planned_cf. The function is the one of
// ops/grid_sample.py::grid_sample / _scatter_add_grad: torch
// grid_sample(mode='bilinear', padding_mode='border', align_corners=True) of
// a channel-last [H, W, 3] float32 atlas layer, summed over the Laplacian
// layers of the texture.
//
// What bounds it on an H100: memory. Per pixel the gather reads 8 grid bytes,
// 4 corners x 12 texel bytes per layer and writes 12 bytes; there are ~30 flops
// per layer. Layer 0 of a 4096^2 atlas is 201 MB and does not fit the 50 MB
// L2, so the design does not rely on an L2-resident atlas: one thread per
// output pixel, the sum over all layers fused into one launch per pyramid
// level (the grid is read once and the output written once for all layers),
// and neighbouring threads on neighbouring pixels so that the texels a warp
// touches lie in a few cache lines. The 12-byte texel is not a 16-byte-aligned
// load; it is read as three scalar read-only loads.
//
// The splat is bound by the atomics: every pixel adds 4 corners x 3 channels
// per layer into a zeroed float32 gradient. A pixel whose cotangent is zero
// (masked out, or background) is skipped, which is exact, and so is a corner
// of weight zero (the border clamp and the (-1,-1) background); this keeps
// the many background pixels off texel (0,0). The sum is equal to the
// sequential scatter-add only up to summation order.
//
// Two modes, one template parameter of each kernel:
//   f32   the exact float32 function (grid_sample.py::grid_sample);
//   bf16  the TPU kernels' compute="bf16" numerics (splat_pallas.py
//         _window_onehots / _gather_kernel / _splat_kernel): both 1-D weights
//         are computed in float32 as the tent max(1 - |p - i|, 0) and rounded
//         to bf16; the gather rounds the texel values to bf16 and takes the
//         products and sums in float32; the splat rounds the cotangent, both
//         weights and the product row_w * g to bf16 and accumulates in
//         float32. A background pixel (grid exactly (-1, -1), the TPU
//         wrappers' analytic texel-(0,0) term) stays exact float32 in both.
// The TPU kernels' planned windows and residual lists were devices for the
// TPU's matrix unit and are not carried over.
//
// Banded form (a second template parameter, BANDED): atlas-sharded training
// splits every layer into row bands, one per rank, and replaces the TPU
// kernels' banded calls (ops/grid_sample.py::grid_sample_banded_cf, row0 and
// include_background=False). Layers.ptr/h then hold the rank's band
// [h, W, 3] of each layer, h_global the layer's full height and row0 the
// band's first row. The corners and weights are those of the full layer; a
// corner takes part only when its texel row lies in the band, at the
// band-local row. Each rank reads the whole grid (and, in the splat, the
// whole cotangent) but only its band's texels, so the work per rank is
// bound by the grid bytes, and the partials of all bands sum to the full
// function: the background's texel (0, 0) belongs to band 0. With
// BANDED = false the in-band tests are constants and the kernels are the
// unbanded K1/K2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SM_MAX_LAYERS 8

struct Layers {
  float* ptr[SM_MAX_LAYERS];
  int h[SM_MAX_LAYERS];  // rows of ptr[l]: the layer, or the band if BANDED
  int w[SM_MAX_LAYERS];
  int h_global[SM_MAX_LAYERS];  // BANDED: the full layer's rows
  int row0[SM_MAX_LAYERS];      // BANDED: the band's first row
  int n;
};

struct Corners {
  int i00, i01, i10, i11;  // flat texel indices
  int iy0, iy1;            // texel rows of the y0 / y1 corners
  float wx, wy;            // weights of the x1 / y1 corners
};

// BANDED: whether layer l's band holds the rows of the y0 / y1 corners, and
// the flat offset of the band's first texel; unbanded: the whole layer.
struct Band {
  bool in0, in1;
  int off;
};

template <bool BANDED>
__device__ __forceinline__ Band band_of(const Layers& layers, int l,
                                        const Corners& c) {
  Band b;
  if (BANDED) {
    int r0 = layers.row0[l], r1 = layers.row0[l] + layers.h[l];
    b.in0 = c.iy0 >= r0 && c.iy0 < r1;
    b.in1 = c.iy1 >= r0 && c.iy1 < r1;
    b.off = r0 * layers.w[l];
  } else {
    b.in0 = b.in1 = true;
    b.off = 0;
  }
  return b;
}

// ops/grid_sample.py::_corner_indices_weights: pix = (g + 1) / 2 * (size - 1),
// clamp the coordinate to [0, size - 1], floor, upper corner clamped. The
// coordinate math uses round-to-nearest intrinsics so that no fused
// multiply-add changes which texel the floor picks.
__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w) {
  float px = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.0f), 0.5f), (float)(w - 1));
  float py = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.0f), 0.5f), (float)(h - 1));
  px = fminf(fmaxf(px, 0.0f), (float)(w - 1));
  py = fminf(fmaxf(py, 0.0f), (float)(h - 1));
  int ix0 = (int)floorf(px);
  int iy0 = (int)floorf(py);
  int ix1 = min(ix0 + 1, w - 1);
  int iy1 = min(iy0 + 1, h - 1);
  Corners c;
  c.wx = __fsub_rn(px, (float)ix0);
  c.wy = __fsub_rn(py, (float)iy0);
  c.i00 = iy0 * w + ix0;
  c.i01 = iy0 * w + ix1;
  c.i10 = iy1 * w + ix0;
  c.i11 = iy1 * w + ix1;
  c.iy0 = iy0;
  c.iy1 = iy1;
  return c;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 mode: the weights of the lower / upper corner, the tent
// max(1 - |p - i|, 0) at i = floor(p) and floor(p) + 1, each rounded to bf16
__device__ __forceinline__ void tent_bf16(float frac, float* w0, float* w1) {
  float u = __fsub_rn(1.0f, frac);
  *w0 = bf16r(u);
  *w1 = bf16r(__fsub_rn(1.0f, u));
}

// a corner's texel channel, 0 outside the band
__device__ __forceinline__ float texel(const float* t, bool in, int idx,
                                       int ch) {
  return in ? __ldg(t + 3 * idx + ch) : 0.0f;
}

template <bool BF16, bool BANDED>
__global__ void __launch_bounds__(256) gather_kernel(
    const float2* __restrict__ grid, float* __restrict__ out, long long n,
    Layers layers) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float2 g = grid[i];
  const bool round = BF16 && !(g.x == -1.0f && g.y == -1.0f);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int l = 0; l < layers.n; ++l) {
    Corners c = corners(g.x, g.y, BANDED ? layers.h_global[l] : layers.h[l],
                        layers.w[l]);
    Band b = band_of<BANDED>(layers, l, c);
    if (!b.in0 && !b.in1) continue;
    const float* t = layers.ptr[l];
    const int i00 = c.i00 - b.off, i01 = c.i01 - b.off;
    const int i10 = c.i10 - b.off, i11 = c.i11 - b.off;
    float v[3];
    if (round) {
      // every product of two bf16 values is exact in float32, so the
      // x-interpolation is the same with or without a fused multiply-add;
      // the y-interpolation is written out unfused, as the plain version
      float ux, wx, uy, wy;
      tent_bf16(c.wx, &ux, &wx);
      tent_bf16(c.wy, &uy, &wy);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float v00 = bf16r(texel(t, b.in0, i00, ch));
        float v01 = bf16r(texel(t, b.in0, i01, ch));
        float v10 = bf16r(texel(t, b.in1, i10, ch));
        float v11 = bf16r(texel(t, b.in1, i11, ch));
        float top = __fadd_rn(v00 * ux, v01 * wx);
        float bot = __fadd_rn(v10 * ux, v11 * wx);
        v[ch] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
      }
    } else {
      float ux = 1.0f - c.wx, uy = 1.0f - c.wy;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float v00 = texel(t, b.in0, i00, ch);
        float v01 = texel(t, b.in0, i01, ch);
        float v10 = texel(t, b.in1, i10, ch);
        float v11 = texel(t, b.in1, i11, ch);
        float top = v00 * ux + v01 * c.wx;
        float bot = v10 * ux + v11 * c.wx;
        v[ch] = top * uy + bot * c.wy;
      }
    }
    a0 += v[0];
    a1 += v[1];
    a2 += v[2];
  }
  out[3 * i + 0] = a0;
  out[3 * i + 1] = a1;
  out[3 * i + 2] = a2;
}

// adds (g * wy_c) * wx_c, the order of _scatter_add_grad's
// g * (1 - wy) * (1 - wx); a corner of weight zero adds nothing and is skipped
__device__ __forceinline__ void add_corner(float* t, int idx, float wy_c,
                                           float wx_c, float g0, float g1,
                                           float g2) {
  if (wy_c == 0.0f || wx_c == 0.0f) return;
  atomicAdd(t + 3 * idx + 0, (g0 * wy_c) * wx_c);
  atomicAdd(t + 3 * idx + 1, (g1 * wy_c) * wx_c);
  atomicAdd(t + 3 * idx + 2, (g2 * wy_c) * wx_c);
}

// bf16 mode: adds bf16(wy_c * g) * wx_c with g, wy_c and wx_c already
// rounded to bf16 (the TPU kernel's bf16 row_w * g times the bf16 col_w, a
// product exact in float32)
__device__ __forceinline__ void add_corner_bf16(float* t, int idx, float wy_c,
                                                float wx_c, float g0, float g1,
                                                float g2) {
  if (wy_c == 0.0f || wx_c == 0.0f) return;
  atomicAdd(t + 3 * idx + 0, bf16r(wy_c * g0) * wx_c);
  atomicAdd(t + 3 * idx + 1, bf16r(wy_c * g1) * wx_c);
  atomicAdd(t + 3 * idx + 2, bf16r(wy_c * g2) * wx_c);
}

template <bool BF16, bool BANDED>
__global__ void __launch_bounds__(256) splat_kernel(
    const float2* __restrict__ grid, const float* __restrict__ cot,
    long long n, Layers grads) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float g0 = cot[3 * i + 0], g1 = cot[3 * i + 1], g2 = cot[3 * i + 2];
  if (g0 == 0.0f && g1 == 0.0f && g2 == 0.0f) return;
  float2 g = grid[i];
  const bool round = BF16 && !(g.x == -1.0f && g.y == -1.0f);
  if (round) {
    g0 = bf16r(g0);
    g1 = bf16r(g1);
    g2 = bf16r(g2);
  }
  for (int l = 0; l < grads.n; ++l) {
    Corners c = corners(g.x, g.y, BANDED ? grads.h_global[l] : grads.h[l],
                        grads.w[l]);
    Band b = band_of<BANDED>(grads, l, c);
    float* t = grads.ptr[l];
    const int i00 = c.i00 - b.off, i01 = c.i01 - b.off;
    const int i10 = c.i10 - b.off, i11 = c.i11 - b.off;
    if (round) {
      float ux, wx, uy, wy;
      tent_bf16(c.wx, &ux, &wx);
      tent_bf16(c.wy, &uy, &wy);
      if (b.in0) {
        add_corner_bf16(t, i00, uy, ux, g0, g1, g2);
        add_corner_bf16(t, i01, uy, wx, g0, g1, g2);
      }
      if (b.in1) {
        add_corner_bf16(t, i10, wy, ux, g0, g1, g2);
        add_corner_bf16(t, i11, wy, wx, g0, g1, g2);
      }
    } else {
      float ux = 1.0f - c.wx, uy = 1.0f - c.wy;
      if (b.in0) {
        add_corner(t, i00, uy, ux, g0, g1, g2);
        add_corner(t, i01, uy, c.wx, g0, g1, g2);
      }
      if (b.in1) {
        add_corner(t, i10, c.wy, ux, g0, g1, g2);
        add_corner(t, i11, c.wy, c.wx, g0, g1, g2);
      }
    }
  }
}

static Layers make_layers(void* const* ptrs, const int* hs, const int* ws,
                          int n_layers, const int* h_globals = nullptr,
                          const int* row0s = nullptr) {
  Layers l;
  l.n = n_layers;
  for (int i = 0; i < SM_MAX_LAYERS; ++i) {
    bool used = i < n_layers;
    l.ptr[i] = used ? (float*)ptrs[i] : nullptr;
    l.h[i] = used ? hs[i] : 0;
    l.w[i] = used ? ws[i] : 0;
    l.h_global[i] = used && h_globals ? h_globals[i] : l.h[i];
    l.row0[i] = used && row0s ? row0s[i] : 0;
  }
  return l;
}

template <bool BANDED>
static int launch_gather(const void* grid, void* out, long long n_px,
                         const Layers& layers, int bf16, void* stream) {
  if (n_px == 0) return 0;
  unsigned blocks = (unsigned)((n_px + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    gather_kernel<true, BANDED><<<blocks, 256, 0, st>>>(
        (const float2*)grid, (float*)out, n_px, layers);
  else
    gather_kernel<false, BANDED><<<blocks, 256, 0, st>>>(
        (const float2*)grid, (float*)out, n_px, layers);
  return (int)cudaGetLastError();
}

template <bool BANDED>
static int launch_splat(const void* grid, const void* cot, long long n_px,
                        const Layers& grads, int bf16, void* stream) {
  if (n_px == 0) return 0;
  unsigned blocks = (unsigned)((n_px + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    splat_kernel<true, BANDED><<<blocks, 256, 0, st>>>(
        (const float2*)grid, (const float*)cot, n_px, grads);
  else
    splat_kernel<false, BANDED><<<blocks, 256, 0, st>>>(
        (const float2*)grid, (const float*)cot, n_px, grads);
  return (int)cudaGetLastError();
}

// bf16: 0 = the exact float32 function, 1 = the bf16 mode
extern "C" int stylemesh_gather(const void* grid, void* out, long long n_px,
                                void* const* layer_ptrs, const int* hs,
                                const int* ws, int n_layers, int bf16,
                                void* stream) {
  if (n_layers < 1 || n_layers > SM_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  return launch_gather<false>(grid, out, n_px,
                              make_layers(layer_ptrs, hs, ws, n_layers), bf16,
                              stream);
}

extern "C" int stylemesh_splat(const void* grid, const void* cot,
                               long long n_px, void* const* grad_ptrs,
                               const int* hs, const int* ws, int n_layers,
                               int bf16, void* stream) {
  if (n_layers < 1 || n_layers > SM_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  return launch_splat<false>(grid, cot, n_px,
                             make_layers(grad_ptrs, hs, ws, n_layers), bf16,
                             stream);
}

// band_hs: rows of each band; h_globals: rows of each full layer; row0s:
// each band's first row (0 <= row0, row0 + band_h <= h_global)
extern "C" int stylemesh_gather_banded(const void* grid, void* out,
                                       long long n_px, void* const* band_ptrs,
                                       const int* band_hs, const int* ws,
                                       const int* h_globals, const int* row0s,
                                       int n_layers, int bf16, void* stream) {
  if (n_layers < 1 || n_layers > SM_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  return launch_gather<true>(
      grid, out, n_px,
      make_layers(band_ptrs, band_hs, ws, n_layers, h_globals, row0s), bf16,
      stream);
}

extern "C" int stylemesh_splat_banded(const void* grid, const void* cot,
                                      long long n_px, void* const* grad_ptrs,
                                      const int* band_hs, const int* ws,
                                      const int* h_globals, const int* row0s,
                                      int n_layers, int bf16, void* stream) {
  if (n_layers < 1 || n_layers > SM_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  return launch_splat<true>(
      grid, cot, n_px,
      make_layers(grad_ptrs, band_hs, ws, n_layers, h_globals, row0s), bf16,
      stream);
}

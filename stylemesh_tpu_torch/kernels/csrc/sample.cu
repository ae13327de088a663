// K1 / K2: bilinear texture gather and its scatter-add (splat) backward, each
// one launch per train step over every pyramid level.
//
// Replaces the TPU kernels ops/splat_pallas.py::gather_pallas (_gather_kernel)
// and ops/splat_pallas.py::splat_pallas (_splat_kernel), reached through
// ops/grid_sample.py::grid_sample_planned_cf. The function is the one of
// ops/grid_sample.py::grid_sample / _scatter_add_grad: torch
// grid_sample(mode='bilinear', padding_mode='border', align_corners=True) of
// a channel-last [H, W, 3] float32 atlas layer, summed over the Laplacian
// layers of the texture, at each of a step's UV pyramid levels. The JAX
// package samples each level on its own and lets XLA add the levels'
// gradients; here one K1 launch renders every level, and one K2 launch
// splats every level's cotangent into one zeroed gradient per layer, so the
// dense gradient is filled and written once a step and nothing adds
// per-level gradients afterwards.
//
// Level table: the blocks of a launch walk the levels in order, each block
// a run of 256 consecutive pixels of one level (2-D tiles of 32x8, 16x16 and
// 8x32 pixels were 1-5% slower at the bench shapes on an H100, for both
// kernels). tile0 holds the prefix sums of the levels' blocks, so a block
// finds its level by a scan of at most SM_MAX_LEVELS entries. A level of
// zero pixels has no block.
//
// What bounds them on an H100: memory and, for the splat, the atomics. Per
// pixel the gather reads 8 grid bytes and 4 corners x 12 texel bytes per
// layer and writes 12 bytes; there are ~30 flops per layer. Layer 0 of a
// 4096^2 atlas is 201 MB and does not fit the 50 MB L2, so the design does
// not rely on an L2-resident atlas: one thread per output pixel, the sum over
// all layers in the thread (the grid is read once and the output written
// once for all layers), neighbouring threads on neighbouring pixels so that
// the texels a warp touches lie in a few cache lines. A 12-byte texel is not
// a 16-byte-aligned load; it is read as one 8-byte-aligned pair and one
// scalar (load_texel), two load instructions instead of three.
//
// The splat adds 4 corners x 3 channels per layer per pixel into float32
// gradients. A pixel whose cotangent is zero (masked out, or background) is
// skipped, which is exact, and so is a corner of weight zero (the border
// clamp and the (-1,-1) background); this keeps the many background pixels
// off texel (0,0). Each corner's add is one float2 vector atomic on the
// texel's 8-byte-aligned pair and one scalar atomic (red_texel), two atomic
// instructions instead of three. Where a texel covers several screen
// pixels (the coarse layers), several lanes of a warp add into one texel,
// and the L2 would serialise their atomics: on every layer, the lanes of a
// warp that share a corner's texel (__match_any_sync on its flat index) sum
// their contributions by shuffles in a fixed tree over their lane order, and
// the group's first lane alone issues the atomics (splat_corner). At the
// bench shapes on an H100 this took the 512^2 layer's time from 0.152 to
// 0.085 ms and the 1024^2 layer's from 0.141 to 0.109-0.130, cost nothing
// measurable on the 4096^2 layer and 1.5% on the 2048^2 one, and so beat
// aggregating only where a layer has fewer texels than the level has pixels
// per view (0.546 against 0.590 ms for all four layers; PERF.md). The sum
// equals the sequential scatter-add only up to summation order, as with
// plain atomics.
//
// Two modes, one template parameter of each kernel:
//   f32   the exact float32 function (grid_sample.py::grid_sample);
//   bf16  the TPU kernels' compute="bf16" numerics (splat_pallas.py
//         _window_onehots / _gather_kernel / _splat_kernel): both 1-D weights
//         are computed in float32 as the tent max(1 - |p - i|, 0) and rounded
//         to bf16; the gather rounds the texel values to bf16 and takes the
//         products and sums in float32; the splat rounds the cotangent, both
//         weights and each contribution's product row_w * g to bf16 and
//         accumulates in float32 (a warp group sums the same float32
//         products). A background pixel (grid exactly (-1, -1), the TPU
//         wrappers' analytic texel-(0,0) term) stays exact float32 in both.
// The TPU kernels' planned windows and residual lists were devices for the
// TPU's matrix unit and are not carried over.
//
// Banded form (a second template parameter, BANDED; the C entries take it
// when row0s is given): atlas-sharded training splits every layer into row
// bands, one per rank, and replaces the TPU kernels' banded calls
// (ops/grid_sample.py::grid_sample_banded_cf, row0 and
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
#include <limits.h>
#include <stdint.h>

#define SM_MAX_LAYERS 8
#define SM_MAX_LEVELS 8
#define SM_THREADS 256

struct Layers {
  float* ptr[SM_MAX_LAYERS];
  int h[SM_MAX_LAYERS];  // rows of ptr[l]: the layer, or the band if BANDED
  int w[SM_MAX_LAYERS];
  int h_global[SM_MAX_LAYERS];  // BANDED: the full layer's rows
  int row0[SM_MAX_LAYERS];      // BANDED: the band's first row
  int n;
};

struct Levels {
  const float2* grid[SM_MAX_LEVELS];
  float* px[SM_MAX_LEVELS];  // K1: the output [npx, 3]; K2: the cotangent
  int npx[SM_MAX_LEVELS];
  int tile0[SM_MAX_LEVELS + 1];  // first block of each level; [n..] all blocks
  int n;
};

struct Pixel {
  int level;
  long long i;  // flat pixel index within the level
  bool valid;
};

// this thread's pixel: the block's level and run, the thread's place in it
__device__ __forceinline__ Pixel pixel_of(const Levels& lv) {
  const int b = blockIdx.x;
  int l = 0;
  while (b >= lv.tile0[l + 1]) ++l;
  Pixel p;
  p.level = l;
  p.i = (long long)(b - lv.tile0[l]) * SM_THREADS + threadIdx.x;
  p.valid = p.i < lv.npx[l];
  return p;
}

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

// A 12-byte texel (or pixel) i of a [.., 3] float32 array whose base is
// 8-byte aligned: one aligned pair and one scalar. Even i: channels 0-1 at
// byte 12 i, channel 2 after them; odd i: channel 0 at byte 12 i, channels
// 1-2 at 12 i + 4.
__device__ __forceinline__ void load_texel(const float* t, int i, float v[3]) {
  const int odd = i & 1;
  const float* p = t + 3 * i;
  const float2 pr = __ldg(reinterpret_cast<const float2*>(p + odd));
  const float s = __ldg(p + 2 - 2 * odd);
  v[0] = odd ? s : pr.x;
  v[1] = odd ? pr.x : pr.y;
  v[2] = odd ? pr.y : s;
}

__device__ __forceinline__ void load_px(const float* t, long long i,
                                        float v[3]) {
  const int odd = (int)(i & 1);
  const float* p = t + 3 * i;
  const float2 pr = *reinterpret_cast<const float2*>(p + odd);
  const float s = p[2 - 2 * odd];
  v[0] = odd ? s : pr.x;
  v[1] = odd ? pr.x : pr.y;
  v[2] = odd ? pr.y : s;
}

__device__ __forceinline__ void store_px(float* t, long long i, float a0,
                                         float a1, float a2) {
  const int odd = (int)(i & 1);
  float* p = t + 3 * i;
  *reinterpret_cast<float2*>(p + odd) =
      odd ? make_float2(a1, a2) : make_float2(a0, a1);
  p[2 - 2 * odd] = odd ? a0 : a2;
}

// a corner's texel, 0 outside the band
__device__ __forceinline__ void corner_texel(const float* t, bool in, int i,
                                             float v[3]) {
  if (in) {
    load_texel(t, i, v);
  } else {
    v[0] = v[1] = v[2] = 0.0f;
  }
}

template <bool BF16, bool BANDED>
__global__ void __launch_bounds__(SM_THREADS) gather_kernel(Levels lv,
                                                            Layers layers) {
  const Pixel p = pixel_of(lv);
  if (!p.valid) return;
  const float2 g = lv.grid[p.level][p.i];
  const bool round = BF16 && !(g.x == -1.0f && g.y == -1.0f);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int l = 0; l < layers.n; ++l) {
    Corners c = corners(g.x, g.y, BANDED ? layers.h_global[l] : layers.h[l],
                        layers.w[l]);
    Band b = band_of<BANDED>(layers, l, c);
    if (!b.in0 && !b.in1) continue;
    const float* t = layers.ptr[l];
    float v00[3], v01[3], v10[3], v11[3];
    corner_texel(t, b.in0, c.i00 - b.off, v00);
    corner_texel(t, b.in0, c.i01 - b.off, v01);
    corner_texel(t, b.in1, c.i10 - b.off, v10);
    corner_texel(t, b.in1, c.i11 - b.off, v11);
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
        float top = __fadd_rn(bf16r(v00[ch]) * ux, bf16r(v01[ch]) * wx);
        float bot = __fadd_rn(bf16r(v10[ch]) * ux, bf16r(v11[ch]) * wx);
        v[ch] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
      }
    } else {
      float ux = 1.0f - c.wx, uy = 1.0f - c.wy;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float top = v00[ch] * ux + v01[ch] * c.wx;
        float bot = v10[ch] * ux + v11[ch] * c.wx;
        v[ch] = top * uy + bot * c.wy;
      }
    }
    a0 += v[0];
    a1 += v[1];
    a2 += v[2];
  }
  store_px(lv.px[p.level], p.i, a0, a1, a2);
}

// adds (c0, c1, c2) to texel i: one float2 atomic on its 8-byte-aligned
// pair, one scalar atomic on the other channel (load_texel's split)
__device__ __forceinline__ void red_texel(float* t, int i, float c0, float c1,
                                          float c2) {
  const int odd = i & 1;
  float* p = t + 3 * i;
  atomicAdd(reinterpret_cast<float2*>(p + odd),
            odd ? make_float2(c1, c2) : make_float2(c0, c1));
  atomicAdd(p + 2 - 2 * odd, odd ? c0 : c2);
}

// Sums (x0, x1, x2) over the lanes of `peers` (this lane's group of `lanes`)
// onto the group's first lane: a tree over the group's lane order, log2 of
// the group's size rounds, each lane adding its next remaining peer's sum.
__device__ __forceinline__ void reduce_group(unsigned lanes, unsigned peers,
                                             float& x0, float& x1, float& x2) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~(0xffffffffu >> (31 - lane));
  while (__any_sync(lanes, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, 0 if none
    const int src = next ? next - 1 : lane;
    const float t0 = __shfl_sync(lanes, x0, src);
    const float t1 = __shfl_sync(lanes, x1, src);
    const float t2 = __shfl_sync(lanes, x2, src);
    if (next) {
      x0 += t0;
      x1 += t1;
      x2 += t2;
    }
    above &= ~__ballot_sync(lanes, rank & 1);  // peers whose sum was taken
    rank >>= 1;
  }
}

// One corner of one layer for this pixel: adds (g * wr) * wc, in the bf16
// mode bf16(wr * g) * wc (g, wr and wc already rounded: the TPU kernel's bf16
// row_w * g times the bf16 col_w, a product exact in float32), to texel i;
// a corner of weight zero or outside the band adds nothing. Every lane of
// `lanes` calls this together, and the lanes adding into one texel send one
// sum.
template <bool BF16>
__device__ __forceinline__ void splat_corner(float* t, bool in, int i, float wr,
                                             float wc, bool round, float g0,
                                             float g1, float g2,
                                             unsigned lanes) {
  const bool use = in && wr != 0.0f && wc != 0.0f;
  float c0 = g0 * wr, c1 = g1 * wr, c2 = g2 * wr;
  if (BF16 && round) {
    c0 = bf16r(c0);
    c1 = bf16r(c1);
    c2 = bf16r(c2);
  }
  c0 *= wc;
  c1 *= wc;
  c2 *= wc;
  const int lane = threadIdx.x & 31;
  // a lane that adds nothing gets a key of its own
  const unsigned peers = __match_any_sync(lanes, use ? i : -1 - lane);
  reduce_group(lanes, peers, c0, c1, c2);
  if (peers & ((1u << lane) - 1u)) return;  // not the group's first lane
  if (use) red_texel(t, i, c0, c1, c2);
}

template <bool BF16, bool BANDED>
__global__ void __launch_bounds__(SM_THREADS) splat_kernel(Levels lv,
                                                           Layers grads) {
  const Pixel p = pixel_of(lv);
  float gv[3] = {0.0f, 0.0f, 0.0f};
  if (p.valid) load_px(lv.px[p.level], p.i, gv);
  const bool live = p.valid && !(gv[0] == 0.0f && gv[1] == 0.0f &&
                                 gv[2] == 0.0f);
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  if (!live) return;
  const float2 g = lv.grid[p.level][p.i];
  const bool round = BF16 && !(g.x == -1.0f && g.y == -1.0f);
  float g0 = gv[0], g1 = gv[1], g2 = gv[2];
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
    float ux, wx, uy, wy;
    if (round) {
      tent_bf16(c.wx, &ux, &wx);
      tent_bf16(c.wy, &uy, &wy);
    } else {
      wx = c.wx;
      wy = c.wy;
      ux = 1.0f - c.wx;
      uy = 1.0f - c.wy;
    }
    splat_corner<BF16>(t, b.in0, c.i00 - b.off, uy, ux, round, g0, g1, g2,
                       lanes);
    splat_corner<BF16>(t, b.in0, c.i01 - b.off, uy, wx, round, g0, g1, g2,
                       lanes);
    splat_corner<BF16>(t, b.in1, c.i10 - b.off, wy, ux, round, g0, g1, g2,
                       lanes);
    splat_corner<BF16>(t, b.in1, c.i11 - b.off, wy, wx, round, g0, g1, g2,
                       lanes);
  }
}

static Layers make_layers(void* const* ptrs, const int* hs, const int* ws,
                          int n_layers, const int* h_globals,
                          const int* row0s) {
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

// the level table; returns the number of blocks, or -1 for a table the
// kernels do not take
static long long make_levels(Levels* lv, void* const* grids, void* const* pxs,
                             const int* npxs, int n_levels) {
  if (n_levels < 1 || n_levels > SM_MAX_LEVELS) return -1;
  long long tiles = 0;
  lv->n = n_levels;
  for (int i = 0; i < SM_MAX_LEVELS; ++i) {
    const bool used = i < n_levels;
    if (used && npxs[i] < 0) return -1;
    lv->grid[i] = used ? (const float2*)grids[i] : nullptr;
    lv->px[i] = used ? (float*)pxs[i] : nullptr;
    lv->npx[i] = used ? npxs[i] : 0;
    lv->tile0[i] = (int)tiles;
    tiles += ((long long)lv->npx[i] + SM_THREADS - 1) / SM_THREADS;
    if (tiles > INT_MAX) return -1;
  }
  lv->tile0[SM_MAX_LEVELS] = (int)tiles;
  return tiles;
}

template <bool BANDED>
static int launch_gather(const Levels& lv, long long blocks,
                         const Layers& layers, int bf16, cudaStream_t st) {
  if (bf16)
    gather_kernel<true, BANDED><<<(unsigned)blocks, SM_THREADS, 0, st>>>(
        lv, layers);
  else
    gather_kernel<false, BANDED><<<(unsigned)blocks, SM_THREADS, 0, st>>>(
        lv, layers);
  return (int)cudaGetLastError();
}

template <bool BANDED>
static int launch_splat(const Levels& lv, long long blocks,
                        const Layers& grads, int bf16, cudaStream_t st) {
  if (bf16)
    splat_kernel<true, BANDED><<<(unsigned)blocks, SM_THREADS, 0, st>>>(
        lv, grads);
  else
    splat_kernel<false, BANDED><<<(unsigned)blocks, SM_THREADS, 0, st>>>(
        lv, grads);
  return (int)cudaGetLastError();
}

// K1 over a level table: for each level k, outs[k] [npxs[k], 3] = sum over
// the layers of the bilinear sample at grids[k] [npxs[k], 2].
// Layers: ptrs / hs / ws; banded when row0s is given (band_hs in hs, each
// full layer's rows in h_globals; 0 <= row0, row0 + band_h <= h_global).
// bf16: 0 = the exact float32 function, 1 = the bf16 mode.
extern "C" int stylemesh_gather(void* const* grids, void* const* outs,
                                const int* npxs, int n_levels,
                                void* const* layer_ptrs,
                                const int* hs, const int* ws,
                                const int* h_globals, const int* row0s,
                                int n_layers, int bf16, void* stream) {
  if (n_layers < 1 || n_layers > SM_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  Levels lv;
  long long blocks = make_levels(&lv, grids, outs, npxs, n_levels);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  Layers layers = make_layers(layer_ptrs, hs, ws, n_layers, h_globals, row0s);
  cudaStream_t st = (cudaStream_t)stream;
  return row0s ? launch_gather<true>(lv, blocks, layers, bf16, st)
               : launch_gather<false>(lv, blocks, layers, bf16, st);
}

// K2 over a level table: adds every level's splat of its cotangent cots[k]
// into the zeroed gradients grad_ptrs (one per layer, or band when row0s is
// given, as in stylemesh_gather).
extern "C" int stylemesh_splat(void* const* grids, void* const* cots,
                               const int* npxs, int n_levels,
                               void* const* grad_ptrs,
                               const int* hs, const int* ws,
                               const int* h_globals, const int* row0s,
                               int n_layers, int bf16, void* stream) {
  if (n_layers < 1 || n_layers > SM_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  Levels lv;
  long long blocks = make_levels(&lv, grids, cots, npxs, n_levels);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  Layers grads = make_layers(grad_ptrs, hs, ws, n_layers, h_globals, row0s);
  cudaStream_t st = (cudaStream_t)stream;
  return row0s ? launch_splat<true>(lv, blocks, grads, bf16, st)
               : launch_splat<false>(lv, blocks, grads, bf16, st);
}

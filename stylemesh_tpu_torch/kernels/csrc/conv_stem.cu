// conv1_1, the VGG trunk's 3 -> 64 channel stem: its forward and its input
// gradient, each one launch.
//
// Replaces the TPU path's explicit im2col product
//   ops/conv_im2col.py::conv3x3_im2col (an XLA matmul over nine stacked
//   shifted copies, and nine shifted adds in its VJP; no pallas_call):
//   y  = bf16(act(conv3x3(x, w) + b)),       act = relu or identity,
//   dx = bf16(sum_taps sum_co [y > 0] g w)    (the mask only with relu),
// with x bf16 [V, H, W, 3], y and g bf16 [V, H, W, 64], w the bf16 matrix
// w9 [27, 64] whose rows run in (dy, dx, ci) order, b float32 [64] or NULL.
// Stride 1, SAME zero padding. The numerics are the plain version's: bf16
// operands, float32 products and sums, the float32 bias, relu, one rounding
// to bf16; only the order of the float32 sums differs.
//
// What bounds it on an H100: bytes. A direction is 6.6 M pixels x 27 x 64
// multiply-adds at the bench step, far below the tensor cores' rate, while
// the 64-channel side (y written forward; g and y read backward) is 128
// bytes a pixel and the 3-channel side 6. The design keeps every byte of
// the wide side moving once, in 16-byte accesses, and nothing else in
// device memory:
// - Implicit GEMM on mma.sync (m16n8k16, bf16 in, float32 accumulators):
//   M is 16 consecutive pixels of one row, K the 27 taps x channels padded
//   to 32 (forward) or one tap x 16 output channels (input gradient, nine
//   taps x 64 channels), N the 64 output channels (forward) or the 3 input
//   channels padded to 8. Tensor cores, not float32 FMAs on the CUDA cores,
//   because 11.4 G multiply-adds a direction at the CUDA cores' 34 T/s
//   would alone take 0.34 ms, above the forward's byte bound of 0.26 ms.
// - A block tile is rows x columns of one image with a one-pixel halo in
//   shared memory, zero outside the map (the SAME padding); neighbouring
//   tiles share their halos' rows, mostly through L2. Forward: 8 x 64
//   pixels, the 3-channel input halo; each warp one row of 64 pixels; the
//   A fragments are gathered from the halo per tap. Input gradient: 8 x 32
//   pixels, the 64-channel cotangent halo masked by y > 0 as it is loaded
//   (128 bytes a pixel, 16-byte chunks swizzled by pixel so that ldmatrix
//   reads eight pixels without bank conflicts); each warp one row of 32
//   pixels, A read by ldmatrix at the tap's shift.
// - Forward epilogue in registers (float32 bias, relu, one rounding), then
//   through a swizzled per-warp buffer so that each pixel's 128 bytes go
//   out as 16-byte stores of whole lines.
// - w9 is read as stored, into shared memory: the forward lays its B
//   fragments out there once, in lane order; the input gradient reads its
//   pairs of output channels from the rows of w9.
// - Persistent grids: as many blocks as fit on the card walk the tiles.
//   The forward loads the next tile's halo into registers while it
//   computes the current one.
// Nothing is allocated and nothing synchronizes the host: the wrapper
// allocates y and dx, and the launch goes on PyTorch's current stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCin = 3, kCout = 64, kK = 9 * kCin;  // w9 is [kK, kCout]
constexpr int kThreads = 256, kWarps = kThreads / 32;

constexpr int kFH = 8, kFW = 64;        // forward tile: a warp per row
constexpr int kFXW = kFW + 2;           // its halo's width
constexpr int kFX = (kFH + 2) * kFXW * kCin;  // halo elements

constexpr int kGH = 8, kGW = 32;        // input-gradient tile: a warp per row
constexpr int kGXW = kGW + 2;
constexpr int kGPix = (kGH + 2) * kGXW;  // halo pixels, 128 bytes each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a b: m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// g's two bf16 halves where y's half is > 0 (as a float: NaN and -0 fail).
__device__ __forceinline__ uint32_t relu_mask(uint32_t g, uint32_t y) {
  const uint32_t lo = __uint_as_float(y << 16) > 0.f ? 0x0000ffffu : 0u;
  const uint32_t hi = __uint_as_float(y & 0xffff0000u) > 0.f ? 0xffff0000u : 0u;
  return g & (lo | hi);
}

// Tile t of a map cut in th x tw tiles: image, first row, first column.
struct TilePos {
  int img, r0, c0;
};

__device__ __forceinline__ TilePos tile_pos(int tile, int tiles_w, int tiles_img,
                                            int th, int tw) {
  const int img = tile / tiles_img, rem = tile - img * tiles_img;
  const int tr = rem / tiles_w;
  return {img, tr * th, (rem - tr * tiles_w) * tw};
}

__global__ void __launch_bounds__(kThreads, 3) stem_conv_gemm_fwd_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w9,
    const float* __restrict__ bias, uint16_t* __restrict__ y, int H, int W,
    int relu, int tiles_w, int tiles_img, int tiles) {
  constexpr int kPer = (kFX + kThreads - 1) / kThreads;  // halo elements a thread
  __shared__ uint16_t xs[kFX];
  __shared__ __align__(16) uint2 bfrag[2][8][32];
  __shared__ __align__(16) float bs[kCout];
  __shared__ __align__(16) uint8_t stage[kWarps][16 * 128];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group, thread

  // B fragments, built once through the (then idle) stage buffers: k-step
  // s (k = 16 s ..), n tile j, lane l: the pairs (k, k + 1) of column n for
  // k = 16 s + 2 (l % 4) and k + 8, n = 8 j + l / 4; rows from 27 on are 0
  uint16_t* ws = reinterpret_cast<uint16_t*>(&stage[0][0]);
  for (int i = tid; i < kK * kCout; i += kThreads) ws[i] = w9[i];
  if (tid < kCout) bs[tid] = bias ? bias[tid] : 0.f;
  __syncthreads();
  for (int i = tid; i < 2 * 8 * 32; i += kThreads) {
    const int s = i >> 8, j = (i >> 5) & 7, l = i & 31, n = 8 * j + (l >> 2);
    uint32_t r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * s + 8 * h + 2 * (l & 3);
      const uint32_t lo = k < kK ? ws[k * kCout + n] : 0u;
      const uint32_t hi = k + 1 < kK ? ws[(k + 1) * kCout + n] : 0u;
      r[h] = lo | (hi << 16);
    }
    bfrag[s][j][l] = make_uint2(r[0], r[1]);
  }
  // A fragments: the halo offset of each k this thread holds (k = 16 s +
  // 8 (q >> 1) + 2 t + (q & 1)) from the pixel's own tap (0, 0); -1 past 27
  int ko[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * s + 8 * (q >> 1) + 2 * t + (q & 1);
      const int tap = k / kCin, ci = k - tap * kCin;
      ko[s][q] = k < kK ? ((tap / 3) * kFXW + tap % 3) * kCin + ci : -1;
    }
  uint8_t* st = stage[warp];

  // this thread's halo elements of a tile, zero outside the map; the next
  // tile's are loaded while the current one is computed
  uint16_t pre[kPer];
  auto load = [&](int tile) {
    const TilePos tp = tile_pos(tile, tiles_w, tiles_img, kFH, kFW);
    const uint16_t* xi = x + (size_t)tp.img * H * W * kCin;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * kThreads, p = e / kCin, ci = e - p * kCin;
      const int i = p / kFXW, r = tp.r0 - 1 + i, c = tp.c0 - 1 + (p - i * kFXW);
      pre[q] = (e < kFX && r >= 0 && r < H && c >= 0 && c < W)
                   ? xi[((size_t)r * W + c) * kCin + ci]
                   : (uint16_t)0;
    }
  };
  load(blockIdx.x);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TilePos tp = tile_pos(tile, tiles_w, tiles_img, kFH, kFW);
    __syncthreads();  // the last tile's reads of xs are done
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (tid + q * kThreads < kFX) xs[tid + q * kThreads] = pre[q];
    __syncthreads();
    if (tile + gridDim.x < tiles) load(tile + gridDim.x);
    const int row = tp.r0 + warp;
    if (row >= H) continue;
    uint16_t* yrow = y + ((size_t)tp.img * H + row) * W * kCout;
#pragma unroll 1
    for (int m0 = 0; m0 < kFW && tp.c0 + m0 < W; m0 += 16) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // pixels m0 + g and m0 + g + 8 of this row, at the halo's tap (0, 0)
      const int p0 = (warp * kFXW + m0 + g) * kCin, p1 = p0 + 8 * kCin;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t v[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = ko[s][q];
          v[0][q] = o >= 0 ? xs[p0 + o] : 0u;
          v[1][q] = o >= 0 ? xs[p1 + o] : 0u;
        }
        const uint32_t a[4] = {v[0][0] | (v[0][1] << 16), v[1][0] | (v[1][1] << 16),
                               v[0][2] | (v[0][3] << 16), v[1][2] | (v[1][3] << 16)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 b = bfrag[s][j][lane];
          mma16816(acc[j], a, b.x, b.y);
        }
      }
      // epilogue: rows g and g + 8, channels 8 j + 2 t, + 1; 16-byte chunk j
      // of a pixel's 128 bytes swizzled by the row (g == (g + 8) % 8)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
        float o[4] = {acc[j][0] + bj.x, acc[j][1] + bj.y, acc[j][2] + bj.x,
                      acc[j][3] + bj.y};
        if (relu) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = o[e] < 0.f ? 0.f : o[e];
        }
        const int off = ((j ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(st + g * 128 + off) = pack_bf16(o[0], o[1]);
        *reinterpret_cast<uint32_t*>(st + (g + 8) * 128 + off) = pack_bf16(o[2], o[3]);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int m = 4 * it + (lane >> 3), ch = lane & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(st + m * 128 + ((ch ^ (m & 7)) << 4));
        if (tp.c0 + m0 + m < W)
          *reinterpret_cast<uint4*>(yrow + (size_t)(tp.c0 + m0 + m) * kCout + ch * 8) = v;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4) stem_conv_gemm_bwd_kernel(
    const uint16_t* __restrict__ g, const uint16_t* __restrict__ y,
    const uint16_t* __restrict__ w9, uint16_t* __restrict__ dx, int H, int W,
    int relu, int tiles_w, int tiles_img, int tiles) {
  __shared__ __align__(16) uint8_t gs[kGPix * 128];
  __shared__ __align__(16) uint16_t ws[kK * kCout];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;  // the mma fragments' group, thread

  for (int i = tid; i < kK * kCout / 8; i += kThreads)
    reinterpret_cast<uint4*>(ws)[i] = reinterpret_cast<const uint4*>(w9)[i];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TilePos tp = tile_pos(tile, tiles_w, tiles_img, kGH, kGW);
    const size_t img0 = (size_t)tp.img * H * W;
    __syncthreads();  // w9 is in; the last tile's reads of gs are done
    // the masked cotangent on the halo: 16-byte chunk ch of pixel p at chunk
    // ch ^ (p % 8) of its row, zero outside the map
#pragma unroll 4
    for (int e = tid; e < kGPix * 8; e += kThreads) {
      const int p = e >> 3, ch = e & 7;
      const int i = p / kGXW, r = tp.r0 - 1 + i, c = tp.c0 - 1 + (p - i * kGXW);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < H && c >= 0 && c < W) {
        const size_t off = (img0 + (size_t)r * W + c) * kCout + ch * 8;
        v = __ldg(reinterpret_cast<const uint4*>(g + off));
        if (relu) {
          const uint4 m = __ldg(reinterpret_cast<const uint4*>(y + off));
          v = make_uint4(relu_mask(v.x, m.x), relu_mask(v.y, m.y),
                         relu_mask(v.z, m.z), relu_mask(v.w, m.w));
        }
      }
      *reinterpret_cast<uint4*>(gs + p * 128 + ((ch ^ (p & 7)) << 4)) = v;
    }
    __syncthreads();
    const int row = tp.r0 + warp;
    if (row >= H) continue;
    // dx at pixels m + 16 mt of this row: tap (dy, dx) reads the cotangent
    // at the pixel minus (dy - 1, dx - 1), halo row warp + 2 - dy
    float acc[2][4] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dxx = tap % 3;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // B: k = output channels 16 s + 2 t (+ 8), n = input channel gq
        uint32_t b0 = 0u, b1 = 0u;
        if (gq < kCin) {
          const uint16_t* wr = ws + (tap * kCin + gq) * kCout + 16 * s + 2 * t;
          b0 = *reinterpret_cast<const uint32_t*>(wr);
          b1 = *reinterpret_cast<const uint32_t*>(wr + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int p = (warp + 2 - dy) * kGXW + 16 * mt + (lane & 15) + 2 - dxx;
          const int ch = 2 * s + (lane >> 4);
          uint32_t a[4];
          ldmatrix_x4(a, smem_addr(gs + p * 128 + ((ch ^ (p & 7)) << 4)));
          mma16816(acc[mt], a, b0, b1);
        }
      }
    }
    // rows gq and gq + 8 hold channels 2 t, 2 t + 1: t = 0 has 0 and 1,
    // t = 1 has 2 (and the padding's 3)
    if (t < 2) {
      uint16_t* dxrow = dx + (img0 + (size_t)row * W) * kCin;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = tp.c0 + 16 * mt + gq + 8 * h;
          if (c >= W) continue;
          uint16_t* o = dxrow + (size_t)c * kCin + 2 * t;
          const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[mt][2 * h]);
          o[0] = *reinterpret_cast<const uint16_t*>(&v0);
          if (t == 0) {
            const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[mt][2 * h + 1]);
            o[1] = *reinterpret_cast<const uint16_t*>(&v1);
          }
        }
    }
  }
}

// The grid of a persistent kernel: as many blocks as fit on the card, at
// most `tiles`. `cache` keeps the count per kernel. 0 on an error (the
// status in `err`).
int persistent_grid(const void* kernel, int* cache, long long tiles,
                    cudaError_t* err) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
        (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess ||
        (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, 0)) != cudaSuccess)
      return 0;
    *cache = sms * (per_sm > 0 ? per_sm : 1);
  }
  return (int)(tiles < *cache ? tiles : *cache);
}

}  // namespace

// y = bf16(act(conv3x3(x, w9) + bias)) [V, H, W, 64] of x [V, H, W, 3],
// act = relu if `relu`; bias may be NULL. Returns the launch's cudaError_t.
extern "C" int stylemesh_stem_fwd(const void* x, const void* w9, const void* bias,
                                  void* y, int V, int H, int W, int relu,
                                  void* stream) {
  if (V < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  const int tiles_w = (W + kFW - 1) / kFW;
  const long long tiles_img = (long long)((H + kFH - 1) / kFH) * tiles_w;
  if (tiles_img * V > 0x7fffffff) return (int)cudaErrorInvalidValue;
  static int cache = 0;
  cudaError_t err = cudaSuccess;
  const int blocks = persistent_grid((const void*)stem_conv_gemm_fwd_kernel, &cache,
                                     tiles_img * V, &err);
  if (blocks == 0) return (int)err;
  stem_conv_gemm_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)w9, (const float*)bias, (uint16_t*)y,
      H, W, relu, tiles_w, (int)tiles_img, (int)(tiles_img * V));
  return (int)cudaGetLastError();
}

// dx = bf16(sum over taps and output channels of m g w9) [V, H, W, 3], m =
// [y > 0] if `relu` (y is then read; else it may be NULL) and 1 otherwise;
// g, y [V, H, W, 64]. Returns the launch's cudaError_t.
extern "C" int stylemesh_stem_bwd(const void* g, const void* y, const void* w9,
                                  void* dx, int V, int H, int W, int relu,
                                  void* stream) {
  if (V < 0 || H < 0 || W < 0 || (relu && y == nullptr))
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  const int tiles_w = (W + kGW - 1) / kGW;
  const long long tiles_img = (long long)((H + kGH - 1) / kGH) * tiles_w;
  if (tiles_img * V > 0x7fffffff) return (int)cudaErrorInvalidValue;
  static int cache = 0;
  cudaError_t err = cudaSuccess;
  const int blocks = persistent_grid((const void*)stem_conv_gemm_bwd_kernel, &cache,
                                     tiles_img * V, &err);
  if (blocks == 0) return (int)err;
  stem_conv_gemm_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)g, (const uint16_t*)y, (const uint16_t*)w9, (uint16_t*)dx,
      H, W, relu, tiles_w, (int)tiles_img, (int)(tiles_img * V));
  return (int)cudaGetLastError();
}

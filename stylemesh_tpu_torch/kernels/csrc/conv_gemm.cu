// K5 / K9 and K6 / K7: the bf16 VGG trunk's 3x3 convolution as an implicit
// GEMM on Hopper's warpgroup MMA (wgmma), fed by a TMA pipeline, with the
// bias, relu and, for the block tails, the 2x2 max pool in its epilogue.
//
// Replaces the TPU kernels
//   K5  ops/conv_pallas.py::_conv3x3_v2_raw (_conv_kernel_v2), reached through
//       conv3x3_v2: y = bf16(act(conv3x3(x, w) + b)), act = relu or identity;
//       also every trunk input gradient (flipped io-swapped kernel, b = 0,
//       relu off);
//   K9  ops/conv_pallas.py::conv3x3_mxu: y = bf16(conv3x3(x, w)), and its
//       conv3x3_frozen VJP. K9 is this entry with bias NULL and relu off, so
//       it equals K5 without bias and relu bit for bit;
//   K6  ops/head_pallas.py::conv_relu_pool (_kernel_packed, 64 channels, and
//       _kernel_direct, 128): p = maxpool2(bf16(relu(conv3x3(x, w) + b)));
//   K7  ops/head_pallas.py::conv_relu_pool_dual (_kernel_direct_dual): K6 that
//       also writes the pre-pool activation y.
// K6 and K7 are K5's kernel with a pool epilogue: the same mainloop
// (conv_core.cuh) at K5's N tile, so their pre-pool values are K5's relu
// output bit for bit and the pooled map is maxpool2 of it.
//
// Layouts: x bf16 [V, H, W, Cin] (channel-last), the kernel as the bf16
// matrix w9 [9 * Cin, Cout] with rows in (dy, dx, ci) order (an HWIO kernel
// reshaped), bias float32 [Cout] or NULL. Stride 1, SAME zero padding.
// Cin and Cout are multiples of 64. The pooled map is [V, H / 2, W / 2,
// Cout]; an odd tail row or column is a conv halo only.
//
// What bounds it on an H100: the tensor cores. A 3x3 conv does 18 * Cin
// flops per output value and moves ~2 * (Cin + Cout) bytes per pixel, far
// above the card's ~295 bf16 flops per HBM byte at 64 channels and more;
// and only wgmma reaches the full tensor-core rate. Next in line are the
// bytes each stage brings from L2 for its products, and the epilogue, in
// which the tensor cores wait. The design:
// - Implicit GEMM. M is a tile of 128 or 256 output pixels, a box of
//   BH x BW pixels of one image (the wrapper picks the box per layer so that
//   the ragged edge wastes little); N a 64-, 128- or 256-wide slice of Cout;
//   K = 9 taps x Cin in steps of one tap x 64 channels (128 bytes: one row
//   of the 128-byte swizzle). The wrapper takes the widest N that divides
//   Cout and, below N = 256, 256 pixels: the tile's bytes per product are
//   then those of 128 x 256.
// - Copies by TMA in a ring of stages. One producer thread keeps the ring
//   full: A is the input box shifted by the tap (dy - 1, dx - 1), a load
//   of a 4-D tensor map whose out-of-bounds zero fill is the SAME padding;
//   B is a 64 x 64 box of w9 as stored (N contiguous, read by wgmma with
//   its transpose bit). Full and empty mbarriers with expect_tx.
// - Two consumer warpgroups, one or two m64 blocks of pixels each, issue
//   m64nBNk16 wgmma on the swizzled shared tiles, keeping one group in
//   flight while the next stage arrives.
// - Epilogue in registers: the float32 bias, relu, one rounding to bf16 (the
//   TPU kernel's numerics). The bf16 values of each m64 block x 64 channels
//   go to a swizzled shared buffer (two per warpgroup, in turn) that one
//   thread stores by TMA, clipped at the map's edge, while the warpgroup
//   goes on.
// - The pool (K6, K7) reads that buffer: with a box at most 32 pixels wide
//   (the wrapper's pool_box), an m64 block is whole row pairs of the box,
//   so every 2x2 window lies in one block of one warpgroup. Each thread
//   takes one window's maximum of the bf16 values for 8 channels and
//   stores those 16 bytes; windows past the floor of H / 2 or W / 2 store
//   nothing.
// - A persistent grid, one block per SM: the producer fills the ring for a
//   block's next tile during its epilogue. Tiles run N-fastest, so the N
//   tiles of one pixel box run together and share the box in L2.

#include "conv_core.cuh"

namespace {

constexpr int kRing = 196608;         // bytes of the stage ring
constexpr int kEpiBuf = 64 * 64 * 2;  // one m64 block x 64 channels: 8 KB
constexpr int kEpiBytes = 2 * 2 * kEpiBuf;  // two buffers per consumer warpgroup

// What the epilogue writes: the conv map y (K5, K7) and the pooled map (K6,
// K7).
constexpr int kStoreY = 1, kPool = 2;

// A tile: MB m64 blocks per consumer warpgroup (128 MB output pixels) times
// BN output channels.
template <int MB, int BN>
struct Tile {
  static constexpr int kATile = 2 * MB * kABlock;
  static constexpr int kStage = kATile + BN / 64 * kBBox;
  static constexpr int kStages = kRing / kStage;
  static constexpr int kSmem = kStages * kStage + kEpiBytes + 16 * kStages + 1024;
};

// The output tile `tile` of a launch: the box of pixels at (y0, x0) of image
// v times output channels [n0, n0 + BN).
struct TileCoords {
  int v, y0, x0, n0;
};

template <int BN>
__device__ __forceinline__ TileCoords tile_coords(int tile, int H, int W, int cout,
                                                  int box_h, int box_w) {
  const int ntn = cout / BN;
  TileCoords c;
  c.n0 = (tile % ntn) * BN;
  int m = tile / ntn;
  const int tiles_x = (W + box_w - 1) / box_w;
  const int tiles_y = (H + box_h - 1) / box_h;
  c.x0 = (m % tiles_x) * box_w;
  m /= tiles_x;
  c.y0 = (m % tiles_y) * box_h;
  c.v = m / tiles_y;
  return c;
}

// Elementwise maximum of two pairs of bf16 values.
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// A persistent block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// Warpgroup 0 produces (one thread issues the TMA loads of every K step of
// every tile, as far ahead as the ring allows), warpgroups 1 and 2 consume.
template <int MB, int BN, int EPI>
__device__ __forceinline__ void conv_tiles(
    const CUtensorMap* xmap, const CUtensorMap* wmap, const CUtensorMap* ymap,
    const float* __restrict__ bias, bf16* __restrict__ pooled, int H, int W,
    int cin, int cout, int box_h, int box_w, int relu, int tiles) {
  using T = Tile<MB, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t epi = base + T::kStages * T::kStage;
  const Ring<T::kStage, T::kStages> ring{base, epi + kEpiBytes,
                                         epi + kEpiBytes + 8 * T::kStages};
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) ring.init(2);  // one arrival per consumer warpgroup
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == 0) {
      int it = 0;  // K steps issued by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileCoords c = tile_coords<BN>(tile, H, W, cout, box_h, box_w);
        produce_conv<BN>(ring, it, xmap, wmap, cin, c.x0, c.y0, c.v, c.n0,
                         T::kATile, T::kATile);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int g = wg - 1;  // rows [64 MB g, 64 MB (g + 1)) of each tile
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
    const uint32_t out0 = epi + g * 2 * kEpiBuf;  // this warpgroup's two buffers
    const int H2 = H / 2, W2 = W / 2;
    int nbuf = 0;
    float acc[MB][BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const TileCoords c = tile_coords<BN>(tile, H, W, cout, box_h, box_w);
      consume_conv<MB, BN>(ring, it, acc, 9 * (cin / kBK), g * MB * kABlock,
                           T::kATile, t);

      // Epilogue, one m64 block times 64 channels at a time, while the
      // producer fills the ring for the next tile: thread (warp w, lane l)
      // holds rows 16 w + l / 4 (+ 8) and channel pairs 8 j + 2 (l % 4) of
      // each n8 block j. The bf16 values go to a 128-byte-swizzled buffer
      // that one thread stores by TMA (clipped at the map's edge) while the
      // warpgroup goes on.
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int p = 0; p < BN / 64; ++p) {
        const uint32_t buf = out0 + nbuf * kEpiBuf;
        if (t == 0)  // the store issued from this buffer two passes ago has read it
          asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        bar_sync(1 + g, 128);
        unsigned char* bp = smem + (buf - base);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = c.n0 + 64 * p + 8 * j + cq;
          const float b0 = bias != nullptr ? bias[n] : 0.0f;
          const float b1 = bias != nullptr ? bias[n + 1] : 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = r0 + 8 * h;
            float v0 = acc[i][(8 * p + j) * 4 + 2 * h] + b0;
            float v1 = acc[i][(8 * p + j) * 4 + 2 * h + 1] + b1;
            if (relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            *reinterpret_cast<__nv_bfloat162*>(bp + swz(rr, j) + cq * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_sync(1 + g, 128);
        const int r = (g * MB + i) * 64;  // first tile row of the block
        if ((EPI & kStoreY) && t == 0) {
          tma_store_4d(ymap, buf, c.n0 + 64 * p, c.x0 + r % box_w, c.y0 + r / box_w,
                       c.v);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
        if (EPI & kPool) {
          // thread t: window q = t / 8 of the block's 16 (box_w / 2 per
          // row pair), channels 8 (t % 8) + [0, 8); r % box_w == 0
          const int half = box_w / 2, q = t / 8, j = t % 8;
          const int qa = q / half, qb = q % half;
          const int top = 2 * qa * box_w + 2 * qb;  // its first pixel
          const uint4 a = *reinterpret_cast<const uint4*>(bp + swz(top, j));
          const uint4 b = *reinterpret_cast<const uint4*>(bp + swz(top + 1, j));
          const uint4 d = *reinterpret_cast<const uint4*>(bp + swz(top + box_w, j));
          const uint4 e =
              *reinterpret_cast<const uint4*>(bp + swz(top + box_w + 1, j));
          const uint4 m = make_uint4(
              max_bf16x2(max_bf16x2(a.x, b.x), max_bf16x2(d.x, e.x)),
              max_bf16x2(max_bf16x2(a.y, b.y), max_bf16x2(d.y, e.y)),
              max_bf16x2(max_bf16x2(a.z, b.z), max_bf16x2(d.z, e.z)),
              max_bf16x2(max_bf16x2(a.w, b.w), max_bf16x2(d.w, e.w)));
          const int py = (c.y0 + r / box_w) / 2 + qa, px = c.x0 / 2 + qb;
          if (py < H2 && px < W2)
            *reinterpret_cast<uint4*>(
                pooled + (((size_t)c.v * H2 + py) * W2 + px) * cout + c.n0 +
                64 * p + 8 * j) = m;
        }
        nbuf ^= 1;
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

template <int MB, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_gemm_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
    int H, int W, int cin, int cout, int box_h, int box_w, int relu, int tiles) {
  conv_tiles<MB, BN, kStoreY>(&xmap, &wmap, &ymap, bias, nullptr, H, W, cin,
                              cout, box_h, box_w, relu, tiles);
}

// K6 (DUAL false: the pooled map only) and K7 (DUAL: y too); relu on.
template <int MB, int BN, bool DUAL>
__global__ void __launch_bounds__(kThreads, 1) conv_relu_pool_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
    bf16* __restrict__ pooled, int H, int W, int cin, int cout, int box_h,
    int box_w, int tiles) {
  conv_tiles<MB, BN, DUAL ? kStoreY | kPool : kPool>(
      &xmap, &wmap, &ymap, bias, pooled, H, W, cin, cout, box_h, box_w, 1, tiles);
}

// The launch of tile <MB, BN>: the tensor maps, then `kernel` on a
// persistent grid. y may be NULL (K6). Returns the status of the C entry.
template <int MB, int BN, class Launch>
int launch(const void* x, const void* w9, void* y, int V, int H, int W, int cin,
           int cout, int box_h, int box_w, const void* kernel, Launch run) {
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward runs on a thread of its own) before
  // libcuda encodes the tensor maps
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<MB, BN>::kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap, ymap = {};
  int res = encode_nhwc(&xmap, x, V, H, W, cin, box_w, box_h);
  if (res != 0) return -res;
  res = encode_w9(&wmap, w9, cin, cout);
  if (res != 0) return -res;
  if (y != nullptr) {
    // y by m64 blocks: 64 pixels of the box (whole rows of a box narrower
    // than 64, else 64 columns of one row) times 64 channels
    const int sub_w = box_w < 64 ? box_w : 64;
    res = encode_nhwc(&ymap, y, V, H, W, cout, sub_w, 64 / sub_w);
    if (res != 0) return -res;
  }
  const long long tiles = (long long)V * ((H + box_h - 1) / box_h) *
                          ((W + box_w - 1) / box_w) * (cout / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(tiles < sm_count() ? tiles : sm_count());
  run(blocks, Tile<MB, BN>::kSmem, xmap, wmap, ymap, (int)tiles);
  return (int)cudaGetLastError();
}

template <int MB, int BN>
int launch_conv(const void* x, const void* w9, const void* bias, void* y, int V,
                int H, int W, int cin, int cout, int relu, int box_h, int box_w,
                cudaStream_t st) {
  return launch<MB, BN>(
      x, w9, y, V, H, W, cin, cout, box_h, box_w,
      (const void*)conv3x3_gemm_kernel<MB, BN>,
      [&](int blocks, int smem, const CUtensorMap& xmap, const CUtensorMap& wmap,
          const CUtensorMap& ymap, int tiles) {
        conv3x3_gemm_kernel<MB, BN><<<blocks, kThreads, smem, st>>>(
            xmap, wmap, ymap, (const float*)bias, H, W, cin, cout, box_h, box_w,
            relu, tiles);
      });
}

template <int MB, int BN, bool DUAL>
int launch_pool(const void* x, const void* w9, const void* bias, void* y,
                void* pooled, int V, int H, int W, int cin, int cout, int box_h,
                int box_w, cudaStream_t st) {
  return launch<MB, BN>(
      x, w9, DUAL ? y : nullptr, V, H, W, cin, cout, box_h, box_w,
      (const void*)conv_relu_pool_kernel<MB, BN, DUAL>,
      [&](int blocks, int smem, const CUtensorMap& xmap, const CUtensorMap& wmap,
          const CUtensorMap& ymap, int tiles) {
        conv_relu_pool_kernel<MB, BN, DUAL><<<blocks, kThreads, smem, st>>>(
            xmap, wmap, ymap, (const float*)bias, (bf16*)pooled, H, W, cin, cout,
            box_h, box_w, tiles);
      });
}

}  // namespace

// y = bf16(act(conv3x3(x, w9) + bias)), act = relu if `relu`; bias may be
// NULL (K9). A tile is a box_h x box_w box of output pixels times block_n
// output channels: 128 pixels x 256 channels, or 256 pixels x 64 or 128
// channels; box_w a multiple of 8. Cin a multiple of 64, Cout of block_n.
// Returns the launch's cudaError_t, or minus the CUresult of a tensor map
// that could not be encoded.
extern "C" int stylemesh_conv3x3(const void* x, const void* w9, const void* bias,
                                 void* y, int V, int H, int W, int cin, int cout,
                                 int relu, int box_h, int box_w, int block_n,
                                 void* stream) {
  const int pixels = box_h * box_w;
  if (cin <= 0 || cin % kBK != 0 || box_w % 8 != 0 || cout <= 0 ||
      !((pixels == 128 && block_n == 256) ||
        (pixels == 256 && (block_n == 64 || block_n == 128))) ||
      cout % block_n != 0)
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (block_n == 256)
    return launch_conv<1, 256>(x, w9, bias, y, V, H, W, cin, cout, relu, box_h,
                               box_w, st);
  if (block_n == 128)
    return launch_conv<2, 128>(x, w9, bias, y, V, H, W, cin, cout, relu, box_h,
                               box_w, st);
  return launch_conv<2, 64>(x, w9, bias, y, V, H, W, cin, cout, relu, box_h,
                            box_w, st);
}

// pooled = maxpool2(bf16(relu(conv3x3(x, w9) + bias))) [V, H / 2, W / 2,
// Cout] (K6); with `dual`, y = the pre-pool map [V, H, W, Cout] too (K7).
// bias may be NULL (zero). Tiles of 256 pixels x block_n = 64 or 128
// channels (K5's for that Cout), box_w 8, 16 or 32 (so that an m64 block
// is whole row pairs of the box). Cin a multiple of 64, Cout of block_n.
// Returns as stylemesh_conv3x3.
extern "C" int stylemesh_conv_relu_pool(const void* x, const void* w9,
                                        const void* bias, void* y, void* pooled,
                                        int V, int H, int W, int cin, int cout,
                                        int dual, int box_h, int box_w,
                                        int block_n, void* stream) {
  if (cin <= 0 || cin % kBK != 0 || cout <= 0 || box_h * box_w != 256 ||
      !(box_w == 8 || box_w == 16 || box_w == 32) ||
      !(block_n == 64 || block_n == 128) || cout % block_n != 0)
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dual) {
    if (block_n == 128)
      return launch_pool<2, 128, true>(x, w9, bias, y, pooled, V, H, W, cin, cout,
                                       box_h, box_w, st);
    return launch_pool<2, 64, true>(x, w9, bias, y, pooled, V, H, W, cin, cout,
                                    box_h, box_w, st);
  }
  if (block_n == 128)
    return launch_pool<2, 128, false>(x, w9, bias, y, pooled, V, H, W, cin, cout,
                                      box_h, box_w, st);
  return launch_pool<2, 64, false>(x, w9, bias, y, pooled, V, H, W, cin, cout,
                                   box_h, box_w, st);
}

// K5 / K9 and K6 / K7: the bf16 VGG trunk's 3x3 convolution as an implicit
// GEMM on Hopper's warpgroup MMA (wgmma), fed by a TMA pipeline, with the
// bias, relu and, for the block tails, the 2x2 max pool in its epilogue.
//
// Replaces the TPU kernels
//   K5  ops/conv_pallas.py::_conv3x3_v2_raw (_conv_kernel_v2), reached through
//       conv3x3_v2: y = bf16(act(conv3x3(x, w) + b)), act = relu or identity;
//       also every trunk input gradient (flipped io-swapped kernel, b = 0,
//       relu off), which may finish the cotangent of its own input, a relu
//       output m, with the loss tap's cotangent t of m:
//       dx = m > 0 ? bf16(float(bf16(conv)) + float(t)) : +0 (t optional);
//   K9  ops/conv_pallas.py::conv3x3_mxu: y = bf16(conv3x3(x, w)), and its
//       conv3x3_frozen VJP. K9 is this entry with bias NULL and relu off, so
//       it equals K5 without bias and relu bit for bit;
//   K6  ops/head_pallas.py::conv_relu_pool (_kernel_packed, 64 channels, and
//       _kernel_direct, 128): p = maxpool2(bf16(relu(conv3x3(x, w) + b)));
//   K7  ops/head_pallas.py::conv_relu_pool_dual (_kernel_direct_dual): K6 that
//       also writes the pre-pool activation y.
// K6 with codes (64 channels, a forward whose backward will run) also writes
// each pool window's route, 4-bit codes by conv_core.cuh's route rule (32
// bytes a window), for K8 (conv_pool_bwd.cu): the TPU kernel recomputes the
// relu output in its backward instead.
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
// - The input gradient that finishes its input's cotangent (kMask, kAddT)
//   reads m and t in that block's box, from 8 KB slots of one to three
//   ring stages that the producer queues behind the tile's last K step: they
//   arrive while the last K steps run, each element is read once, and the
//   mainloop keeps its stages. That replaces a relu mask pass (y > 0, then
//   where) and autograd's sum of two cotangents, each a pass over the map.
//   At 168 registers a thread its consumers spilled (on an H100 the
//   128-channel tail's gradient then took 1.9x K5's time), so the variant
//   moves registers from the producer warpgroup to the consumers
//   (setmaxnreg: 40 and 232).
// - The pool (K6, K7) reads that buffer: with a box at most 32 pixels wide
//   (the wrapper's pool_box), an m64 block is whole row pairs of the box,
//   so every 2x2 window lies in one block of one warpgroup. Each thread
//   takes one window's maximum of the bf16 values for 8 channels and
//   stores those 16 bytes; windows past the floor of H / 2 or W / 2 store
//   nothing. With codes (kCodes) it also stores the window's code word for
//   those 8 channels (window_codes of the same four bf16 pixels).
// - A persistent grid, one block per SM: the producer fills the ring for a
//   block's next tile during its epilogue. Tiles run N-fastest, so the N
//   tiles of one pixel box run together and share the box in L2.

#include "conv_core.cuh"

namespace {

constexpr int kRing = 196608;         // bytes of the stage ring
constexpr int kEpiBuf = 64 * 64 * 2;  // one m64 block x 64 channels: 8 KB
constexpr int kEpiBytes = 2 * 2 * kEpiBuf;  // two buffers per consumer warpgroup

// What the epilogue writes: the conv map y (K5, K7) and the pooled map (K6,
// K7); kMask: y finishes the cotangent of a relu output m (zero where
// m <= 0), kAddT: after adding the tap's cotangent t (K5's input gradients);
// kCodes: each pool window's route codes too (K6 for K8).
constexpr int kStoreY = 1, kPool = 2, kMask = 4, kAddT = 8, kCodes = 16;

// A tile: MB m64 blocks per consumer warpgroup (128 MB output pixels) times
// BN output channels.
template <int MB, int BN>
struct Tile {
  static constexpr int kATile = 2 * MB * kABlock;
  static constexpr int kStage = kATile + BN / 64 * kBBox;
  static constexpr int kStages = kRing / kStage;
  static constexpr int kSmem = kStages * kStage + kEpiBytes + 16 * kStages + 1024;
};

// The epilogue operands of a tile (kMask): for pass q (m64 block i, channel
// slice p: q = i * BN / 64 + p) of consumer warpgroup g, m's and, with kAddT,
// t's box of 64 pixels x 64 channels at the coordinates of the pass's store,
// in 8 KB slots of kStages ring stages after the tile's last K step.
template <int MB, int BN, int EPI>
struct EpiLoads {
  static constexpr int kTensors = (EPI & kAddT) ? 2 : 1;
  static constexpr int kPasses = MB * (BN / 64);  // per warpgroup
  static constexpr int kSlots = Tile<MB, BN>::kStage / kEpiBuf;  // per stage
  static constexpr int kBoxes = (EPI & kMask) ? 2 * kPasses * kTensors : 0;
  static constexpr int kStages = (kBoxes + kSlots - 1) / kSlots;
  static_assert(kStages <= Tile<MB, BN>::kStages, "the ring holds a tile's operands");
  // the slot of tensor e (0: m, 1: t) of pass q of warpgroup g
  static __device__ __forceinline__ int slot(int q, int g, int e) {
    return (2 * q + g) * kTensors + e;
  }
  // the last pass that reads stage s: each warpgroup releases it after it
  static __device__ __forceinline__ int last_pass(int s) {
    const int last = ((s + 1) * kSlots < kBoxes ? (s + 1) * kSlots : kBoxes) - 1;
    return last / kTensors / 2;
  }
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

// Two bf16 values y of K5's input gradient finished as the cotangent of a
// relu output: m > 0 ? bf16(y + t) : +0 with the sum in float32, the
// rounding of autograd's bf16 sum and then of torch.where.
template <bool ADD_T>
__device__ __forceinline__ uint32_t finish_bf16x2(uint32_t y, uint32_t m, uint32_t t) {
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  if (ADD_T) {
    const float2 tv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t));
    f.x += tv.x;
    f.y += tv.y;
  }
  const float2 mv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&m));
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(mv.x > 0.0f ? f.x : 0.0f, mv.y > 0.0f ? f.y : 0.0f);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// A persistent block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// Warpgroup 0 produces (one thread issues the TMA loads of every K step of
// every tile, as far ahead as the ring allows), warpgroups 1 and 2 consume.
template <int MB, int BN, int EPI>
__device__ __forceinline__ void conv_tiles(
    const CUtensorMap* xmap, const CUtensorMap* wmap, const CUtensorMap* ymap,
    const float* __restrict__ bias, bf16* __restrict__ pooled, int H, int W,
    int cin, int cout, int box_h, int box_w, int relu, int tiles,
    const CUtensorMap* mmap, const CUtensorMap* tmap, uint32_t* __restrict__ codes) {
  using T = Tile<MB, BN>;
  using E = EpiLoads<MB, BN, EPI>;
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
    if constexpr (E::kBoxes > 0)  // the consumers' epilogue needs more
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;  // K steps issued by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileCoords c = tile_coords<BN>(tile, H, W, cout, box_h, box_w);
        // the epilogue operands' box b: (tensor map, coordinates of the
        // pass's store)
        auto operand = [&](int box, int (&co)[4]) {
          const int g = box / E::kTensors % 2, q = box / E::kTensors / 2;
          const int r = (g * MB + q / (BN / 64)) * 64;
          co[0] = c.n0 + 64 * (q % (BN / 64));
          co[1] = c.x0 + r % box_w;
          co[2] = c.y0 + r / box_w;
          co[3] = c.v;
          return box % E::kTensors ? tmap : mmap;
        };
        produce_conv<BN>(ring, it, xmap, wmap, cin, c.x0, c.y0, c.v, c.n0,
                         T::kATile, T::kATile);
        for (int s = 0; s < E::kStages; ++s, ++it) {
          const int first = s * E::kSlots;
          const int n = E::kBoxes - first < E::kSlots ? E::kBoxes - first : E::kSlots;
          const uint32_t dst = ring.acquire(it, n * kEpiBuf);
          for (int b = 0; b < n; ++b) {
            int co[4];
            const CUtensorMap* map = operand(first + b, co);
            tma_load_4d(dst + b * kEpiBuf, map, ring.full_bar(it), co[0], co[1],
                        co[2], co[3]);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (E::kBoxes > 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
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
      const int e0 = it;  // the tile's first epilogue-operand stage
      it += E::kStages;

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
        if constexpr ((EPI & kMask) != 0) {
          // finish the cotangent in the buffer, 16 bytes of a pixel at a
          // time, once its bf16 values are all there (the accumulators of
          // the later passes stay in registers meanwhile)
          const int pass = i * (BN / 64) + p;
          const int sm = E::slot(pass, g, 0), st = E::slot(pass, g, E::kTensors - 1);
          mbar_wait(ring.full_bar(e0 + sm / E::kSlots), ring.parity(e0 + sm / E::kSlots));
          mbar_wait(ring.full_bar(e0 + st / E::kSlots), ring.parity(e0 + st / E::kSlots));
          const unsigned char* mp =
              smem + (ring.stage(e0 + sm / E::kSlots) + sm % E::kSlots * kEpiBuf - base);
          const unsigned char* tp =
              smem + (ring.stage(e0 + st / E::kSlots) + st % E::kSlots * kEpiBuf - base);
          bar_sync(1 + g, 128);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t off = swz(t / 8 + 16 * k, t % 8);
            uint4 y = *reinterpret_cast<const uint4*>(bp + off);
            const uint4 m = *reinterpret_cast<const uint4*>(mp + off);
            const uint4 tv = (EPI & kAddT) ? *reinterpret_cast<const uint4*>(tp + off)
                                           : make_uint4(0, 0, 0, 0);
            y.x = finish_bf16x2<(EPI & kAddT) != 0>(y.x, m.x, tv.x);
            y.y = finish_bf16x2<(EPI & kAddT) != 0>(y.y, m.y, tv.y);
            y.z = finish_bf16x2<(EPI & kAddT) != 0>(y.z, m.z, tv.z);
            y.w = finish_bf16x2<(EPI & kAddT) != 0>(y.w, m.w, tv.w);
            *reinterpret_cast<uint4*>(bp + off) = y;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_sync(1 + g, 128);
        if constexpr ((EPI & kMask) != 0) {
          // every thread of the warpgroup has read the stages this pass ends
#pragma unroll
          for (int s = 0; s < E::kStages; ++s)
            if (t == 0 && E::last_pass(s) == i * (BN / 64) + p)
              mbar_arrive(ring.empty_bar(e0 + s));
        }
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
          if (py < H2 && px < W2) {
            const size_t win = ((size_t)c.v * H2 + py) * W2 + px;
            *reinterpret_cast<uint4*>(pooled + win * cout + c.n0 + 64 * p + 8 * j) = m;
            if constexpr ((EPI & kCodes) != 0) {
              const uint32_t quad[4][4] = {{a.x, a.y, a.z, a.w}, {b.x, b.y, b.z, b.w},
                                           {d.x, d.y, d.z, d.w}, {e.x, e.y, e.z, e.w}};
              codes[win * (cout / 8) + (c.n0 + 64 * p) / 8 + j] = window_codes(quad);
            }
          }
        }
        nbuf ^= 1;
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// K5 / K9; MASK (K5's input gradients): y finishes the cotangent of the relu
// output m (mmap), ADD_T: with the tap's cotangent t (tmap) added. The
// maps come last, so the other instantiations keep their code.
template <int MB, int BN, bool MASK, bool ADD_T>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_gemm_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
    int H, int W, int cin, int cout, int box_h, int box_w, int relu, int tiles,
    const __grid_constant__ CUtensorMap mmap,
    const __grid_constant__ CUtensorMap tmap) {
  conv_tiles<MB, BN, kStoreY | (MASK ? kMask : 0) | (ADD_T ? kAddT : 0)>(
      &xmap, &wmap, &ymap, bias, nullptr, H, W, cin, cout, box_h, box_w, relu,
      tiles, &mmap, &tmap, nullptr);
}

// K6 (DUAL false: the pooled map only) and K7 (DUAL: y too); relu on.
// CODES: K6 that writes the route codes too.
template <int MB, int BN, bool DUAL, bool CODES>
__global__ void __launch_bounds__(kThreads, 1) conv_relu_pool_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
    bf16* __restrict__ pooled, int H, int W, int cin, int cout, int box_h,
    int box_w, int tiles, uint32_t* __restrict__ codes) {
  conv_tiles<MB, BN, (DUAL ? kStoreY | kPool : kPool) | (CODES ? kCodes : 0)>(
      &xmap, &wmap, &ymap, bias, pooled, H, W, cin, cout, box_h, box_w, 1, tiles,
      nullptr, nullptr, codes);
}

// The launch of tile <MB, BN>: the tensor maps, then `kernel` on a
// persistent grid. y may be NULL (K6); m and t are NULL but for K5's input
// gradients that finish their input's cotangent, and take y's boxes.
// Returns the status of the C entry.
template <int MB, int BN, class Launch>
int launch(const void* x, const void* w9, void* y, const void* m, const void* t,
           int V, int H, int W, int cin, int cout, int box_h, int box_w,
           const void* kernel, Launch run) {
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward runs on a thread of its own) before
  // libcuda encodes the tensor maps
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<MB, BN>::kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap, ymap = {}, mmap = {}, tmap = {};
  int res = encode_nhwc(&xmap, x, V, H, W, cin, box_w, box_h);
  if (res != 0) return -res;
  res = encode_w9(&wmap, w9, cin, cout);
  if (res != 0) return -res;
  // y, m and t by m64 blocks: 64 pixels of the box (whole rows of a box
  // narrower than 64, else 64 columns of one row) times 64 channels
  const int sub_w = box_w < 64 ? box_w : 64;
  CUtensorMap* maps[3] = {&ymap, &mmap, &tmap};
  const void* ptrs[3] = {y, m, t};
  for (int k = 0; k < 3; ++k) {
    if (ptrs[k] == nullptr) continue;
    res = encode_nhwc(maps[k], ptrs[k], V, H, W, cout, sub_w, 64 / sub_w);
    if (res != 0) return -res;
  }
  const long long tiles = (long long)V * ((H + box_h - 1) / box_h) *
                          ((W + box_w - 1) / box_w) * (cout / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(tiles < sm_count() ? tiles : sm_count());
  run(blocks, Tile<MB, BN>::kSmem, xmap, wmap, ymap, mmap, tmap, (int)tiles);
  return (int)cudaGetLastError();
}

template <int MB, int BN, bool MASK, bool ADD_T>
int launch_conv(const void* x, const void* w9, const void* bias, const void* m,
                const void* t, void* y, int V, int H, int W, int cin, int cout,
                int relu, int box_h, int box_w, cudaStream_t st) {
  return launch<MB, BN>(
      x, w9, y, m, t, V, H, W, cin, cout, box_h, box_w,
      (const void*)conv3x3_gemm_kernel<MB, BN, MASK, ADD_T>,
      [&](int blocks, int smem, const CUtensorMap& xmap, const CUtensorMap& wmap,
          const CUtensorMap& ymap, const CUtensorMap& mmap,
          const CUtensorMap& tmap, int tiles) {
        conv3x3_gemm_kernel<MB, BN, MASK, ADD_T><<<blocks, kThreads, smem, st>>>(
            xmap, wmap, ymap, (const float*)bias, H, W, cin, cout, box_h, box_w,
            relu, tiles, mmap, tmap);
      });
}

// K5's tile for block_n (checked by the C entries).
template <bool MASK, bool ADD_T>
int launch_conv_tile(const void* x, const void* w9, const void* bias,
                     const void* m, const void* t, void* y, int V, int H, int W,
                     int cin, int cout, int relu, int box_h, int box_w,
                     int block_n, cudaStream_t st) {
  if (block_n == 256)
    return launch_conv<1, 256, MASK, ADD_T>(x, w9, bias, m, t, y, V, H, W, cin,
                                            cout, relu, box_h, box_w, st);
  if (block_n == 128)
    return launch_conv<2, 128, MASK, ADD_T>(x, w9, bias, m, t, y, V, H, W, cin,
                                            cout, relu, box_h, box_w, st);
  return launch_conv<2, 64, MASK, ADD_T>(x, w9, bias, m, t, y, V, H, W, cin,
                                         cout, relu, box_h, box_w, st);
}

// Whether K5 takes the tile: 128 pixels x 256 channels, or 256 pixels x 64
// or 128 channels; box_w a multiple of 8; Cin a multiple of 64, Cout of
// block_n.
bool conv_tile_ok(int cin, int cout, int box_h, int box_w, int block_n) {
  const int pixels = box_h * box_w;
  return cin > 0 && cin % kBK == 0 && box_w % 8 == 0 && cout > 0 &&
         ((pixels == 128 && block_n == 256) ||
          (pixels == 256 && (block_n == 64 || block_n == 128))) &&
         cout % block_n == 0;
}

template <int MB, int BN, bool DUAL, bool CODES = false>
int launch_pool(const void* x, const void* w9, const void* bias, void* y,
                void* pooled, void* codes, int V, int H, int W, int cin, int cout,
                int box_h, int box_w, cudaStream_t st) {
  return launch<MB, BN>(
      x, w9, DUAL ? y : nullptr, nullptr, nullptr, V, H, W, cin, cout, box_h,
      box_w, (const void*)conv_relu_pool_kernel<MB, BN, DUAL, CODES>,
      [&](int blocks, int smem, const CUtensorMap& xmap, const CUtensorMap& wmap,
          const CUtensorMap& ymap, const CUtensorMap&, const CUtensorMap&,
          int tiles) {
        conv_relu_pool_kernel<MB, BN, DUAL, CODES><<<blocks, kThreads, smem, st>>>(
            xmap, wmap, ymap, (const float*)bias, (bf16*)pooled, H, W, cin, cout,
            box_h, box_w, tiles, (uint32_t*)codes);
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
  if (!conv_tile_ok(cin, cout, box_h, box_w, block_n))
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  return launch_conv_tile<false, false>(x, w9, bias, nullptr, nullptr, y, V, H, W,
                                        cin, cout, relu, box_h, box_w, block_n,
                                        (cudaStream_t)stream);
}

// K5's input gradient that finishes the cotangent of its input, the relu
// output m [V, H, W, Cout]: y = m > 0 ? bf16(float(bf16(conv3x3(x, w9))) +
// float(t)) : +0, with t [V, H, W, Cout] the loss tap's cotangent of m, or
// NULL (then y = m > 0 ? bf16(conv3x3(x, w9)) : +0). No bias, no relu; the
// tiles and the status as stylemesh_conv3x3.
extern "C" int stylemesh_conv3x3_masked(const void* x, const void* w9,
                                        const void* m, const void* t, void* y,
                                        int V, int H, int W, int cin, int cout,
                                        int box_h, int box_w, int block_n,
                                        void* stream) {
  if (m == nullptr || !conv_tile_ok(cin, cout, box_h, box_w, block_n))
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (t != nullptr)
    return launch_conv_tile<true, true>(x, w9, nullptr, m, t, y, V, H, W, cin,
                                        cout, 0, box_h, box_w, block_n, st);
  return launch_conv_tile<true, false>(x, w9, nullptr, m, nullptr, y, V, H, W, cin,
                                       cout, 0, box_h, box_w, block_n, st);
}

// pooled = maxpool2(bf16(relu(conv3x3(x, w9) + bias))) [V, H / 2, W / 2,
// Cout] (K6); with `dual`, y = the pre-pool map [V, H, W, Cout] too (K7).
// codes, or NULL: each window's route codes, uint32 [V, H / 2, W / 2,
// Cout / 8] (conv_core.cuh), for K6 at block_n 64 alone. bias may be NULL
// (zero). Tiles of 256 pixels x block_n = 64 or 128 channels (K5's for that
// Cout), box_w 8, 16 or 32 (so that an m64 block is whole row pairs of the
// box). Cin a multiple of 64, Cout of block_n. Returns as stylemesh_conv3x3.
extern "C" int stylemesh_conv_relu_pool(const void* x, const void* w9,
                                        const void* bias, void* y, void* pooled,
                                        void* codes, int V, int H, int W, int cin,
                                        int cout, int dual, int box_h, int box_w,
                                        int block_n, void* stream) {
  if (cin <= 0 || cin % kBK != 0 || cout <= 0 || box_h * box_w != 256 ||
      !(box_w == 8 || box_w == 16 || box_w == 32) ||
      !(block_n == 64 || block_n == 128) || cout % block_n != 0 ||
      (codes != nullptr && (dual || block_n != 64)))
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (codes != nullptr)
    return launch_pool<2, 64, false, true>(x, w9, bias, y, pooled, codes, V, H, W,
                                           cin, cout, box_h, box_w, st);
  if (dual) {
    if (block_n == 128)
      return launch_pool<2, 128, true>(x, w9, bias, y, pooled, nullptr, V, H, W,
                                       cin, cout, box_h, box_w, st);
    return launch_pool<2, 64, true>(x, w9, bias, y, pooled, nullptr, V, H, W, cin,
                                    cout, box_h, box_w, st);
  }
  if (block_n == 128)
    return launch_pool<2, 128, false>(x, w9, bias, y, pooled, nullptr, V, H, W,
                                      cin, cout, box_h, box_w, st);
  return launch_pool<2, 64, false>(x, w9, bias, y, pooled, nullptr, V, H, W, cin,
                                   cout, box_h, box_w, st);
}

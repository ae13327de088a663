// K8: the input gradient of the 64-channel fused block tail
// maxpool2(bf16(relu(conv3x3(x, w) + b))), on the wgmma + TMA core of
// conv_core.cuh; and the route kernel, the pool's backward of the
// 128-channel tail by K8's routing rule (at the end of this note).
//
// Replaces the TPU kernel
//   K8  ops/head_pallas.py::conv_relu_pool_bwd (_kernel_packed_bwd):
//       dx = conv3x3(pool_route(r, g), w9t), r = bf16(relu(conv3x3(x, w9) + b))
//       recomputed, g the pooled cotangent, w9t the flipped io-swapped kernel.
// The inputs are the TPU kernel's: x, w9, w9t, bias, g, and optionally t,
// the loss tap's cotangent of x: dx = bf16(float(dx) + float(t)) then, the
// bf16 sum autograd would take. r and the routed gradient dr stay in shared
// memory; x, g and t are read, only dx is written.
//
// Layouts: x, dx bf16 [V, H, W, 64] (channel-last), g bf16 [V, H / 2, W / 2,
// 64], w9 and w9t bf16 [9 * 64, 64] with rows in (dy, dx, ci) order, bias
// float32 [64]. Stride 1, SAME zero padding.
//
// What bounds it on an H100: the tensor cores, as for K5 (conv_gemm.cu):
// two 64-channel convs per dx pixel, plus the recompute of r on the halo.
// One block per dx tile of kTH x kTW = 24 x 32 pixels (both even, so the
// tile holds whole pool windows), three phases:
// 1. r on the tile plus one ring of pool windows, kRH x kRW = 28 x 36
//    pixels (rows and columns -2 .. +2 around the tile), from the shared
//    mainloop at N = 64 (K5's N tile for 64 channels) in four boxes of
//    7 x 36 = 252 pixels, each an A tile of four m64 blocks (the last 4
//    rows unused). The epilogue is K5's (float32 bias, relu, one rounding
//    to bf16) into a shared r tile, one pixel per 128-byte swizzled row, so
//    r equals K6's / K5's values bit for bit and the routing is the
//    forward's. TMA's zero fill is the SAME padding. Recompute overhead:
//    28 * 36 / (24 * 32) = 1.3125 (the WMMA kernel it replaces: 1.71).
// 2. Route, in place: each window's cotangent goes to its first maximum in
//    raster order where that value is > 0; windows outside the pooled map
//    (image border, odd tail) route nothing, so dr is 0 there and at every
//    pixel outside the image: the transposed conv's padding.
// 3. dx = the transposed conv of dr (the conv with w9t) in the same K order
//    and instruction shape as K5, so dx equals K5 on the routed map bit for
//    bit. A, dr shifted by the tap, is read from the r tile with
//    ldmatrix (any pixel offset), and wgmma takes it from registers; B
//    (w9t) comes through the ring. The 12 m64 blocks of dx (two rows of 32
//    pixels each) run in three passes of two per consumer warpgroup; each
//    block is stored by TMA (clipped at the map's edge) from a swizzled
//    buffer in the then idle A area of the warpgroup's ring stage. With t,
//    each block's t is loaded by TMA into that buffer ahead of its pass
//    (the first four blocks' during phase 2, the last two's once the
//    stores of the first two have read their buffers) and summed in place.
// Shared memory: a 2-stage ring of 40 KB stages (80 KB) and the 126 KB r
// tile, 207 KB: one block per SM. The ring has two stages, not K5's four,
// because the r tile takes the rest.
//
// The route kernel (stylemesh_pool_route): the 128-channel tail's backward
// before K5, dr = pool_route(r, g) from the saved relu output r (K7's pre-pool
// map) and the pooled cotangent g, by K8's phase-2 rule (route_window). It
// replaces a chain of about 40 PyTorch passes (a float32 copy of r, three
// maximums, per window position eq, gt, and, or and where, a stack, a zero
// fill and a permuted copy); the TPU path has no kernel for it (the pool's
// elementwise VJP, models/vgg.py::_maxpool2_bwd, under XLA). What bounds it
// on an H100: bytes. r is read and dr written once (2 bytes an element each)
// and g read once (0.5 bytes an element): 237 MB a view at conv2_2's four
// bench levels, 0.071 ms at 3.35 TB/s. Nothing is summed, so dr equals the
// plain chain bit for bit.

#include "conv_core.cuh"

namespace {

constexpr int kC = 64;                // channels of x, r and dx
constexpr int kTH = 24, kTW = 32;     // dx tile
constexpr int kRH = kTH + 4, kRW = kTW + 4;  // r region
constexpr int kSubRows = 7;           // r rows per phase-1 box
constexpr int kSubs = kRH / kSubRows; // phase-1 boxes
constexpr int kSubPx = kSubRows * kRW;  // 252 pixels of a 256-row A tile
constexpr int kATile = 4 * kABlock;   // two m64 blocks per consumer warpgroup
constexpr int kStage = kATile + kBBox;
constexpr int kStages = 2;
constexpr int kRTile = kRH * kRW * 128;
constexpr int kEpiBuf = 64 * kC * 2;  // one m64 block of dx: 8 KB
constexpr int kPasses = kTH / 2 / 4;  // phase 3: 2 blocks per warpgroup a pass
constexpr int kEpiBufs = kATile / kEpiBuf;  // dx buffers per warpgroup: 4
constexpr int kSmem = kStages * kStage + kRTile + 16 * kStages + 32 + 1024;

static_assert(kSubs * kSubRows == kRH && kSubPx <= 256, "phase-1 boxes");
static_assert(kTW == 32 && kTH % 8 == 0, "m64 blocks of dx: two rows of 32");
static_assert(kSmem <= 232448, "shared memory of one block");
static_assert(2 * kPasses - kEpiBufs == 2, "t of the last pass: two buffers");
constexpr int kRouteThreads = 256;  // the route kernel's block

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// The pool's backward for one 2x2 window and eight channels, K8's rule and
// the route kernel's: q[e] is the window's pixel e in raster order ((0,0),
// (0,1), (1,0), (1,1)) and g the window's cotangent, eight bf16 each (channel
// c in bits [16 (c % 2), 16 (c % 2) + 16) of word c / 2). Each channel's
// cotangent, its bits, goes to the first maximum in that order where that
// value is > 0; every other element of out is bf16 +0. A channel whose
// window holds a NaN routes nothing: its maximum is NaN then and equals no
// element (torch.maximum, then ==). K8's r, a relu output, holds no NaN.
__device__ __forceinline__ void route_window(const uint32_t (&q)[4][4],
                                             const uint32_t (&g)[4],
                                             uint32_t (&out)[4][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e][0] = out[e][1] = out[e][2] = out[e][3] = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // channel c's bf16, widened to float32 exactly
    const int wd = c / 2, sh = 16 * (c % 2);
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(((q[e][wd] >> sh) & 0xFFFFu) << 16);
    const float top = fmaxf(fmaxf(f[0], f[1]), fmaxf(f[2], f[3]));
    bool taken = isnan(f[0]) || isnan(f[1]) || isnan(f[2]) || isnan(f[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool first = !taken && f[e] == top && f[e] > 0.0f;
      taken = taken || first;
      if (first) out[e][wd] |= ((g[wd] >> sh) & 0xFFFFu) << sh;
    }
  }
}

// ADD_T: t (tmap) is added to dx.
template <bool ADD_T>
__global__ void __launch_bounds__(kThreads, 1) conv_relu_pool_bwd_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap wtmap,
    const __grid_constant__ CUtensorMap dxmap, const float* __restrict__ bias,
    const bf16* __restrict__ g, int H, int W, int tiles_x, int tiles_y,
    const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t rt = base + kStages * kStage;  // the r / dr tile
  unsigned char* rtp = smem + kStages * kStage;
  const Ring<kStage, kStages> ring{base, rt + kRTile, rt + kRTile + 8 * kStages};
  // t's barriers: per consumer warpgroup, its first four blocks, its last two
  const uint32_t tbar = rt + kRTile + 16 * kStages;
  const int wg = threadIdx.x / 128;

  int m = blockIdx.x;
  const int x0 = (m % tiles_x) * kTW;
  m /= tiles_x;
  const int y0 = (m % tiles_y) * kTH;
  const int v = m / tiles_y;

  if (threadIdx.x == 0) {
    if constexpr (ADD_T)
      for (int k = 0; k < 4; ++k) mbar_init(tbar + 8 * k, 1);
    ring.init(2);  // one arrival per consumer warpgroup
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == 0) {
      int it = 0;
      for (int s = 0; s < kSubs; ++s)  // phase 1: x boxes and w9
        produce_conv<kC>(ring, it, &xmap, &wmap, kC, x0 - 2,
                         y0 - 2 + kSubRows * s, v, 0, kSubPx * 128, kATile);
      for (int q = 0; q < kPasses; ++q)  // phase 3: w9t, tap by tap
        for (int tap = 0; tap < 9; ++tap, ++it)
          tma_load_2d(ring.acquire(it, kBBox) + kATile, &wtmap, ring.full_bar(it),
                      0, tap * kC);
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int gi = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const uint32_t epi = ring.stage(gi);  // this warpgroup's stage's A area
  int it = 0;
  // the warpgroup's dx block k (of 2 kPasses): rows 2 blk, 2 blk + 1 of the
  // tile, into buffer k % kEpiBufs
  auto block = [&](int k) { return 4 * (k / 2) + 2 * gi + k % 2; };
  const CUtensorMap* tm = &tmap;
  auto load_t = [&](int k0, int k1, uint32_t bar) {
    mbar_expect_tx(bar, (k1 - k0) * kEpiBuf);
    for (int k = k0; k < k1; ++k)
      tma_load_4d(epi + k % kEpiBufs * kEpiBuf, tm, bar, 0, x0, y0 + 2 * block(k), v);
  };

  // 1. r = bf16(relu(conv3x3(x, w9) + b)) on the r region, box by box
  for (int s = 0; s < kSubs; ++s) {
    float acc[2][kC / 2];
    consume_conv<2, kC>(ring, it, acc, 9, gi * 2 * kABlock, kATile, t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b0 = bias[8 * j + cq], b1 = bias[8 * j + cq + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (2 * gi + i) * 64 + r0 + 8 * h;  // of the A tile
          if (row >= kSubPx) continue;
          const float v0 = fmaxf(acc[i][4 * j + 2 * h] + b0, 0.0f);
          const float v1 = fmaxf(acc[i][4 * j + 2 * h + 1] + b1, 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(
              rtp + swz(kSubPx * s + row, j) + cq * 2) = __floats2bfloat162_rn(v0, v1);
        }
      }
  }
  bar_sync(3, 256);
  // phase 1 has left the ring's A areas: the first four blocks' t
  if constexpr (ADD_T)
    if (t == 0) load_t(0, kEpiBufs, tbar + 16 * gi);

  // 2. route the pooled cotangent, in place: window (wi, wj) covers r rows
  //    2 wi, 2 wi + 1 and columns 2 wj, 2 wj + 1 (tile rows / columns - 2)
  {
    const int H2 = H / 2, W2 = W / 2;
    for (int idx = gi * 128 + t; idx < (kRH / 2) * (kRW / 2) * 8; idx += 256) {
      const int j = idx % 8, w = idx / 8;
      const int wi = w / (kRW / 2), wj = w % (kRW / 2);
      const int py = y0 / 2 - 1 + wi, px = x0 / 2 - 1 + wj;
      uint4 gv = make_uint4(0, 0, 0, 0);
      if (py >= 0 && py < H2 && px >= 0 && px < W2)
        gv = *reinterpret_cast<const uint4*>(
            g + (((size_t)v * H2 + py) * W2 + px) * kC + 8 * j);
      const int p00 = 2 * wi * kRW + 2 * wj;
      const int rows[4] = {p00, p00 + 1, p00 + kRW, p00 + kRW + 1};
      uint32_t q[4][4], out[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint4 u = *reinterpret_cast<const uint4*>(rtp + swz(rows[e], j));
        q[e][0] = u.x, q[e][1] = u.y, q[e][2] = u.z, q[e][3] = u.w;
      }
      const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
      route_window(q, gw, out);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint4*>(rtp + swz(rows[e], j)) =
            make_uint4(out[e][0], out[e][1], out[e][2], out[e][3]);
    }
  }
  bar_sync(3, 256);

  // 3. dx = conv3x3(dr, w9t): block b is dx rows 2 b, 2 b + 1; lane l
  //    gives ldmatrix row 16 warp + l % 16 of the block and channels
  //    8 (l / 16) + [0, 8) of each 16-channel step
  const int am = 16 * warp + (lane & 15);
  for (int pass = 0; pass < kPasses; ++pass) {
    if constexpr (ADD_T)
      if (pass == kEpiBufs / 2 && t == 0) {
        // the stores of blocks 0 and 1 have read their buffers: the last
        // two blocks' t, behind this pass's products
        asm volatile("cp.async.bulk.wait_group.read 2;" ::: "memory");
        load_t(kEpiBufs, 2 * kPasses, tbar + 16 * gi + 8);
      }
    float acc[2][kC / 2];
    int arow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = 4 * pass + 2 * gi + i;
      arow[i] = (2 * blk + am / 32 + 1) * kRW + am % 32 + 1;  // r pixel at tap (0, 0)
    }
    for (int tap = 0; tap < 9; ++tap, ++it) {
      mbar_wait(ring.full_bar(it), ring.parity(it));
      const uint32_t b = ring.stage(it) + kATile;
      uint32_t a[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = arow[i] + (tap / 3) * kRW + tap % 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[i][kk], rt + swz(p, 2 * kk + lane / 16));
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wgmma_n64_rs(acc[i], a[i][kk], smem_desc(b + 2048 * kk, kBBox >> 4, 1024 >> 4),
                       tap > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (t == 0) mbar_arrive(ring.empty_bar(it));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) fence_acc(acc[i]);

    // epilogue: K5's without bias or relu, stored by TMA
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 2 * pass + i;
      const uint32_t buf = epi + (k % kEpiBufs) * kEpiBuf;
      if (t == 0)  // the store issued from this buffer four blocks ago has read it
        asm volatile("cp.async.bulk.wait_group.read 3;" ::: "memory");
      bar_sync(1 + gi, 128);
      if constexpr (ADD_T) mbar_wait(tbar + 16 * gi + 8 * (k / kEpiBufs), 0);
      unsigned char* bp = smem + (buf - base);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* out =
              reinterpret_cast<__nv_bfloat162*>(bp + swz(r0 + 8 * h, j) + cq * 2);
          float v0 = acc[i][4 * j + 2 * h] + 0.0f;
          float v1 = acc[i][4 * j + 2 * h + 1] + 0.0f;
          if constexpr (ADD_T) {
            // dx rounded as without t, then the bf16 sum with t (in place)
            const float2 f = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
            const float2 tv = __bfloat1622float2(*out);
            v0 = f.x + tv.x;
            v1 = f.y + tv.y;
          }
          *out = __floats2bfloat162_rn(v0, v1);
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(1 + gi, 128);
      if (t == 0) {
        tma_store_4d(&dxmap, buf, 0, x0, y0 + 2 * block(k), v);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The route kernel: one thread per 2x2 window (rounded up: a window cut by
// the odd last row or column is a tail) and eight channels. A whole window:
// the four pixels of r and the window's g read with 16-byte loads, routed by
// route_window, the four pixels of dr stored with 16-byte stores. A tail: its
// pixels of dr set to +0. Consecutive threads take consecutive channel groups,
// then consecutive windows of a row, so a warp reads and writes whole runs
// of each of the window's two rows.
__global__ void __launch_bounds__(kRouteThreads) pool_route_kernel(
    const uint4* __restrict__ r, const uint4* __restrict__ g,
    uint4* __restrict__ dr, int H, int W, int C8, int wins_y, int wins_x,
    int threads) {
  const long long t = (long long)blockIdx.x * kRouteThreads + threadIdx.x;
  if (t >= threads) return;
  const int i = (int)t;
  const int j = i % C8;
  int w = i / C8;
  const int wj = w % wins_x;
  w /= wins_x;
  const int wi = w % wins_y;
  const int v = w / wins_y;
  const int y = 2 * wi, x = 2 * wj;
  // pixel (y + dy, x + dx) of view v, at 16-byte group j
  auto at = [&](int dy, int dx) {
    return (((size_t)v * H + y + dy) * W + x + dx) * C8 + j;
  };
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (y + 1 >= H || x + 1 >= W) {
    dr[at(0, 0)] = zero;
    if (x + 1 < W) dr[at(0, 1)] = zero;
    if (y + 1 < H) dr[at(1, 0)] = zero;
    return;
  }
  const size_t px[4] = {at(0, 0), at(0, 1), at(1, 0), at(1, 1)};
  uint32_t q[4][4], out[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint4 u = __ldg(r + px[e]);
    q[e][0] = u.x, q[e][1] = u.y, q[e][2] = u.z, q[e][3] = u.w;
  }
  const uint4 gv = __ldg(g + (((size_t)v * (H / 2) + wi) * (W / 2) + wj) * C8 + j);
  const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
  route_window(q, gw, out);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dr[px[e]] = make_uint4(out[e][0], out[e][1], out[e][2], out[e][3]);
}

}  // namespace

// dx [V, H, W, 64] of maxpool2(bf16(relu(conv3x3(x, w9) + bias))) for the
// pooled cotangent g [V, H / 2, W / 2, 64]; w9t is the flipped io-swapped
// kernel (K8). t [V, H, W, 64], the loss tap's cotangent of x, or NULL:
// dx = bf16(float(dx) + float(t)). tile_h x tile_w must be the kernel's dx
// tile, 24 x 32 (the wrapper states it too). Returns the launch's
// cudaError_t, or minus the CUresult of a tensor map that could not be
// encoded.
extern "C" int stylemesh_conv_relu_pool_bwd(const void* x, const void* w9,
                                            const void* w9t, const void* bias,
                                            const void* g, const void* t,
                                            void* dx, int V, int H, int W,
                                            int tile_h, int tile_w, void* stream) {
  if (tile_h != kTH || tile_w != kTW) return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  const void* kernel = t != nullptr ? (const void*)conv_relu_pool_bwd_kernel<true>
                                    : (const void*)conv_relu_pool_bwd_kernel<false>;
  // a runtime call first: it binds the device's context on this thread
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap, wtmap, dxmap, tmap = {};
  int res = encode_nhwc(&xmap, x, V, H, W, kC, kRW, kSubRows);
  if (res == 0) res = encode_w9(&wmap, w9, kC, kC);
  if (res == 0) res = encode_w9(&wtmap, w9t, kC, kC);
  if (res == 0) res = encode_nhwc(&dxmap, dx, V, H, W, kC, kTW, 2);
  if (res == 0 && t != nullptr) res = encode_nhwc(&tmap, t, V, H, W, kC, kTW, 2);
  if (res != 0) return -res;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const long long blocks = (long long)V * tiles_x * tiles_y;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (t != nullptr)
    conv_relu_pool_bwd_kernel<true><<<(unsigned)blocks, kThreads, kSmem, st>>>(
        xmap, wmap, wtmap, dxmap, (const float*)bias, (const bf16*)g, H, W,
        tiles_x, tiles_y, tmap);
  else
    conv_relu_pool_bwd_kernel<false><<<(unsigned)blocks, kThreads, kSmem, st>>>(
        xmap, wmap, wtmap, dxmap, (const float*)bias, (const bf16*)g, H, W,
        tiles_x, tiles_y, tmap);
  return (int)cudaGetLastError();
}

// dr [V, H, W, C] bf16, the backward of maxpool2 and of the relu before it,
// from the relu output r [V, H, W, C] and the pooled cotangent g [V, H / 2,
// W / 2, C] (bf16, channel-last): route_window's rule in every whole window,
// +0 in the odd last row and column. C must be a multiple of 8. One launch on
// `stream`, nothing allocated. Returns the launch's cudaError_t.
extern "C" int stylemesh_pool_route(const void* r, const void* g, void* dr,
                                    int V, int H, int W, int C, void* stream) {
  if (V < 0 || H < 0 || W < 0 || C <= 0 || C % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  const int wins_y = (H + 1) / 2, wins_x = (W + 1) / 2, C8 = C / 8;
  const long long threads = (long long)V * wins_y * wins_x * C8;
  if (threads > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((threads + kRouteThreads - 1) / kRouteThreads);
  pool_route_kernel<<<blocks, kRouteThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)r, (const uint4*)g, (uint4*)dr, H, W, C8, wins_y, wins_x,
      (int)threads);
  return (int)cudaGetLastError();
}

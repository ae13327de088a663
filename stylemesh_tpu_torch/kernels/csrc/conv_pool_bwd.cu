// K8: the input gradient of the 64-channel fused block tail
// maxpool2(bf16(relu(conv3x3(x, w) + b))), on the wgmma + TMA core of
// conv_core.cuh, from the pool's route codes that K6 wrote in the forward;
// and the route kernel, the pool's backward of the 128-channel tail by the
// same rule (at the end of this note).
//
// Replaces the TPU kernel
//   K8  ops/head_pallas.py::conv_relu_pool_bwd (_kernel_packed_bwd):
//       dx = conv3x3(pool_route(r, g), w9t), r = bf16(relu(conv3x3(x, w9) + b)),
//       g the pooled cotangent, w9t the flipped io-swapped kernel.
// The TPU kernel recomputes r on the tile. Here the forward keeps, instead
// of r, each window's route: K6's pool epilogue writes a 4-bit code per
// window and channel (conv_core.cuh's rule; 32 bytes a window, a sixteenth
// of r), and K8 reads the codes and g and runs only the transposed conv,
// optionally adding t, the loss tap's cotangent of x: dx = bf16(float(dx) +
// float(t)) then, the bf16 sum autograd would take. The routed gradient dr
// stays in shared memory; codes, g and t are read, only dx is written.
//
// Layouts: codes uint32 [V, H / 2, W / 2, 8] (word j: channels 8 j + [0, 8)),
// g bf16 [V, H / 2, W / 2, 64], dx and t bf16 [V, H, W, 64] (channel-last),
// w9t bf16 [9 * 64, 64] with rows in (dy, dx, ci) order. Stride 1, SAME zero
// padding.
//
// What bounds it on an H100: both, nearly. Per dx pixel it reads 8 bytes of
// codes and g, 128 of t, writes 128 of dx (1.95 GB a step at the bench's four
// conv1_2 levels, V = 4: 0.583 ms at 3.35 TB/s) and does one 64-channel conv
// (0.486 TFLOP, 0.491 ms at 989 TFLOP/s). So the copies, the routing and the
// tensor cores all have to stay busy at once; and at 64 channels an
// m64n64k16 product reads as many bytes of shared memory (its A and its B)
// as the tensor cores can take in, so the products must read fewer. The
// design:
// - Work items of kR x kSW = 16 x 64 dx pixels (one m64 block a row), two
//   streams a block (one block per SM, a persistent grid): consumer
//   warpgroup 1 + s with producer warps 2 s, 2 s + 1 walks every other item.
// - w9t resident: loaded once by TMA (9 boxes of 64 x 64, 72 KB).
// - The producer warps build the item's dr rows, each the strip plus one
//   ring column each side (66 pixels, one per 128-byte swizzled row), a
//   window row (two dr rows) at a time, into a ring of 4 rows (two
//   windows' rows, an empty and a full mbarrier each), loading the next
//   window row's codes and g while they route the last. A pixel takes g's
//   value where its window's code names it and +0 elsewhere; pixels of no
//   whole window (the odd tail, outside the image) take +0, the transposed
//   conv's padding.
// - The consumers walk the dr rows q = 0 .. kR + 1 as a wavefront: each
//   k16 step's A fragment of row q (ldmatrix at any pixel offset, into
//   registers that wgmma takes) serves block q at dy = 0, block q - 1 at
//   dy = 1 and block q - 2 at dy = 2, one wgmma group of three
//   m64n64k16 products. That reads A once for three products, and each
//   block still sums its taps in K5's order (dy, dx, then 16 channels a
//   product), so dx equals K5 on the routed map bit for bit. Three
//   accumulator sets rotate over the blocks; A loads into kABufs = 4
//   register sets in turn, so three groups run while the next one's A
//   loads. Nothing else runs in the consumers while products are in
//   flight (t's copies wait for the epilogue): wgmma reads its A
//   registers after the compiler takes them for free.
// - Block q - 2 is complete after row q: its epilogue (K5's without bias or
//   relu) goes to one of 5 8 KB swizzled slots and is stored by TMA
//   (clipped at the map's edge) while the next rows' products run. With t,
//   block q + 2's t is copied into its slot (cp.async, 16 bytes a copy, 5
//   slots) at the end of that epilogue, while no wgmma runs, and summed in
//   place in its own epilogue, two rows later.
// Shared memory: w9t 72 KB, 2 x 5 slots 80 KB, 2 rings of 4 dr rows 66 KB:
// 218 KB, one block per SM.
//
// The route kernel (stylemesh_pool_route): the 128-channel tail's backward
// before K5, dr = pool_route(r, g) from the saved relu output r (K7's pre-pool
// map) and the pooled cotangent g, by conv_core.cuh's rule (route_window). It
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

constexpr int kC = 64;                     // channels of g, dr and dx
constexpr int kSW = 64;                    // dx strip width: one m64 block a row
constexpr int kRW = kSW + 2;               // dr row: the strip and one ring column each side
constexpr int kR = 16;                     // dx rows of a work item
constexpr int kTimes = kR + 2;             // dr rows of an item, one a time step
constexpr int kUnits = kR / 2 + 2;         // window rows over those dr rows
constexpr int kSub = 12;                   // k16 steps of a dr row: 3 dx x 4 kk
constexpr int kABufs = 4;                  // A register sets in turn
constexpr int kRowBytes = kRW * 128;
constexpr int kRing = 4 * kRowBytes;       // a stream's dr rows, two units
constexpr int kSlots = 5;                  // t / dx slots of a stream
constexpr int kSlot = 64 * kC * 2;         // one row of 64 pixels: 8 KB
constexpr int kW9 = 9 * kBBox;             // w9t, resident
constexpr int kWinCols = kSW / 2 + 2;      // windows across a dr row pair
constexpr int kUnitItems = kWinCols * 8;   // a unit's (window, 8 channels) items
constexpr int kPThreads = 64;              // producer threads of a stream
constexpr int kItemsPerThread = (kUnitItems + kPThreads - 1) / kPThreads;
// mbarriers of a stream: full[2], empty[2]
constexpr int kBars = 4 * 8;
constexpr int kSmem = kW9 + 2 * kSlots * kSlot + 2 * kRing + 2 * kBars + 8 + 1024;

static_assert(kTimes % 3 == 0, "the time loop is unrolled by 3 (accumulator sets)");
static_assert(kSub % kABufs == 0 && kUnits % 2 == 0,
              "buffer indices repeat from item to item");
static_assert(kSmem <= 232448, "shared memory of one block");
constexpr int kRouteThreads = 256;  // the route kernel's block

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// Keeps the registers of an A fragment allocated up to this point: wgmma
// reads them asynchronously, after the compiler takes them for dead.
__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Work item `item` of a launch: dx rows y0 .. y0 + kR of image v, columns
// x0 .. x0 + kSW.
struct Item {
  int v, y0, x0;
};

__device__ __forceinline__ Item item_at(int item, int strips, int chunks) {
  Item c;
  c.x0 = (item % strips) * kSW;
  item /= strips;
  c.y0 = (item % chunks) * kR;
  c.v = item / chunks;
  return c;
}

// ADD_T: t (`tcot`) is added to dx. Two streams a block: stream s (consumer
// warpgroup 1 + s, fed by producer warps 2 s, 2 s + 1) takes the items
// 2 blockIdx.x + s, then 2 gridDim.x further on, ...
template <bool ADD_T>
__global__ void __launch_bounds__(kThreads, 1) conv_relu_pool_bwd_kernel(
    const __grid_constant__ CUtensorMap wtmap,
    const __grid_constant__ CUtensorMap dxmap,
    const bf16* __restrict__ tcot, const uint32_t* __restrict__ codes,
    const bf16* __restrict__ g, int H, int W, int strips, int chunks, int items) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t w9 = base, slots = w9 + kW9, rings = slots + 2 * kSlots * kSlot;
  const uint32_t bars = rings + 2 * kRing, wbar = bars + 2 * kBars;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < 2; ++st) {
      const uint32_t b = bars + st * kBars;
      for (int k = 0; k < 2; ++k) {
        mbar_init(b + 8 * k, kPThreads);  // full: every producer thread
        mbar_init(b + 16 + 8 * k, 128);   // empty: every consumer thread
      }
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    // Stream st's dr rows: unit u of an item covers dr rows 2 u - 1 and 2 u
    // (image rows y0 - 2 + 2 u, y0 - 1 + 2 u: window row y0 / 2 - 1 + u),
    // and lands in ring rows (dr row) % 4, slot u % 2.
    const int st = threadIdx.x / kPThreads, p = threadIdx.x % kPThreads, j = p % 8;
    if (threadIdx.x == 0) {
      mbar_expect_tx(wbar, kW9);
      for (int tap = 0; tap < 9; ++tap)
        tma_load_2d(w9 + tap * kBBox, &wtmap, wbar, 0, tap * kC);
    }
    const uint32_t full = bars + st * kBars, empty = full + 16;
    unsigned char* ring = smem + (rings - base) + st * kRing;
    const int H2 = H / 2, W2 = W / 2;
    // this thread's items of unit u of `item`: window column p / 8 + 8 k
    auto load = [&](int item, int u, uint4 (&gv)[kItemsPerThread],
                    uint32_t (&cv)[kItemsPerThread]) {
      const Item c = item_at(item, strips, chunks);
      const int py = c.y0 / 2 - 1 + u;
#pragma unroll
      for (int k = 0; k < kItemsPerThread; ++k) {
        const int wc = p / 8 + (kPThreads / 8) * k, px = c.x0 / 2 - 1 + wc;
        gv[k] = make_uint4(0u, 0u, 0u, 0u);
        cv[k] = 0u;
        if (wc < kWinCols && py >= 0 && py < H2 && px >= 0 && px < W2) {
          const size_t win = ((size_t)c.v * H2 + py) * W2 + px;
          gv[k] = __ldg(reinterpret_cast<const uint4*>(g + win * kC) + j);
          cv[k] = __ldg(codes + win * 8 + j);
        }
      }
    };
    auto build = [&](int un, int u, const uint4 (&gv)[kItemsPerThread],
                     const uint32_t (&cv)[kItemsPerThread]) {
      mbar_wait(empty + 8 * (un & 1), ((un >> 1) & 1) ^ 1);  // its slot was read
#pragma unroll
      for (int k = 0; k < kItemsPerThread; ++k) {
        const int wc = p / 8 + (kPThreads / 8) * k;
        if (wc >= kWinCols) continue;
        const uint32_t gw[4] = {gv[k].x, gv[k].y, gv[k].z, gv[k].w};
        uint32_t out[4][4];
        route_codes(cv[k], gw, out);
        // the window's pixel e: dr row 2 u - 1 + e / 2, column 2 wc - 1 + e % 2
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 2 * u - 1 + e / 2, col = 2 * wc - 1 + e % 2;
          if (row >= 0 && row < kTimes && col >= 0 && col < kRW)
            *reinterpret_cast<uint4*>(ring + (row & 3) * kRowBytes + swz(col, j)) =
                make_uint4(out[e][0], out[e][1], out[e][2], out[e][3]);
        }
      }
      mbar_arrive(full + 8 * (un & 1));
    };
    // units in order, each loaded while the one before is built
    uint4 ga[kItemsPerThread], gb[kItemsPerThread];
    uint32_t ca[kItemsPerThread], cb[kItemsPerThread];
    int item = 2 * blockIdx.x + st, u = 0, un = 0;
    auto next = [&](int& it, int& uu) {
      if (++uu == kUnits) uu = 0, it += 2 * gridDim.x;
    };
    if (item < items) load(item, u, ga, ca);
    while (item < items) {
      int it2 = item, u2 = u;
      next(it2, u2);
      if (it2 < items) load(it2, u2, gb, cb);
      build(un++, u, ga, ca);
      item = it2, u = u2;
      if (item >= items) break;
      next(it2, u2);
      if (it2 < items) load(it2, u2, ga, ca);
      build(un++, u, gb, cb);
      item = it2, u = u2;
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  // Stream st walks its items' dr rows q = 0 .. kR + 1 (image row y0 - 1 +
  // q), one a time step: each k16 step's A fragment of row q serves up to
  // three m64 blocks (dx rows of 64 pixels) at once, block q at dy 0, block
  // q - 1 at dy 1, block q - 2 at dy 2, so each block still sums its taps in
  // K5's order (dy, dx, then channels). Block q - 2 is then complete: its
  // epilogue ends the time step, and its accumulators take block q + 1.
  const int st = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  // lane l gives ldmatrix row 16 warp + l % 16 of a block (its pixel) and
  // channels 8 (l / 16) + [0, 8) of each 16-channel step
  const int acol = 16 * warp + (lane & 15);
  const uint32_t full = bars + st * kBars, empty = full + 16;
  const uint32_t ring = rings + st * kRing, slot0 = slots + st * kSlots * kSlot;
  unsigned char* slotp = smem + (slot0 - base);
  mbar_wait(wbar, 0);
  int un = 0;   // units consumed by this stream
  int blk = 0;  // blocks begun by this stream
  for (int item = 2 * blockIdx.x + st; item < items; item += 2 * gridDim.x) {
    const Item c = item_at(item, strips, chunks);
    float acc[3][kC / 2];
    uint32_t a[kABufs][4];
    // the A fragment of k16 step k of dr row q into a[k % kABufs]; the first
    // of a unit's rows waits for the unit, the last one's frees it
    auto load_a = [&](int q, int k) {
      if (k == 0 && (q == 0 || (q & 1)))
        mbar_wait(full + 8 * ((un + (q + 1) / 2) & 1), ((un + (q + 1) / 2) >> 1) & 1);
      const int dx = k / 4, kk = k % 4;
      ldmatrix_x4(a[k % kABufs],
                  ring + (q & 3) * kRowBytes + swz(acol + dx, 2 * kk + lane / 16));
      if (k == kSub - 1 && (q == 0 || !(q & 1) || q == kTimes - 1))
        mbar_arrive(empty + 8 * ((un + (q + 1) / 2) & 1));
    };
    // block b's t into its slot (16 bytes a copy, 4 a thread), one group a
    // call; called while no wgmma runs
    auto copy_t = [&](int b) {
      const int y = c.y0 + b;
      if (b < kR && y < H)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = t + 128 * i, px = ch / 8, x = c.x0 + px;
          if (x < W)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                             slot0 + ((blk + b) % kSlots) * kSlot + swz(px, ch % 8)),
                         "l"(tcot + (((size_t)c.v * H + y) * W + x) * kC + 8 * (ch % 8))
                         : "memory");
        }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    if constexpr (ADD_T) {
      // blocks 0 .. 3's t, once the last item's stores have read the slots
      if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      bar_sync(1 + st, 128);
      for (int b = 0; b < 4; ++b) copy_t(b);
    }
    load_a(0, 0);
    for (int q0 = 0; q0 < kTimes; q0 += 3) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int q = q0 + r;
#pragma unroll
        for (int k = 0; k < kSub; ++k) {
          // B of tap (0, dx), computed here: kept live across the body, the
          // 36 descriptors would not fit in registers
          uint32_t b;
          asm volatile("mov.u32 %0, %1;" : "=r"(b) : "r"(w9 + (k / 4) * kBBox + 2048 * (k % 4)));
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          // block q at dy 0 (its first product overwrites), q - 1 at dy 1,
          // q - 2 at dy 2. Every product is issued: a block outside the
          // item (q - 1 or q - 2 below 0, q or q - 1 past kR - 1) sums into
          // an accumulator set that no block holds then, whose next block
          // begins by overwriting it.
          wgmma_n64_rs(acc[r], a[k % kABufs], smem_desc(b, kBBox >> 4, 1024 >> 4), k > 0);
          wgmma_n64_rs(acc[(r + 2) % 3], a[k % kABufs],
                       smem_desc(b + 3 * kBBox, kBBox >> 4, 1024 >> 4), 1);
          wgmma_n64_rs(acc[(r + 1) % 3], a[k % kABufs],
                       smem_desc(b + 6 * kBBox, kBBox >> 4, 1024 >> 4), 1);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the group kABufs - 1 back is done: its A set takes the next step
          asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kABufs - 1) : "memory");
          fence_a(a[(k + 1) % kABufs]);
          if (k + 1 < kSub)
            load_a(q, k + 1);
          else if (q + 1 < kTimes)
            load_a(q + 1, 0);
        }
        if (q < 2) continue;
        // block q - 2 is complete: K5's epilogue without bias or relu into
        // its slot, stored by TMA
        const int bq = blk + q - 2;
        float (&done)[kC / 2] = acc[(r + 1) % 3];
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(done);
#pragma unroll
        for (int u = 0; u < kABufs; ++u) fence_a(a[u]);
        // this thread's copies of block q - 2's t are done (those of blocks
        // q - 1 .. q + 1 may run on); every store issued so far has read its
        // slot, block q - 3's the last, whose slot block q + 2 takes below
        if constexpr (ADD_T) asm volatile("cp.async.wait_group 3;" ::: "memory");
        if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        bar_sync(1 + st, 128);
        unsigned char* sp = slotp + (bq % kSlots) * kSlot;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* out =
                reinterpret_cast<__nv_bfloat162*>(sp + swz(r0 + 8 * h, j) + cq * 2);
            float v0 = done[4 * j + 2 * h] + 0.0f;
            float v1 = done[4 * j + 2 * h + 1] + 0.0f;
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
        bar_sync(1 + st, 128);
        if (t == 0) {
          tma_store_4d(&dxmap, slot0 + (bq % kSlots) * kSlot, 0, c.x0, c.y0 + q - 2, c.v);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
        if constexpr (ADD_T) copy_t(q + 2);
      }
    }
    un += kUnits;
    blk += kR;
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
// pooled cotangent g [V, H / 2, W / 2, 64], from the forward's route codes
// [V, H / 2, W / 2, 8] (K6's, uint32); w9t is the flipped io-swapped kernel
// (K8). t [V, H, W, 64], the loss tap's cotangent of x, or NULL:
// dx = bf16(float(dx) + float(t)). tile_h x tile_w must be the kernel's
// work item, 16 x 64 (the wrapper states it too). Returns the launch's
// cudaError_t, or minus the CUresult of a tensor map that could not be
// encoded.
extern "C" int stylemesh_conv_relu_pool_bwd(const void* codes, const void* g,
                                            const void* w9t, const void* t,
                                            void* dx, int V, int H, int W,
                                            int tile_h, int tile_w, void* stream) {
  if (tile_h != kR || tile_w != kSW || V < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  const void* kernel = t != nullptr ? (const void*)conv_relu_pool_bwd_kernel<true>
                                    : (const void*)conv_relu_pool_bwd_kernel<false>;
  // a runtime call first: it binds the device's context on this thread
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap wtmap, dxmap;
  int res = encode_w9(&wtmap, w9t, kC, kC);
  if (res == 0) res = encode_nhwc(&dxmap, dx, V, H, W, kC, kSW, 1);
  if (res != 0) return -res;
  const int strips = (W + kSW - 1) / kSW, chunks = (H + kR - 1) / kR;
  const long long items = (long long)V * strips * chunks;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const long long pairs = (items + 1) / 2;  // two streams a block
  const int blocks = (int)(pairs < sm_count() ? pairs : sm_count());
  cudaStream_t st = (cudaStream_t)stream;
  if (t != nullptr)
    conv_relu_pool_bwd_kernel<true><<<blocks, kThreads, kSmem, st>>>(
        wtmap, dxmap, (const bf16*)t, (const uint32_t*)codes, (const bf16*)g, H, W,
        strips, chunks, (int)items);
  else
    conv_relu_pool_bwd_kernel<false><<<blocks, kThreads, kSmem, st>>>(
        wtmap, dxmap, nullptr, (const uint32_t*)codes, (const bf16*)g, H, W, strips,
        chunks, (int)items);
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

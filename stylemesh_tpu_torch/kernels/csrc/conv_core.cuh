// The bf16 3x3 convolution core shared by conv_gemm.cu (K5 / K9, K6 / K7)
// and conv_pool_bwd.cu (K8): TMA copies into a ring of stages, mbarriers,
// and one implicit-GEMM mainloop of Hopper's warpgroup MMA (wgmma); and the
// max pool's route rule of the block tails (K6's codes, K8, the route
// kernel).
//
// The mainloop fixes the sum: K runs tap-major (dy, dx), one tap times 64
// input channels (kBK, 128 bytes: one row of the 128-byte swizzle) per
// step, each step four m64nBNk16 products, the tile's first product
// overwriting the accumulators. Every kernel that computes a conv value
// with the same BN therefore gets the same float32 sum, bit for bit,
// whatever pixel box the value sits in (a row of the product depends on
// its own A row only).
//
// Layouts: x bf16 [V, H, W, Cin] (channel-last), the kernel as the bf16
// matrix w9 [9 * Cin, Cout] with rows in (dy, dx, ci) order. A stage holds
// an A tile (pixels x 64 channels, a TMA box of the input shifted by the
// tap, 128-byte swizzled, one pixel per 128-byte row) and B, BN / 64
// boxes of 64 x 64 of w9 as stored (N contiguous, read with wgmma's
// transpose bit).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 64;               // channels per K step (128 bytes)
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kABlock = 64 * kBK * 2; // the A rows of one m64 block: 8 KB
constexpr int kBBox = kBK * 64 * 2;   // one 64 x 64 box of w9: 8 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Named barrier `id` over `threads` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The byte offset of 16-byte chunk j of row `row` in a 128-byte-swizzled
// buffer of 128-byte rows (1 KB aligned): TMA's and wgmma's layout.
__device__ __forceinline__ uint32_t swz(int row, int j) {
  return row * 128 + ((j ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile; the byte
// offsets in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

// D[64 x N] = A[64 x 16] (K-major) * B[16 x N] (N-major, transpose bit)
// + (accumulate ? D : 0), float32 accumulators, bf16 operands from shared
// memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same product with A from registers: the four registers of an
// m16k16 fragment per warp (mma.sync's A layout, as ldmatrix.x4 leaves it).
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                      int accumulate) {
  if constexpr (BN == 64) wgmma_n64(d, da, db, accumulate);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, accumulate);
  else wgmma_n256(d, da, db, accumulate);
}

// Keeps the compiler from moving reads of the accumulators before the wait
// for the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A ring of STAGES stages of STAGE bytes from `base` (1 KB aligned), with a
// full and an empty mbarrier per stage. K steps are numbered over the
// block's whole life (`it`), so the producer and each consumer walk the
// ring in the same order.
template <int STAGE, int STAGES>
struct Ring {
  uint32_t base, full, empty;  // shared addresses
  __device__ __forceinline__ uint32_t stage(int it) const {
    return base + (it % STAGES) * STAGE;
  }
  __device__ __forceinline__ uint32_t full_bar(int it) const {
    return full + 8 * (it % STAGES);
  }
  __device__ __forceinline__ uint32_t empty_bar(int it) const {
    return empty + 8 * (it % STAGES);
  }
  __device__ __forceinline__ uint32_t parity(int it) const {
    return (it / STAGES) & 1;
  }
  // one thread: one producer, `consumers` arrivals to release a stage
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Producer: wait for stage `it` to be free and arm it for `bytes`;
  // returns the stage's address.
  __device__ __forceinline__ uint32_t acquire(int it, uint32_t bytes) const {
    mbar_wait(empty_bar(it), parity(it) ^ 1);
    mbar_expect_tx(full_bar(it), bytes);
    return stage(it);
  }
};

// Producer (one thread): the 9 * Cin / 64 K steps of one conv tile. A is
// the box of `a_bytes` at pixel (x0, y0) of image v shifted by the tap
// (dy - 1, dx - 1), TMA's zero fill outside the map being the SAME
// padding; B the BN columns of w9 from n0, at `a_tile` bytes into the
// stage.
template <int BN, class R>
__device__ __forceinline__ void produce_conv(const R& ring, int& it,
                                             const CUtensorMap* xmap,
                                             const CUtensorMap* wmap, int cin,
                                             int x0, int y0, int v, int n0,
                                             uint32_t a_bytes, uint32_t a_tile) {
  const int chunks = cin / kBK;
  for (int k = 0; k < 9 * chunks; ++k, ++it) {
    const uint32_t a = ring.acquire(it, a_bytes + BN / 64 * kBBox);
    const uint32_t bar = ring.full_bar(it);
    const int tap = k / chunks, c0 = (k % chunks) * kBK;
    tma_load_4d(a, xmap, bar, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, v);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_2d(a + a_tile + j * kBBox, wmap, bar, n0 + 64 * j, tap * cin + c0);
  }
}

// Consumer warpgroup (thread t of 128): the K steps of one conv tile into
// acc[MB][BN / 2], for the MB m64 blocks of A at `a_off` bytes into each
// stage, B at `b_off`. One wgmma group stays in flight while the next stage
// arrives; each stage is released once the group that read it is done.
template <int MB, int BN, class R>
__device__ __forceinline__ void consume_conv(const R& ring, int& it,
                                             float (&acc)[MB][BN / 2], int steps,
                                             uint32_t a_off, uint32_t b_off,
                                             int t) {
  for (int k = 0; k < steps; ++k, ++it) {
    mbar_wait(ring.full_bar(it), ring.parity(it));
    const uint32_t a = ring.stage(it) + a_off, b = ring.stage(it) + b_off;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < MB; ++i)
        // A: 8-row groups 1 KB apart, K advanced 32 bytes inside the
        // swizzle row; B: 16 K rows (2 KB) per step, 64-wide N atoms 8 KB
        // apart. The tile's first product overwrites the accumulators.
        wgmma<BN>(acc[i], smem_desc(a + i * kABlock + 32 * kk, 1, 1024 >> 4),
                  smem_desc(b + 2048 * kk, kBBox >> 4, 1024 >> 4),
                  k > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the previous step's group has finished reading its stage
    if (k > 0 && t == 0) mbar_arrive(ring.empty_bar(it - 1));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < MB; ++i) fence_acc(acc[i]);
  if (t == 0) mbar_arrive(ring.empty_bar(it - 1));
}

// ----------------------------------------------------- the pool's route

// The backward rule of the block tails' 2x2 max pool and the relu before it:
// K6's pool epilogue (conv_gemm.cu) writes it as codes, K8 (conv_pool_bwd.cu)
// reads them, and the route kernel applies it to a saved pre-pool map.
//
// Eight channels of one window at a time: q[e] is the window's pixel e in
// raster order ((0,0), (0,1), (1,0), (1,1)) and g the window's cotangent,
// eight bf16 each (channel c in bits [16 (c % 2), 16 (c % 2) + 16) of word
// c / 2). Each channel's cotangent, its bits, goes to the first maximum in
// that order where that value is > 0; every other element gets bf16 +0. A
// channel whose window holds a NaN routes nothing: its maximum is NaN then
// and equals no element (torch.maximum, then ==).
//
// A code word holds the route of eight channels: channel c's code, in bits
// [4 c, 4 c + 4), is the pixel e that takes its cotangent, or kNoRoute.

constexpr uint32_t kNoRoute = 4;  // every code word is then below 2^31

__device__ __forceinline__ uint32_t window_codes(const uint32_t (&q)[4][4]) {
  uint32_t code = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // channel c's bf16, widened to float32 exactly
    const int wd = c / 2, sh = 16 * (c % 2);
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(((q[e][wd] >> sh) & 0xFFFFu) << 16);
    const float top = fmaxf(fmaxf(f[0], f[1]), fmaxf(f[2], f[3]));
    uint32_t k = kNoRoute;
    if (!(isnan(f[0]) || isnan(f[1]) || isnan(f[2]) || isnan(f[3])))
#pragma unroll
      for (int e = 3; e >= 0; --e)
        if (f[e] == top && f[e] > 0.0f) k = e;  // the last set is the first
    code |= k << (4 * c);
  }
  return code;
}

// out[e]: the eight channels of g whose code is e, +0 in the others.
__device__ __forceinline__ void route_codes(uint32_t code, const uint32_t (&g)[4],
                                            uint32_t (&out)[4][4]) {
#pragma unroll
  for (int wd = 0; wd < 4; ++wd) {
    const uint32_t lo = (code >> (8 * wd)) & 0xFu, hi = (code >> (8 * wd + 4)) & 0xFu;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e][wd] = g[wd] & ((lo == (uint32_t)e ? 0x0000FFFFu : 0u) |
                            (hi == (uint32_t)e ? 0xFFFF0000u : 0u));
  }
}

__device__ __forceinline__ void route_window(const uint32_t (&q)[4][4],
                                             const uint32_t (&g)[4],
                                             uint32_t (&out)[4][4]) {
  route_codes(window_codes(q), g, out);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime: no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with a 128-byte-swizzled box; returns the CUresult.
inline int encode(CUtensorMap* map, const void* ptr, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                 const_cast<void*>(ptr), dims, strides, box, ones,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The map of a channel-last bf16 activation [V, H, W, C], cut in boxes of
// 64 channels x box_w x box_h pixels of one image.
inline int encode_nhwc(CUtensorMap* map, const void* ptr, int V, int H, int W,
                       int C, int box_w, int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)V};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {kBK, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  return encode(map, ptr, 4, dims, strides, box);
}

// The map of w9 [9 * Cin, Cout], in 64 x 64 boxes.
inline int encode_w9(CUtensorMap* map, const void* w9, int cin, int cout) {
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)9 * cin};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t box[2] = {64, kBK};
  return encode(map, w9, 2, dims, strides, box);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 1;
  }
  return n;
}

}  // namespace

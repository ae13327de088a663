// K5 / K9: the bf16 VGG trunk's 3x3 convolution as an implicit GEMM on
// Hopper's warpgroup MMA (wgmma), fed by a TMA pipeline.
//
// Replaces the TPU kernels
//   K5  ops/conv_pallas.py::_conv3x3_v2_raw (_conv_kernel_v2), reached through
//       conv3x3_v2: y = bf16(act(conv3x3(x, w) + b)), act = relu or identity;
//       also every trunk input gradient (flipped io-swapped kernel, b = 0,
//       relu off);
//   K9  ops/conv_pallas.py::conv3x3_mxu: y = bf16(conv3x3(x, w)), and its
//       conv3x3_frozen VJP. K9 is this entry with bias NULL and relu off, so
//       it equals K5 without bias and relu bit for bit.
//
// Layouts: x bf16 [V, H, W, Cin] (channel-last), the kernel as the bf16
// matrix w9 [9 * Cin, Cout] with rows in (dy, dx, ci) order (an HWIO kernel
// reshaped), bias float32 [Cout] or NULL. Stride 1, SAME zero padding.
// Cin and Cout are multiples of 64.
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
// - A persistent grid, one block per SM: the producer fills the ring for a
//   block's next tile during its epilogue. Tiles run N-fastest, so the N
//   tiles of one pixel box run together and share the box in L2.
//
// K6-K8 stay on the WMMA core of conv.cu: K8 recomputes K6's activations
// bit for bit to route the pool's gradient as the forward did, so the three
// must keep one sum order and move together.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBK = 64;               // channels per K step (128 bytes)
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kABlock = 64 * kBK * 2; // the A rows of one m64 block: 8 KB
constexpr int kBBox = kBK * 64 * 2;   // one 64 x 64 box of w9: 8 KB
constexpr int kRing = 196608;         // bytes of the stage ring
constexpr int kEpiBuf = 64 * 64 * 2;  // one m64 block x 64 channels: 8 KB
constexpr int kEpiBytes = 2 * 2 * kEpiBuf;  // two buffers per consumer warpgroup

// A tile: MB m64 blocks per consumer warpgroup (128 MB output pixels) times
// BN output channels.
template <int MB, int BN>
struct Tile {
  static constexpr int kATile = 2 * MB * kABlock;
  static constexpr int kStage = kATile + BN / 64 * kBBox;
  static constexpr int kStages = kRing / kStage;
  static constexpr int kSmem = kStages * kStage + kEpiBytes + 16 * kStages + 1024;
};

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

// A persistent block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// Warpgroup 0 produces (one thread issues the TMA loads of every K step of
// every tile, as far ahead as the ring allows), warpgroups 1 and 2 consume.
template <int MB, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_gemm_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
    int H, int W, int cin, int cout, int box_h,
    int box_w, int relu, int tiles) {
  using T = Tile<MB, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1 KB aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t epi = base + T::kStages * T::kStage;
  const uint32_t full = epi + kEpiBytes;
  const uint32_t empty = full + 8 * T::kStages;
  const int chunks = cin / kBK;
  const int steps = 9 * chunks;  // K steps of a tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == 0) {
      int it = 0;  // K steps issued by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileCoords c = tile_coords<BN>(tile, H, W, cout, box_h, box_w);
        for (int k = 0; k < steps; ++k, ++it) {
          const int s = it % T::kStages;
          mbar_wait(empty + 8 * s, ((it / T::kStages) & 1) ^ 1);
          const uint32_t a = base + s * T::kStage, bar = full + 8 * s;
          mbar_expect_tx(bar, T::kStage);
          const int tap = k / chunks, c0 = (k % chunks) * kBK;
          tma_load_4d(a, &xmap, bar, c0, c.x0 + tap % 3 - 1, c.y0 + tap / 3 - 1,
                      c.v);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(a + T::kATile + j * kBBox, &wmap, bar, c.n0 + 64 * j,
                        tap * cin + c0);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int g = wg - 1;  // rows [64 MB g, 64 MB (g + 1)) of each tile
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
    const uint32_t out0 = epi + g * 2 * kEpiBuf;  // this warpgroup's two buffers
    int nbuf = 0;
    float acc[MB][BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const TileCoords c = tile_coords<BN>(tile, H, W, cout, box_h, box_w);
      for (int k = 0; k < steps; ++k, ++it) {
        const int s = it % T::kStages;
        mbar_wait(full + 8 * s, (it / T::kStages) & 1);
        const uint32_t a = base + s * T::kStage + g * MB * kABlock;
        const uint32_t b = base + s * T::kStage + T::kATile;
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
        if (k > 0 && t == 0) mbar_arrive(empty + 8 * ((it - 1) % T::kStages));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < MB; ++i) fence_acc(acc[i]);
      if (t == 0) mbar_arrive(empty + 8 * ((it - 1) % T::kStages));

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
        asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
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
            *reinterpret_cast<__nv_bfloat162*>(bp + rr * 128 + ((j ^ (rr & 7)) << 4) +
                                               cq * 2) = __floats2bfloat162_rn(v0, v1);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
        if (t == 0) {
          const int r = (g * MB + i) * 64;  // first tile row of the block
          tma_store_4d(&ymap, buf, c.n0 + 64 * p, c.x0 + r % box_w, c.y0 + r / box_w,
                       c.v);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
        nbuf ^= 1;
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime: no -lcuda.
EncodeTiled encode_tiled() {
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
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                 const_cast<void*>(ptr), dims, strides, box, ones,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int sm_count() {
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

template <int MB, int BN>
int launch(const void* x, const void* w9, const void* bias, void* y, int V,
           int H, int W, int cin, int cout, int relu, int box_h, int box_w,
           cudaStream_t st) {
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward runs on a thread of its own) before
  // libcuda encodes the tensor maps
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_gemm_kernel<MB, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<MB, BN>::kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)V};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)W * cin * 2,
                                  (cuuint64_t)H * W * cin * 2};
  const cuuint32_t xbox[4] = {kBK, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  int res = encode(&xmap, x, 4, xdims, xstrides, xbox);
  if (res != 0) return -res;
  const cuuint64_t wdims[2] = {(cuuint64_t)cout, (cuuint64_t)9 * cin};
  const cuuint64_t wstrides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t wbox[2] = {64, kBK};
  res = encode(&wmap, w9, 2, wdims, wstrides, wbox);
  if (res != 0) return -res;
  // y by m64 blocks: 64 pixels of the box (whole rows of a box narrower
  // than 64, else 64 columns of one row) times 64 channels
  const cuuint64_t ydims[4] = {(cuuint64_t)cout, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)V};
  const cuuint64_t ystrides[3] = {(cuuint64_t)cout * 2, (cuuint64_t)W * cout * 2,
                                  (cuuint64_t)H * W * cout * 2};
  const int sub_w = box_w < 64 ? box_w : 64;
  const cuuint32_t ybox[4] = {64, (cuuint32_t)sub_w, (cuuint32_t)(64 / sub_w), 1};
  CUtensorMap ymap;
  res = encode(&ymap, y, 4, ydims, ystrides, ybox);
  if (res != 0) return -res;
  const long long tiles = (long long)V * ((H + box_h - 1) / box_h) *
                          ((W + box_w - 1) / box_w) * (cout / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(tiles < sm_count() ? tiles : sm_count());
  conv3x3_gemm_kernel<MB, BN><<<blocks, kThreads, Tile<MB, BN>::kSmem, st>>>(
      xmap, wmap, ymap, (const float*)bias, H, W, cin, cout, box_h, box_w,
      relu, (int)tiles);
  return (int)cudaGetLastError();
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
    return launch<1, 256>(x, w9, bias, y, V, H, W, cin, cout, relu, box_h, box_w, st);
  if (block_n == 128)
    return launch<2, 128>(x, w9, bias, y, V, H, W, cin, cout, relu, box_h, box_w, st);
  return launch<2, 64>(x, w9, bias, y, V, H, W, cin, cout, relu, box_h, box_w, st);
}

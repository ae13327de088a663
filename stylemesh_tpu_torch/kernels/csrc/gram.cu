// K3 / K4: fused multi-mask Gram sums and their backward, on Hopper's
// warpgroup MMA (wgmma) fed by TMA (the primitives of conv_core.cuh).
//
// Replaces the TPU kernels ops/gram_pallas.py::_grams_fwd_pallas
// (_gram_kernel) and ops/gram_pallas.py::_grams_bwd_pallas (_gram_bwd_kernel),
// reached through ops/gram_pallas.py::masked_gram_sums.
//
//   K3:  G[v, k] = sum_p m[v, k, p] * f[v, p]^T f[v, p]       [V, K, C, C] f32
//   K4:  dF[v, p] = sum_k m[v, k, p] * (S[v, k] f[v, p])      [V, P, C] bf16
//
// f is bf16 [V, P, C] (unpadded, C a multiple of 64), the masks bf16 0/1
// [V, K, P] with K <= 2, and S = bf16(dG + dG^T), a symmetric [V, K, C, C].
// bf16 x bf16 products are exact in the float32 accumulator, so both kernels
// compute the TPU kernels' function up to the order of the float32 sums.
//
// What bounds them on an H100: each does 2 * K * P * C^2 flops per view on
// 2 * P * C bytes of features, K * C flops a byte: 128 at C = 64 (below the
// card's ~295 bf16 flops per HBM byte: memory-bound), 256 at C = 128, 512
// and more from C = 256 (tensor-core bound). So a pixel tile is read from
// HBM once per block that needs it, and the products run on wgmma.
//
// Common shape: a persistent or split grid of 384-thread blocks. Warp 0
// produces: its lane 0 issues the TMA loads of a ring of stages (f tiles of
// 64 channels x 64 or 128 pixels, one pixel per 128-byte swizzled row, the
// conv core's A layout; TMA's zero fill covers the ragged pixel edge), and
// all 32 lanes copy the tile's mask values into the stage and flag each
// mask that is nonzero somewhere in the tile; the stage's full barrier
// waits for the bytes and those 32 arrivals. Two consumer warpgroups read
// the masked operand from shared memory into registers with ldmatrix,
// multiply it by the masks there (bf16 x 0/1, exact) and issue wgmma with A
// from registers. A tile whose masks are all zero issues no product.
//
// K3 (per (v, k) a C x C Gram, the contraction over pixels):
// - Output tiles of 64 rows x N = 64 NB columns (N = 128 where C is a
//   multiple of 128, else 64). Only tile pairs that hold an upper-triangle
//   element run (row atom ti <= the last column atom), so C = 512 computes
//   40 of 64 atoms.
// - One shared tile serves both operands: B is the f tile of the N columns
//   (pixels x channels, N contiguous: wgmma's transpose bit, as the conv
//   core reads w9), A^T the f tile of the 64 rows, read with ldmatrix.trans
//   (the same box when the rows lie inside the N columns).
// - With K = 2 each consumer warpgroup owns one mask over every tile (one
//   B read serves both masks); with K = 1 they take alternate tiles.
// - The pixels are split across blocks to fill the card. Partial tiles go
//   to a float32 scratch, one slot per (split, warpgroup owning a mask); a
//   second kernel sums the slots in a fixed order and writes each upper
//   element to both its places. Chosen over float32 atomics: deterministic,
//   and G is exactly symmetric (the loss's Grams then are too).
// K4 (dF = sum_k (m_k f) S_k, M = pixels, contraction over K x C):
// - Tiles of 128 pixels (an m64 block per consumer warpgroup) x N output
//   channels (as K3's N), N fastest; a persistent grid, one block per SM.
// - A stage holds one f box (128 pixels x 64 channels, K-major as stored)
//   and the matching 64 rows of every S_k with a live mask (64 x N, N
//   contiguous, transpose bit; S is symmetric). The f fragment is loaded
//   once per 16 channels and masked per k into one accumulator: the
//   [m_1 f | m_2 f] [S_1; S_2] form, one float32 sum over 2C.
// - One rounding to bf16, stored by TMA (clipped at P) from a swizzled
//   buffer per warpgroup. A tile with all-zero masks loads only its masks
//   and stores zeros.

#include "conv_core.cuh"

namespace {

constexpr int kGramPx = 64;       // K3: pixels per stage
constexpr int kGramStages = 4;    // K3's ring
constexpr int kBwdPx = 128;       // K4: pixels per tile (two m64 blocks)
constexpr int kBwdRing = 163840;  // K4: bytes of the stage ring
constexpr int kMaskPx = kBwdPx;   // a stage's mask slot: [2][kMaskPx] bf16
constexpr int kMaskBytes = 2 * kMaskPx * 2;
constexpr int kAhead = 4;         // tiles of masks loaded ahead of their stage

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// Two bf16 values times two mask values (exact for 0/1 masks).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t m) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&m));
  return *reinterpret_cast<uint32_t*>(&r);
}

// m64n128k16 with A from registers, B from shared memory (transpose bit).
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 64 NB] (+)= A (registers) * B: NB 64-wide atoms of B, 8 KB apart,
// from `b`, 16 K rows (2 KB) at a time.
template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32 * NB], const uint32_t (&a)[4],
                                         uint32_t b, int accumulate) {
  const uint64_t db = smem_desc(b, kBBox >> 4, 1024 >> 4);
  if constexpr (NB == 1) wgmma_n64_rs(d, a, db, accumulate);
  else wgmma_n128_rs(d, a, db, accumulate);
}

// The full barriers of a gram ring: lane 0's expect_tx plus 32 lane arrivals
// (the mask copies); the empty barriers: one arrival per consumer warpgroup.
template <class R>
__device__ __forceinline__ void init_gram_ring(const R& ring, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(ring.full + 8 * s, 33);
    mbar_init(ring.empty + 8 * s, 2);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer warp's masks, kAhead tiles ahead of the ring: lane l holds
// pixels p0 + PPL l + [0, PPL) of each mask of a tile (bf16 bits, 0 past P).
// A tile's loads are issued kAhead tiles before their use, so the mask
// reads' latency stays off the producer's path.
template <int PPL>
struct MaskPipe {
  unsigned short x[kAhead][2][PPL];

  // Drop the oldest tile; load the masks of pixels from p0 of a view's
  // [K, P] masks `mv` (p0 = P: no tile, zeros).
  __device__ __forceinline__ void push(const bf16* mv, int K, int P, int p0,
                                       int lane) {
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int e = 0; e < PPL; ++e) x[d][k][e] = x[d + 1][k][e];
    const unsigned short* mu = reinterpret_cast<const unsigned short*>(mv);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e = 0; e < PPL; ++e) {
        const int p = p0 + PPL * lane + e;
        x[kAhead - 1][k][e] = k < K && p < P ? mu[(size_t)k * P + p] : 0;
      }
  }

  // Store the oldest tile's masks into `ms` ([2][kMaskPx] bf16); return the
  // bits of the masks that are nonzero somewhere in the tile.
  __device__ __forceinline__ uint32_t store(bf16* ms, int lane) const {
    unsigned short* mu = reinterpret_cast<unsigned short*>(ms);
    uint32_t live = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      bool any = false;
#pragma unroll
      for (int e = 0; e < PPL; ++e) {
        mu[k * kMaskPx + PPL * lane + e] = x[0][k][e];
        any = any || (x[0][k][e] & 0x7FFFu) != 0;
      }
      if (__any_sync(0xFFFFFFFFu, any)) live |= 1u << k;
    }
    return live;
  }
};

// ---------------------------------------------------------------- K3

// The tile pair `pair` of a C x C Gram cut in 64 x 64 NB tiles, counting
// only tiles that hold an element on or above the diagonal: column group g
// (atoms 64 NB g ...) has rows 0 .. NB (g + 1) - 1.
template <int NB>
__device__ __forceinline__ void gram_pair(int pair, int& ti, int& tj0) {
  int g = 0;
  while (pair >= NB * (g + 1)) pair -= NB * (g + 1), ++g;
  ti = pair;
  tj0 = NB * g;
}

template <int NB>
struct FwdSmem {
  static constexpr int kStage = (NB + 1) * kBBox;  // NB column boxes + a row box
  static constexpr int kMasks = kGramStages * kMaskBytes;
  static constexpr int kBytes =
      kGramStages * kStage + kMasks + 16 * kGramStages + 16 * kGramStages + 1024;
};

template <int NB>
__global__ void __launch_bounds__(kThreads) gram_fwd_kernel(
    const __grid_constant__ CUtensorMap fmap, const bf16* __restrict__ m,
    float* __restrict__ part, int V, int K, int P, int C, int tiles_per_split) {
  using S = FwdSmem<NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  bf16* masks = reinterpret_cast<bf16*>(smem + kGramStages * S::kStage);
  uint32_t* flags = reinterpret_cast<uint32_t*>(smem + kGramStages * S::kStage + S::kMasks);
  const uint32_t bars = base + kGramStages * S::kStage + S::kMasks + 16 * kGramStages;
  const Ring<S::kStage, kGramStages> ring{base, bars, bars + 8 * kGramStages};

  int ti, tj0;
  gram_pair<NB>(blockIdx.x, ti, tj0);
  const int split = blockIdx.y, v = blockIdx.z;
  const int ntiles = (P + kGramPx - 1) / kGramPx;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  // the row box: one of the column boxes, or its own after them (rows left
  // of the columns; never right of them: ti < tj0 + NB)
  const bool own_rows = ti < tj0;
  const int a_box = own_rows ? NB : ti - tj0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_gram_ring(ring, kGramStages);
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const bf16* mv = m + (size_t)v * K * P;
    MaskPipe<2> pipe;
    for (int d = 0; d < kAhead; ++d)
      pipe.push(mv, K, P, t_begin + d < t_end ? (t_begin + d) * kGramPx : P, lane);
    int it = 0;
    for (int t = t_begin; t < t_end; ++t, ++it) {
      const int p0 = t * kGramPx;
      mbar_wait(ring.empty_bar(it), ring.parity(it) ^ 1);
      const int s = it % kGramStages;
      const uint32_t live = pipe.store(masks + s * 2 * kMaskPx, lane);
      pipe.push(mv, K, P, t + kAhead < t_end ? (t + kAhead) * kGramPx : P, lane);
      if (lane == 0) {
        flags[s] = live;
        const uint32_t st = ring.stage(it), bar = ring.full_bar(it);
        mbar_expect_tx(bar, live ? (NB + own_rows) * kBBox : 0);
        if (live) {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            tma_load_3d(st + j * kBBox, &fmap, bar, 64 * (tj0 + j), p0, v);
          if (own_rows) tma_load_3d(st + NB * kBBox, &fmap, bar, 64 * ti, p0, v);
        }
      }
      mbar_arrive(ring.full_bar(it));
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int gi = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int km = K == 2 ? gi : 0;  // the mask this warpgroup sums
  float acc[32 * NB];
  int started = 0;
  int it = 0;
  for (int tile = t_begin; tile < t_end; ++tile, ++it) {
    mbar_wait(ring.full_bar(it), ring.parity(it));
    const int s = it % kGramStages;
    const bool mine = (K == 2 || ((tile - t_begin) & 1) == gi) &&
                      ((flags[s] >> km) & 1u);
    if (mine) {
      // A[c][p] = m[p] f[p][c] for this warp's 16 rows c: matrix q of the
      // x4 load covers pixels 8 (q / 2) + [0, 8) and channels 8 (q % 2) + [0, 8)
      const uint32_t a_st = ring.stage(it) + a_box * kBBox;
      const bf16* ms = masks + (s * 2 + km) * kMaskPx;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_x4_trans(a[kk], a_st + swz(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                        2 * warp + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int px = 16 * kk + 8 * (i >> 1) + 2 * (lane % 4);
          a[kk][i] = mul_bf16x2(a[kk][i], *reinterpret_cast<const uint32_t*>(ms + px));
        }
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<NB>(acc, a[kk], ring.stage(it) + 2048 * kk, started || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      started = 1;
    }
    if (t == 0) mbar_arrive(ring.empty_bar(it));
  }

  // the partial tile: slot (split, warpgroup) for K = 1, split for K = 2
  const int slot = K == 2 ? split : 2 * split + gi;
  float* out = part + (((size_t)slot * V + v) * K + km) * C * C;
  const int r0 = 64 * ti + 16 * warp + lane / 4, c0 = 64 * tj0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 x = started ? make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1])
                         : make_float2(0.0f, 0.0f);
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8 * h) * C + c0 + 8 * j) = x;
    }
}

// out[z] = the sum over slots of part[slot][z] on and above the diagonal,
// mirrored below it; z = v K + k. One block per 32 x 32 tile pair i <= j.
__global__ void __launch_bounds__(256) gram_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ out, int slots, int VK,
    int C) {
  __shared__ float s[32][33];
  const int ti = blockIdx.x, tj = blockIdx.y, z = blockIdx.z;
  if (ti > tj) return;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const size_t plane = (size_t)C * C;
  for (int r = ty; r < 32; r += 8) {
    const size_t at = (size_t)(32 * ti + r) * C + 32 * tj + tx;
    float sum = 0.0f;
    for (int sl = 0; sl < slots; ++sl) sum += part[((size_t)sl * VK + z) * plane + at];
    s[r][tx] = sum;
  }
  __syncthreads();
  float* o = out + z * plane;
  for (int r = ty; r < 32; r += 8) {
    o[(size_t)(32 * ti + r) * C + 32 * tj + tx] =
        ti == tj && r > tx ? s[tx][r] : s[r][tx];
    if (ti < tj) o[(size_t)(32 * tj + r) * C + 32 * ti + tx] = s[tx][r];
  }
}

// ---------------------------------------------------------------- K4

template <int K, int NB>
struct BwdSmem {
  static constexpr int kATile = kBwdPx * 128;       // 128 pixels x 64 channels
  static constexpr int kStage = kATile + K * NB * kBBox;
  static constexpr int kStages = kBwdRing / kStage;
  static constexpr int kEpi = NB * kBBox;           // per warpgroup: m64 x N bf16
  static constexpr int kBytes = kStages * kStage + 2 * kEpi +
                                kStages * (kMaskBytes + 16) + 16 * kStages + 1024;
};

template <int K, int NB>
__global__ void __launch_bounds__(kThreads, 1) gram_bwd_kernel(
    const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap smap,
    const __grid_constant__ CUtensorMap dfmap, const bf16* __restrict__ m, int V,
    int P, int C) {
  using S = BwdSmem<K, NB>;
  constexpr int N = 64 * NB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t epi = base + S::kStages * S::kStage;
  unsigned char* after = smem + S::kStages * S::kStage + 2 * S::kEpi;
  bf16* masks = reinterpret_cast<bf16*>(after);
  uint32_t* flags = reinterpret_cast<uint32_t*>(after + S::kStages * kMaskBytes);
  const uint32_t bars = base + (uint32_t)(after - smem) + S::kStages * (kMaskBytes + 16);
  const Ring<S::kStage, S::kStages> ring{base, bars, bars + 8 * S::kStages};

  const int ntn = C / N, ptiles = (P + kBwdPx - 1) / kBwdPx;
  const int tiles = V * ptiles * ntn, chunks = C / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_gram_ring(ring, S::kStages);
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    // the masks of the block's tile blockIdx.x + n gridDim.x
    auto push = [&](MaskPipe<4>& pipe, int tile) {
      const int pt = tile / ntn, v = pt / ptiles;
      if (tile < tiles)
        pipe.push(m + (size_t)v * K * P, K, P, (pt % ptiles) * kBwdPx, lane);
      else
        pipe.push(m, K, P, P, lane);
    };
    MaskPipe<4> pipe;
    for (int d = 0; d < kAhead; ++d) push(pipe, blockIdx.x + d * gridDim.x);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % ntn) * N, pt = tile / ntn;
      const int p0 = (pt % ptiles) * kBwdPx, v = pt / ptiles;
      uint32_t live = 0;
      for (int c = 0; c == 0 || (live && c < chunks); ++c, ++it) {
        mbar_wait(ring.empty_bar(it), ring.parity(it) ^ 1);
        const int s = it % S::kStages;
        if (c == 0) {
          live = pipe.store(masks + s * 2 * kMaskPx, lane);
          push(pipe, tile + kAhead * gridDim.x);
          if (lane == 0) flags[s] = live;
        }
        if (lane == 0) {
          const uint32_t st = ring.stage(it), bar = ring.full_bar(it);
          mbar_expect_tx(bar, live ? S::kATile + __popc(live) * NB * kBBox : 0);
          if (live) {
            tma_load_3d(st, &fmap, bar, 64 * c, p0, v);
#pragma unroll
            for (int k = 0; k < K; ++k)
              if ((live >> k) & 1u)
#pragma unroll
                for (int j = 0; j < NB; ++j)
                  tma_load_2d(st + S::kATile + (k * NB + j) * kBBox, &smap, bar,
                              n0 + 64 * j, (v * K + k) * C + 64 * c);
          }
        }
        mbar_arrive(ring.full_bar(it));
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int gi = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row = 64 * gi + 16 * warp + lane / 4;  // of the tile; and row + 8
  const uint32_t buf = epi + gi * S::kEpi;
  unsigned char* bufp = smem + (buf - base);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % ntn) * N, pt = tile / ntn;
    const int p0 = (pt % ptiles) * kBwdPx, v = pt / ptiles;
    float acc[32 * NB];
    uint32_t live = 0, mk[K][2];
    for (int c = 0; c == 0 || (live && c < chunks); ++c, ++it) {
      mbar_wait(ring.full_bar(it), ring.parity(it));
      const int s = it % S::kStages;
      if (c == 0) {
        live = flags[s];
        const unsigned short* ms =
            reinterpret_cast<const unsigned short*>(masks + s * 2 * kMaskPx);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t x = ms[k * kMaskPx + row + 8 * h];
            mk[k][h] = x | (x << 16);
          }
      }
      if (live) {
        // f rows 16 warp + [0, 16) of this warpgroup's m64 block: lanes
        // 0-15 give the rows of channels 16 kk + [0, 8), lanes 16-31 + [8, 16)
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(a[kk], ring.stage(it) + swz(64 * gi + 16 * warp + (lane & 15),
                                              2 * kk + lane / 16));
        uint32_t am[K][4][4];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) am[k][kk][i] = mul_bf16x2(a[kk][i], mk[k][i & 1]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        int first = c == 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!((live >> k) & 1u)) continue;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<NB>(acc, am[k][kk],
                         ring.stage(it) + S::kATile + k * NB * kBBox + 2048 * kk,
                         !first);
            first = 0;
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
      if (t == 0) mbar_arrive(ring.empty_bar(it));
    }
    fence_acc(acc);

    // epilogue: one rounding to bf16 into the warpgroup's swizzled buffer
    // (NB boxes of m64 x 64), stored by TMA
    if (t == 0)  // the previous tile's store has read the buffer
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    bar_sync(1 + gi, 128);
    const int r = 16 * warp + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(bufp + (j / 8) * kBBox +
                                           swz(r + 8 * h, j % 8) + cq * 2) =
            live ? __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1])
                 : __floats2bfloat162_rn(0.0f, 0.0f);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1 + gi, 128);
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_store_3d(&dfmap, buf + j * kBBox, n0 + 64 * j, p0 + 64 * gi, v);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The map of f or dF [V, P, C] bf16, in boxes of 64 channels x box_p pixels.
inline int encode_vpc(CUtensorMap* map, const void* ptr, int V, int P, int C,
                      int box_p) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)V};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)P * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_p, 1};
  return encode(map, ptr, 3, dims, strides, box);
}

template <int NB>
int launch_fwd(const void* f, const void* m, float* part, int V, int K, int P,
               int C, int splits, cudaStream_t st) {
  const int bytes = FwdSmem<NB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gram_fwd_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap fmap;
  const int res = encode_vpc(&fmap, f, V, P, C, kGramPx);
  if (res != 0) return -res;
  const int groups = C / 64 / NB, pairs = NB * groups * (groups + 1) / 2;
  const int ntiles = (P + kGramPx - 1) / kGramPx;
  const int per_split = (ntiles + splits - 1) / splits;
  gram_fwd_kernel<NB><<<dim3(pairs, splits, V), kThreads, bytes, st>>>(
      fmap, (const bf16*)m, part, V, K, P, C, per_split);
  return (int)cudaGetLastError();
}

template <int K, int NB>
int launch_bwd(const void* f, const void* m, const void* s, void* df, int V,
               int P, int C, cudaStream_t st) {
  const int bytes = BwdSmem<K, NB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gram_bwd_kernel<K, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap fmap, smap, dfmap;
  const cuuint64_t sdims[2] = {(cuuint64_t)C, (cuuint64_t)V * K * C};
  const cuuint64_t sstrides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t sbox[2] = {64, 64};
  int res = encode_vpc(&fmap, f, V, P, C, kBwdPx);
  if (res == 0) res = encode(&smap, s, 2, sdims, sstrides, sbox);
  if (res == 0) res = encode_vpc(&dfmap, df, V, P, C, 64);
  if (res != 0) return -res;
  const long long tiles =
      (long long)V * ((P + kBwdPx - 1) / kBwdPx) * (C / (64 * NB));
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  gram_bwd_kernel<K, NB><<<grid, kThreads, bytes, st>>>(fmap, smap, dfmap,
                                                      (const bf16*)m, V, P, C);
  return (int)cudaGetLastError();
}

static_assert(FwdSmem<2>::kBytes <= 232448, "K3 shared memory");
static_assert(BwdSmem<2, 2>::kBytes <= 232448 && BwdSmem<2, 2>::kStages >= 3,
              "K4 shared memory");

}  // namespace

// K3: the raw masked Grams out [V, K, C, C] float32 of f [V, P, C] under
// masks [V, K, P]; the pixels in `splits` ranges, their partial tiles in
// `part` (float32 [splits * (K == 1 ? 2 : 1), V, K, C, C], scratch).
// Returns the first failing launch's cudaError_t, or minus the CUresult of
// a tensor map that could not be encoded.
extern "C" int stylemesh_gram_fwd(const void* f, const void* m, void* part,
                                  void* out, int V, int K, int P, int C,
                                  int splits, void* stream) {
  if (C % 64 != 0 || (K != 1 && K != 2) || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (V == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int slots = splits * (K == 1 ? 2 : 1);
  if (P == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)V * K * C * C * 4, st);
  int status = C % 128 ? launch_fwd<1>(f, m, (float*)part, V, K, P, C, splits, st)
                       : launch_fwd<2>(f, m, (float*)part, V, K, P, C, splits, st);
  if (status != 0) return status;
  const int nt = C / 32;
  gram_reduce_kernel<<<dim3(nt, nt, V * K), 256, 0, st>>>(
      (const float*)part, (float*)out, slots, V * K, C);
  return (int)cudaGetLastError();
}

// K4: dF [V, P, C] bf16 of f, the masks and the symmetric bf16 s [V, K, C, C].
extern "C" int stylemesh_gram_bwd(const void* f, const void* m, const void* s,
                                  void* df, int V, int K, int P, int C,
                                  void* stream) {
  if (C % 64 != 0 || (K != 1 && K != 2)) return (int)cudaErrorInvalidValue;
  if (V == 0 || P == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 128)
    return K == 1 ? launch_bwd<1, 1>(f, m, s, df, V, P, C, st)
                  : launch_bwd<2, 1>(f, m, s, df, V, P, C, st);
  return K == 1 ? launch_bwd<1, 2>(f, m, s, df, V, P, C, st)
                : launch_bwd<2, 2>(f, m, s, df, V, P, C, st);
}

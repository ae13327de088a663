// K3 / K4: fused multi-mask Gram sums and their backward.
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
// What bounds them on an H100: at the style layers they serve (P from 51 156
// to 819 280 pixels, C from 64 to 256) each kernel does 2*K*P*C^2 flops per
// view on 2*P*C bytes of features, K*C flops a byte: 128 at C = 64 (below the
// card's ~295 bf16 flops per byte of HBM, so memory-bound), 256 at C = 128
// (near the balance point) and 512 at C = 256 (tensor-core bound). Both run
// on the tensor cores through WMMA 16x16x16 bf16 fragments with float32
// accumulators; tiles are staged through shared memory with 16-byte loads.
//
// K3: the TPU kernel carried one [C, C] accumulator across a sequential pixel
// grid. CUDA blocks run in parallel, so the pixels are split across blocks,
// each block owns one 64x64 output tile of all K Grams over its pixel range,
// and the partial tiles are reduced with float32 atomics into a zeroed output
// (a C = 256 float32 Gram is 256 KB, more than a block's shared memory).
//
// K4: one block per 64-pixel x 64-channel output tile. With 0/1 masks,
// sum_k m_k (S_k f) = [m_1 f | m_2 f] [S_1; S_2], one product with a K*C
// contraction into one accumulator; S is symmetric, so (S f_p)^T = f_p^T S.
// The float32 result is rounded to bf16 once, as the TPU kernel does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTile = 64;         // output tile edge (channels or pixels)
constexpr int kFwdPx = 32;        // pixels per K3 main-loop step
constexpr int kLds = kTile + 8;   // shared row stride, bf16, 64-wide tiles
constexpr int kBwdC = 32;         // contraction channels per K4 step
constexpr int kLdsA = kBwdC + 8;  // shared row stride, bf16, K4's A tile
constexpr int kLdc = kTile + 4;   // shared row stride, f32, K4's staging tile
constexpr int kThreads = 128;     // 4 warps, each a 32x32 quarter of the tile

__device__ __forceinline__ bf16 scale_bf16(bf16 x, float m) {
  return __float2bfloat16(__bfloat162float(x) * m);
}

// ---------------------------------------------------------------- K3
template <int K>
__global__ void __launch_bounds__(kThreads) gram_fwd_kernel(
    const bf16* __restrict__ f, const bf16* __restrict__ m,
    float* __restrict__ out, int P, int C, int px_per_block) {
  __shared__ __align__(32) bf16 a_s[K][kFwdPx][kLds];  // m_k * f[:, tile i]
  __shared__ __align__(32) bf16 b_s[kFwdPx][kLds];     // f[:, tile j]
  __shared__ float m_s[K][kFwdPx];
  __shared__ __align__(32) float stage[4][16 * 16];

  const int nt = C / kTile;
  const int ti = blockIdx.x / nt, tj = blockIdx.x % nt;
  const int v = blockIdx.z;
  const int p_begin = blockIdx.y * px_per_block;
  const int p_end = min(P, p_begin + px_per_block);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;

  const bf16* fv = f + (size_t)v * P * C;
  const bf16* mv = m + (size_t)v * K * P;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[K][2][2];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[k][i][j], 0.0f);

  for (int p0 = p_begin; p0 < p_end; p0 += kFwdPx) {
    for (int idx = tid; idx < K * kFwdPx; idx += kThreads) {
      int k = idx / kFwdPx, r = idx % kFwdPx, p = p0 + r;
      m_s[k][r] = p < p_end ? __bfloat162float(mv[(size_t)k * P + p]) : 0.0f;
    }
    __syncthreads();
    // 32 rows x 64 channels per tile = 256 16-byte vectors per operand
    for (int idx = tid; idx < kFwdPx * (kTile / 8); idx += kThreads) {
      int r = idx / (kTile / 8), c8 = (idx % (kTile / 8)) * 8, p = p0 + r;
      uint4 bj = make_uint4(0, 0, 0, 0), ai = make_uint4(0, 0, 0, 0);
      if (p < p_end) {
        const bf16* row = fv + (size_t)p * C;
        bj = *reinterpret_cast<const uint4*>(row + tj * kTile + c8);
        ai = *reinterpret_cast<const uint4*>(row + ti * kTile + c8);
      }
      *reinterpret_cast<uint4*>(&b_s[r][c8]) = bj;
      const bf16* av = reinterpret_cast<const bf16*>(&ai);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float mk = m_s[k][r];
#pragma unroll
        for (int e = 0; e < 8; ++e) a_s[k][r][c8 + e] = scale_bf16(av[e], mk);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFwdPx; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &b_s[kk][wc * 32 + j * 16], kLds);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // A(c, p) = a_s[k][p][c]: column-major with leading dimension kLds
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &a_s[k][kk][wr * 32 + i * 16], kLds);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[k][i][j], a[i], b[j], acc[k][i][j]);
      }
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float* ok = out + (((size_t)v * K + k) * C) * C;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(st, acc[k][i][j], 16, wmma::mem_row_major);
        __syncwarp();
        int r0 = ti * kTile + wr * 32 + i * 16;
        int c0 = tj * kTile + wc * 32 + j * 16;
        for (int e = lane; e < 256; e += 32) {
          float x = st[e];
          if (x != 0.0f) atomicAdd(ok + (size_t)(r0 + e / 16) * C + c0 + e % 16, x);
        }
        __syncwarp();
      }
  }
}

// ---------------------------------------------------------------- K4
template <int K>
__global__ void __launch_bounds__(kThreads) gram_bwd_kernel(
    const bf16* __restrict__ f, const bf16* __restrict__ m,
    const bf16* __restrict__ s, bf16* __restrict__ df, int P, int C) {
  __shared__ __align__(32) bf16 a_s[kTile][kLdsA];  // m_k * f[p tile, c step]
  __shared__ __align__(32) bf16 b_s[kBwdC][kLds];   // S_k[c step, d tile]
  __shared__ __align__(32) float c_s[kTile][kLdc];
  __shared__ float m_s[K][kTile];

  const int p0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * kTile;
  const int v = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;

  const bf16* fv = f + (size_t)v * P * C;
  const bf16* mv = m + (size_t)v * K * P;

  for (int idx = tid; idx < K * kTile; idx += kThreads) {
    int k = idx / kTile, r = idx % kTile, p = p0 + r;
    m_s[k][r] = p < P ? __bfloat162float(mv[(size_t)k * P + p]) : 0.0f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const bf16* sk = s + ((size_t)v * K + k) * C * C;
    for (int c0 = 0; c0 < C; c0 += kBwdC) {
      // A: 64 pixels x 32 channels = 256 vectors; B: 32 x 64 = 256 vectors
      for (int idx = tid; idx < kTile * (kBwdC / 8); idx += kThreads) {
        int r = idx / (kBwdC / 8), c8 = (idx % (kBwdC / 8)) * 8, p = p0 + r;
        uint4 x = make_uint4(0, 0, 0, 0);
        float mk = m_s[k][r];
        if (p < P && mk != 0.0f)
          x = *reinterpret_cast<const uint4*>(fv + (size_t)p * C + c0 + c8);
        const bf16* xv = reinterpret_cast<const bf16*>(&x);
#pragma unroll
        for (int e = 0; e < 8; ++e) a_s[r][c8 + e] = scale_bf16(xv[e], mk);
      }
      for (int idx = tid; idx < kBwdC * (kTile / 8); idx += kThreads) {
        int r = idx / (kTile / 8), c8 = (idx % (kTile / 8)) * 8;
        *reinterpret_cast<uint4*>(&b_s[r][c8]) =
            *reinterpret_cast<const uint4*>(sk + (size_t)(c0 + r) * C + d0 + c8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBwdC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &a_s[wr * 32 + i * 16][kk], kLdsA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &b_s[kk][wc * 32 + j * 16], kLds);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&c_s[wr * 32 + i * 16][wc * 32 + j * 16],
                              acc[i][j], kLdc, wmma::mem_row_major);
  __syncthreads();
  // 64 rows x 64 channels of bf16 = 512 16-byte vectors
  for (int idx = tid; idx < kTile * (kTile / 8); idx += kThreads) {
    int r = idx / (kTile / 8), c8 = (idx % (kTile / 8)) * 8, p = p0 + r;
    if (p >= P) continue;
    uint4 o;
    bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int e = 0; e < 8; ++e) ov[e] = __float2bfloat16(c_s[r][c8 + e]);
    *reinterpret_cast<uint4*>(df + ((size_t)v * P + p) * C + d0 + c8) = o;
  }
}

}  // namespace

extern "C" int stylemesh_gram_fwd(const void* f, const void* m, void* out,
                                  int V, int K, int P, int C,
                                  int px_per_block, void* stream) {
  if (C % kTile != 0 || (K != 1 && K != 2) || px_per_block % kFwdPx != 0)
    return (int)cudaErrorInvalidValue;
  if (V == 0 || P == 0) return 0;
  int nt = C / kTile;
  dim3 grid(nt * nt, (P + px_per_block - 1) / px_per_block, V);
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 1)
    gram_fwd_kernel<1><<<grid, kThreads, 0, st>>>(
        (const bf16*)f, (const bf16*)m, (float*)out, P, C, px_per_block);
  else
    gram_fwd_kernel<2><<<grid, kThreads, 0, st>>>(
        (const bf16*)f, (const bf16*)m, (float*)out, P, C, px_per_block);
  return (int)cudaGetLastError();
}

extern "C" int stylemesh_gram_bwd(const void* f, const void* m, const void* s,
                                  void* df, int V, int K, int P, int C,
                                  void* stream) {
  if (C % kTile != 0 || (K != 1 && K != 2)) return (int)cudaErrorInvalidValue;
  if (V == 0 || P == 0) return 0;
  dim3 grid((P + kTile - 1) / kTile, C / kTile, V);
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 1)
    gram_bwd_kernel<1><<<grid, kThreads, 0, st>>>(
        (const bf16*)f, (const bf16*)m, (const bf16*)s, (bf16*)df, P, C);
  else
    gram_bwd_kernel<2><<<grid, kThreads, 0, st>>>(
        (const bf16*)f, (const bf16*)m, (const bf16*)s, (bf16*)df, P, C);
  return (int)cudaGetLastError();
}

// K6 / K7 / K8: the bf16 VGG trunk's fused block tails, on a WMMA core.
//
// Replaces the TPU kernels
//   K6  ops/head_pallas.py::conv_relu_pool (_kernel_packed, 64 channels, and
//       _kernel_direct, 128): p = maxpool2(bf16(relu(conv3x3(x, w) + b)));
//   K7  ops/head_pallas.py::conv_relu_pool_dual (_kernel_direct_dual): K6 that
//       also writes the pre-pool activation;
//   K8  ops/head_pallas.py::conv_relu_pool_bwd (_kernel_packed_bwd): the input
//       gradient of the 64-channel K6.
// The plain 3x3 convolution K5 / K9 is conv_gemm.cu (wgmma and TMA).
//
// Layouts: activations bf16 [V, H, W, C] (channel-last), kernels as the bf16
// matrix w9 [9 * Cin, Cout] with rows in (dy, dx, ci) order (an HWIO kernel
// reshaped), bias float32 [Cout]. Stride 1, SAME zero padding.
//
// What bounds them on an H100: the tensor cores. A 3x3 conv does 18 * Cin
// flops per output value and moves ~2 * (Cin + Cout) bytes per pixel, so at
// 64 channels and above the block tails are far above the card's ~295 bf16
// flops per HBM byte. The design is one implicit GEMM shared by the three
// kernels: M is a tile of output pixels (rows of 16 pixels of one image
// row), N a 64-wide slice of Cout, and K = 9 * Cin runs in (32-channel
// chunk, tap, 16-channel step) order. A haloed input tile of one channel
// chunk (zero outside the image: SAME padding) and the chunk's weights for
// all nine taps are staged in shared memory; the products are WMMA bf16
// 16x16x16 fragments with float32 accumulators. The epilogue adds the
// float32 bias, applies relu and rounds to bf16 once (the TPU kernels'
// numerics), then stores the 2x2 maximum of the bf16 values (K6) and the
// pre-pool map (K7). No double buffering, no wgmma or TMA yet: these three
// move to a new core together, because K8 must recompute K6's values bit
// for bit.
//
// K8 recomputes relu(conv + b) on its tile plus one ring of pool windows with
// the same core (same K order, same epilogue), so its values equal K6's bit
// for bit and the pool routing is the forward's. It routes the pooled
// cotangent to the first maximum of each window in raster order where the
// activation is > 0, and applies the transposed conv (the flipped io-swapped
// kernel) to the routed gradient held in shared memory: x and g are read once
// and only dx is written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kCK = 32;       // input channels per K chunk
constexpr int kXS = 48;       // shared row stride (bf16) of a staged pixel
constexpr int kN = 64;        // output channels per block
constexpr int kWS = kN + 8;   // shared row stride (bf16) of staged weights
constexpr int kThreads = 256; // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;     // K5-K7: 16 x 16 output pixels per block
constexpr int kOS = kN + 8;   // shared row stride (bf16) of the output tile
constexpr int kBwdRows = 8;   // K8: dx rows per block
constexpr int kBwdCols = 28;  // K8: dx cols per block (two 16-wide frags)
constexpr int kRS = 80;       // K8: shared row stride (bf16) of r / dr

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__host__ __device__ constexpr int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}
__host__ __device__ constexpr int xs_bytes(int mr, int mcf) {
  return round128((mr + 2) * (16 * mcf + 2) * kXS * 2);
}
constexpr int kWsBytes = round128(9 * kCK * kWS * 2);

// Weights of channel chunk [ci0, ci0 + kCK) for all nine taps and output
// channels [n0, n0 + 64) -> ws[(tap * kCK + k) * kWS + n].
__device__ __forceinline__ void stage_weights(const bf16* __restrict__ w9,
                                              int cin, int cout, int n0,
                                              int ci0, bf16* ws) {
  for (int idx = threadIdx.x; idx < 9 * kCK * (kN / 8); idx += kThreads) {
    int row = idx / (kN / 8), q = idx % (kN / 8);
    int tap = row / kCK, k = row % kCK;
    *reinterpret_cast<uint4*>(ws + row * kWS + q * 8) =
        *reinterpret_cast<const uint4*>(
            w9 + ((size_t)tap * cin + ci0 + k) * cout + n0 + q * 8);
  }
}

// acc[m][j] += conv3x3 on the region of MR rows x 16 * MCF cols whose top
// left output pixel is (or0, oc0), output channels [n0, n0 + 64). M-fragment
// mf = warp * MFW + m is region row mf / MCF, cols (mf % MCF) * 16 + [0, 16).
// Every kernel of this file runs this loop, so a value computed by two of
// them is the same sum in the same order.
template <int MR, int MCF>
__device__ __forceinline__ void conv_region(
    const bf16* __restrict__ xv, const bf16* __restrict__ w9, int H, int W,
    int cin, int cout, int n0, int or0, int oc0, bf16* xs, bf16* ws,
    Acc (&acc)[MR * MCF / kWarps][4]) {
  constexpr int MFW = MR * MCF / kWarps;
  constexpr int RR = MR + 2, RC = 16 * MCF + 2;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < MFW; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[m][j], 0.0f);

  for (int ci0 = 0; ci0 < cin; ci0 += kCK) {
    for (int idx = threadIdx.x; idx < RR * RC * (kCK / 8); idx += kThreads) {
      int p = idx / (kCK / 8), q = idx % (kCK / 8);
      int y = or0 - 1 + p / RC, x = oc0 - 1 + p % RC;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (y >= 0 && y < H && x >= 0 && x < W)
        val = *reinterpret_cast<const uint4*>(
            xv + ((size_t)y * W + x) * cin + ci0 + q * 8);
      *reinterpret_cast<uint4*>(xs + p * kXS + q * 8) = val;
    }
    stage_weights(w9, cin, cout, n0, ci0, ws);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kCK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(b[j], ws + (tap * kCK + kk) * kWS + j * 16,
                                 kWS);
#pragma unroll
        for (int m = 0; m < MFW; ++m) {
          const int mf = warp * MFW + m;
          const int row = mf / MCF, cf = mf % MCF;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(
              a, xs + ((row + dy) * RC + cf * 16 + dx) * kXS + kk, kXS);
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[m][j], a, b[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }
}

// The one epilogue: bf16(act(acc + b)).
__device__ __forceinline__ bf16 finish(float acc, const float* bias, int n,
                                       bool relu) {
  float v = acc + (bias != nullptr ? bias[n] : 0.0f);
  if (relu) v = fmaxf(v, 0.0f);
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------- K6, K7
// The pooled map (K6), and with DUAL the pre-pool map y too (K7).
template <bool DUAL>
__global__ void __launch_bounds__(kThreads) conv_relu_pool_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w9,
    const float* __restrict__ bias, bf16* __restrict__ y,
    bf16* __restrict__ pooled, int H, int W, int cin, int cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + xs_bytes(kTile, 1));

  const int nco = cout / kN;
  const int ntc = (W + kTile - 1) / kTile, ntr = (H + kTile - 1) / kTile;
  long long b = blockIdx.x;
  const int n0 = (int)(b % nco) * kN;
  b /= nco;
  const int c0 = (int)(b % ntc) * kTile;
  b /= ntc;
  const int r0 = (int)(b % ntr) * kTile;
  const int v = (int)(b / ntr);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  Acc acc[kTile / kWarps][4];
  conv_region<kTile, 1>(x + (size_t)v * H * W * cin, w9, H, W, cin, cout, n0,
                        r0, c0, xs, ws, acc);

  // fragments -> bf16 output tile ot[pixel][channel] (reusing ws); a
  // per-warp float32 scratch in xs
  bf16* ot = ws;
  float* st = reinterpret_cast<float*>(xs) + warp * 256;
#pragma unroll
  for (int m = 0; m < kTile / kWarps; ++m) {
    const int row = warp * (kTile / kWarps) + m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[m][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        int px = e / 16, c = e % 16;
        ot[(row * kTile + px) * kOS + j * 16 + c] =
            finish(st[e], bias, n0 + j * 16 + c, true);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  if (DUAL) {
    bf16* yv = y + (size_t)v * H * W * cout;
    for (int idx = threadIdx.x; idx < kTile * kTile * (kN / 8); idx += kThreads) {
      int p = idx / (kN / 8), q = idx % (kN / 8);
      int yy = r0 + p / kTile, xx = c0 + p % kTile;
      if (yy < H && xx < W)
        *reinterpret_cast<uint4*>(yv + ((size_t)yy * W + xx) * cout + n0 + q * 8) =
            *reinterpret_cast<const uint4*>(ot + p * kOS + q * 8);
    }
  }
  {
    const int H2 = H / 2, W2 = W / 2;
    bf16* pv = pooled + (size_t)v * H2 * W2 * cout;
    constexpr int kP = kTile / 2;
    for (int idx = threadIdx.x; idx < kP * kP * (kN / 8); idx += kThreads) {
      int p = idx / (kN / 8), q = idx % (kN / 8);
      int pi = p / kP, pj = p % kP;
      int py = r0 / 2 + pi, px = c0 / 2 + pj;
      if (py >= H2 || px >= W2) continue;
      const bf16* t = ot + ((2 * pi) * kTile + 2 * pj) * kOS + q * 8;
      uint4 o;
      bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = __bfloat162float(t[e]);
        float bq = __bfloat162float(t[kOS + e]);
        float c = __bfloat162float(t[kTile * kOS + e]);
        float d = __bfloat162float(t[(kTile + 1) * kOS + e]);
        ov[e] = __float2bfloat16(fmaxf(fmaxf(a, bq), fmaxf(c, d)));
      }
      *reinterpret_cast<uint4*>(pv + ((size_t)py * W2 + px) * cout + n0 + q * 8) = o;
    }
  }
}

// ---------------------------------------------------------------- K8
// One block per kBwdRows x kBwdCols tile of dx at (r0, c0), both even.
//   dx rows [0, 8) cols [0, 28)  <- dr rows [-1, 9) cols [-1, 29)
//   dr <- g and r on the pool windows covering rows [-2, 10) cols [-2, 30)
//   r rows [-2, 10) cols [-2, 30) (12 rows x two 16-wide frags) <- x rows
//   [-3, 11) cols [-3, 31)
// (coordinates relative to the tile). dx is computed as two overlapping
// 16-wide frags per row, cols [0, 16) and [12, 28).
constexpr int kBwdMR = kBwdRows + 4;
constexpr int kBwdXs = xs_bytes(kBwdMR, 2);
constexpr int kBwdRt = round128(kBwdMR * 32 * kRS * 2);
constexpr int kBwdSmem = kBwdXs + kWsBytes + kBwdRt;

__global__ void __launch_bounds__(kThreads, 1) conv_relu_pool_bwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w9,
    const bf16* __restrict__ w9t, const float* __restrict__ bias,
    const bf16* __restrict__ g, bf16* __restrict__ dx, int H, int W) {
  constexpr int C = 64;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + kBwdXs);
  bf16* rt = reinterpret_cast<bf16*>(smem + kBwdXs + kWsBytes);

  const int ntc = (W + kBwdCols - 1) / kBwdCols;
  const int ntr = (H + kBwdRows - 1) / kBwdRows;
  long long b = blockIdx.x;
  const int c0 = (int)(b % ntc) * kBwdCols;
  b /= ntc;
  const int r0 = (int)(b % ntr) * kBwdRows;
  const int v = (int)(b / ntr);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H2 = H / 2, W2 = W / 2;
  float* st = reinterpret_cast<float*>(xs) + warp * 256;

  // 1. r = bf16(relu(conv(x) + b)) on the region, as K6 computes it
  {
    constexpr int MFW = kBwdMR * 2 / kWarps;
    Acc acc[MFW][4];
    conv_region<kBwdMR, 2>(x + (size_t)v * H * W * C, w9, H, W, C, C, 0,
                           r0 - 2, c0 - 2, xs, ws, acc);
#pragma unroll
    for (int m = 0; m < MFW; ++m) {
      const int mf = warp * MFW + m;
      const int row = mf / 2, cf = mf % 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(st, acc[m][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          int px = e / 16, c = e % 16;
          rt[(row * 32 + cf * 16 + px) * kRS + j * 16 + c] =
              finish(st[e], bias, j * 16 + c, true);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 2. route the pooled cotangent: dr = g at the first maximum of each
  //    window (raster order) where r > 0, else 0; in place in rt. Windows
  //    outside the pooled map (image border, odd tail) route nothing.
  const bf16* gv = g + (size_t)v * H2 * W2 * C;
  for (int idx = threadIdx.x; idx < (kBwdMR / 2) * 16 * C; idx += kThreads) {
    int wi = idx / (16 * C), wj = (idx / C) % 16, ch = idx % C;
    int py = r0 / 2 - 1 + wi, px = c0 / 2 - 1 + wj;
    bf16 gval = __float2bfloat16(0.0f);
    if (py >= 0 && py < H2 && px >= 0 && px < W2)
      gval = gv[((size_t)py * W2 + px) * C + ch];
    bf16* t = rt + ((2 * wi) * 32 + 2 * wj) * kRS + ch;
    float a = __bfloat162float(t[0]);
    float bq = __bfloat162float(t[kRS]);
    float c = __bfloat162float(t[32 * kRS]);
    float d = __bfloat162float(t[33 * kRS]);
    float p = fmaxf(fmaxf(a, bq), fmaxf(c, d));
    bool ma = a == p && a > 0.0f;
    bool mb = !ma && bq == p && bq > 0.0f;
    bool mc = !ma && !mb && c == p && c > 0.0f;
    bool md = !ma && !mb && !mc && d == p && d > 0.0f;
    const bf16 zero = __float2bfloat16(0.0f);
    t[0] = ma ? gval : zero;
    t[kRS] = mb ? gval : zero;
    t[32 * kRS] = mc ? gval : zero;
    t[33 * kRS] = md ? gval : zero;
  }
  __syncthreads();

  // 3. dx = transposed conv of dr: the conv with the flipped io-swapped
  //    kernel w9t, A read straight from rt
  constexpr int MFW = kBwdRows * 2 / kWarps;
  Acc acc[MFW][4];
#pragma unroll
  for (int m = 0; m < MFW; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[m][j], 0.0f);
  for (int ci0 = 0; ci0 < C; ci0 += kCK) {
    stage_weights(w9t, C, C, 0, ci0, ws);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dxx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kCK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(bf[j], ws + (tap * kCK + kk) * kWS + j * 16,
                                 kWS);
#pragma unroll
        for (int m = 0; m < MFW; ++m) {
          const int mf = warp * MFW + m;
          const int s = mf / 2, q0 = (mf % 2) * 12;
          // dx (s, q) reads dr (s - 1 + dy, q - 1 + dx): rt row s + 1 + dy,
          // rt col q + 1 + dx (rt starts at tile row / col -2)
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(
              a, rt + ((s + 1 + dy) * 32 + q0 + 1 + dxx) * kRS + ci0 + kk, kRS);
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[m][j], a, bf[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

  bf16* dxv = dx + (size_t)v * H * W * C;
#pragma unroll
  for (int m = 0; m < MFW; ++m) {
    const int mf = warp * MFW + m;
    const int s = mf / 2, cf = mf % 2, q0 = cf * 12;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[m][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        int px = e / 16, c = e % 16;
        if (cf == 1 && px < 4) continue;  // cols 12..15 come from frag 0
        int yy = r0 + s, xx = c0 + q0 + px;
        if (yy < H && xx < W)
          dxv[((size_t)yy * W + xx) * C + j * 16 + c] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
  }
}

template <bool DUAL>
int launch_conv_relu_pool(const void* x, const void* w9, const void* bias,
                          void* y, void* pooled, int V, int H, int W, int cin,
                          int cout, cudaStream_t st) {
  constexpr int smem = xs_bytes(kTile, 1) + kWsBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_relu_pool_kernel<DUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)V * ((H + kTile - 1) / kTile) *
                     ((W + kTile - 1) / kTile) * (cout / kN);
  conv_relu_pool_kernel<DUAL><<<(unsigned)blocks, kThreads, smem, st>>>(
      (const bf16*)x, (const bf16*)w9, (const float*)bias, (bf16*)y,
      (bf16*)pooled, H, W, cin, cout);
  return (int)cudaGetLastError();
}

}  // namespace

// pooled = maxpool2(bf16(relu(conv3x3(x) + bias))) (K6); with `dual`, y =
// the pre-pool activation too (K7). bias may be NULL (zero). Cin a multiple
// of 32, Cout of 64.
extern "C" int stylemesh_conv_relu_pool(const void* x, const void* w9,
                                        const void* bias, void* y, void* pooled,
                                        int V, int H, int W, int cin, int cout,
                                        int dual, void* stream) {
  if (cin % kCK != 0 || cout % kN != 0) return (int)cudaErrorInvalidValue;
  if (V == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dual)
    return launch_conv_relu_pool<true>(x, w9, bias, y, pooled, V, H, W, cin,
                                       cout, st);
  return launch_conv_relu_pool<false>(x, w9, bias, y, pooled, V, H, W, cin,
                                      cout, st);
}

// dx [V, H, W, 64] of maxpool2(bf16(relu(conv3x3(x, w9) + bias))) for the
// pooled cotangent g [V, H / 2, W / 2, 64]; w9t is the flipped io-swapped
// kernel (K8).
extern "C" int stylemesh_conv_relu_pool_bwd(const void* x, const void* w9,
                                            const void* w9t, const void* bias,
                                            const void* g, void* dx, int V,
                                            int H, int W, void* stream) {
  if (V == 0 || H == 0 || W == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      conv_relu_pool_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)V * ((H + kBwdRows - 1) / kBwdRows) *
                     ((W + kBwdCols - 1) / kBwdCols);
  conv_relu_pool_bwd_kernel<<<(unsigned)blocks, kThreads, kBwdSmem,
                              (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w9, (const bf16*)w9t, (const float*)bias,
      (const bf16*)g, (bf16*)dx, H, W);
  return (int)cudaGetLastError();
}

// Causal 3D convolution (kernel [kt, 3, 3], stride 1) for Hopper (sm_90a).
//
// Replaces the Pallas kernels fastvideo_tpu/ops/conv3d.py:_conv_kernel_thcw_kf
// ("kf") and _conv_kernel ("tap"), which compute the same function in two
// TPU layouts: y = conv(x, w) + bias over channels-last x [B, T, H, W, C]
// with w [kt, 3, 3, C, Co], `time_pad` zero frames in front (causal) and
// SAME spatial padding.
//
// It is one implicit GEMM: M = B*T_out*H*W output voxels, N = Co,
// K = kt*3*3*C, where A[m, (dt, dh, dw, c)] = x[b, t+dt-time_pad, h+dh-1,
// w+dw-1, c] is gathered on the fly. Out-of-range taps (the causal time pad
// and the spatial border) read zeros through bounds checks, so no padded
// copy of x exists. Because C % 8 == 0, each 16-byte load of 8 channels
// lies inside one tap.
//
// What bounds it: the VAE decoder's convs are tensor-core bound
// (2*M*N*K FLOP, e.g. 1.6e13 for one 96-channel 3x3x3 conv over 81 frames
// at 480x832, against ~0.2 GB of activations). The design is a plain
// BM x BN x BK = 128 x 64 x 32 tile with 8 warps of WMMA bf16 16x16x16
// fragments and fp32 accumulation, loading through registers into shared
// memory without overlap (no cp.async, TMA or wgmma yet): a later change
// makes it fast. The N tail (Co not a multiple of 64, e.g. conv_out's 3
// channels) is masked on load and store.
//
// fp32 operands (a decode with vae_decode_precision="fp32", whose JAX convs
// take fp32 operands) take a second kernel: the same implicit GEMM with
// fp32 FMAs on CUDA cores and an fp32 accumulator, bias and output. WMMA
// has no fp32 operand, and TF32 would leave the fp32 sum by about 1e-3
// relative. It is a plain SIMT tile, BM x BN x BK = 64 x 64 x 16, 256
// threads each owning a 4 x 4 block of outputs, operands staged k-major
// in shared memory; the same bounds checks give the causal pad, the SAME
// border and the masked Co tail. It is bound by the card's fp32 rate
// (67 TFLOP/s), and this first design is not tuned.
//
// Grid: (ceil(M / BM), ceil(Co / BN)), 256 threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kThreads = 256;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kABytes = BM * LDA * 2;
constexpr int kBBytes = BK * LDB * 2;
constexpr int kCBytes = BM * LDC * 4;
constexpr int kTileBytes = (kABytes + kBBytes) > kCBytes ? (kABytes + kBBytes) : kCBytes;

__global__ void __launch_bounds__(kThreads)
    conv3d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, bf16* __restrict__ y, int T, int H, int W,
                  int C, int Co, int kt, int time_pad, int T_out, long long M, int vec_b) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char tile[kTileBytes];
  __shared__ int row_b[BM], row_t[BM], row_h[BM], row_w[BM];
  bf16* As = reinterpret_cast<bf16*>(tile);
  bf16* Bs = reinterpret_cast<bf16*>(tile + kABytes);
  float* Cs = reinterpret_cast<float*>(tile);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 4 warps along M, 32 rows each
  const int wn = warp % 2;  // 2 warps along N, 32 columns each
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int Ktot = kt * 9 * C;

  for (int i = tid; i < BM; i += kThreads) {
    const long long m = m0 + i;
    if (m < M) {
      long long r = m;
      row_w[i] = static_cast<int>(r % W);
      r /= W;
      row_h[i] = static_cast<int>(r % H);
      r /= H;
      row_t[i] = static_cast<int>(r % T_out);
      row_b[i] = static_cast<int>(r / T_out);
    } else {
      row_b[i] = -1;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  __syncthreads();

  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    // A: BM rows x BK columns, 8 channels per 16-byte load
#pragma unroll
    for (int rep = 0; rep < (BM * BK / 8) / kThreads; ++rep) {
      const int idx = tid + rep * kThreads;
      const int r = idx / (BK / 8);
      const int cv = (idx % (BK / 8)) * 8;
      const int kk = k0 + cv;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      const int b = row_b[r];
      if (b >= 0 && kk < Ktot) {
        const int tap = kk / C;
        const int c = kk - tap * C;
        const int dt = tap / 9;
        const int dh = (tap / 3) % 3;
        const int dw = tap % 3;
        const int ti = row_t[r] + dt - time_pad;
        const int hi = row_h[r] + dh - 1;
        const int wi = row_w[r] + dw - 1;
        if (ti >= 0 && ti < T && hi >= 0 && hi < H && wi >= 0 && wi < W) {
          const long long off = (((static_cast<long long>(b) * T + ti) * H + hi) * W + wi) * C + c;
          val = *reinterpret_cast<const uint4*>(x + off);
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDA + cv) = val;
    }
    // B: BK rows x BN columns of w viewed as [Ktot, Co]
    {
      const int r = tid / (BN / 8);
      const int cv = (tid % (BN / 8)) * 8;
      const int kk = k0 + r;
      const int n = n0 + cv;
      if (vec_b) {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (kk < Ktot && n < Co)
          val = *reinterpret_cast<const uint4*>(w + static_cast<long long>(kk) * Co + n);
        *reinterpret_cast<uint4*>(Bs + r * LDB + cv) = val;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ok = kk < Ktot && n + e < Co;
          Bs[r * LDB + cv + e] = ok ? w[static_cast<long long>(kk) * Co + n + e] : __float2bfloat16(0.f);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + ks * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + ks * 16 * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue through shared memory (reuses the A/B tile space)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < Co)
      y[m * Co + n] = __float2bfloat16(Cs[r * LDC + c] + __bfloat162float(bias[n]));
  }
}

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;

__global__ void __launch_bounds__(kThreads)
    conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y, int T, int H,
                      int W, int C, int Co, int kt, int time_pad, int T_out, long long M,
                      int vec_b) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major: As[k][row]
  __shared__ __align__(16) float Bs[FBK][FBN + 4];
  __shared__ int row_b[FBM], row_t[FBM], row_h[FBM], row_w[FBM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16 * j
  const int ty = tid / 16;  // rows ty + 16 * i
  const long long m0 = static_cast<long long>(blockIdx.x) * FBM;
  const int n0 = blockIdx.y * FBN;
  const int Ktot = kt * 9 * C;

  for (int i = tid; i < FBM; i += kThreads) {
    const long long m = m0 + i;
    if (m < M) {
      long long r = m;
      row_w[i] = static_cast<int>(r % W);
      r /= W;
      row_h[i] = static_cast<int>(r % H);
      r /= H;
      row_t[i] = static_cast<int>(r % T_out);
      row_b[i] = static_cast<int>(r / T_out);
    } else {
      row_b[i] = -1;
    }
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < Ktot; k0 += FBK) {
    // A: FBM rows x FBK columns, 4 channels of one tap per 16-byte load
    {
      const int r = tid / (FBK / 4);
      const int cv = (tid % (FBK / 4)) * 4;
      const int kk = k0 + cv;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      const int b = row_b[r];
      if (b >= 0 && kk < Ktot) {
        const int tap = kk / C;
        const int c = kk - tap * C;
        const int ti = row_t[r] + tap / 9 - time_pad;
        const int hi = row_h[r] + (tap / 3) % 3 - 1;
        const int wi = row_w[r] + tap % 3 - 1;
        if (ti >= 0 && ti < T && hi >= 0 && hi < H && wi >= 0 && wi < W) {
          const long long off = (((static_cast<long long>(b) * T + ti) * H + hi) * W + wi) * C + c;
          val = *reinterpret_cast<const float4*>(x + off);
        }
      }
      As[cv][r] = val.x;
      As[cv + 1][r] = val.y;
      As[cv + 2][r] = val.z;
      As[cv + 3][r] = val.w;
    }
    // B: FBK rows x FBN columns of w viewed as [Ktot, Co]
    {
      const int r = tid / (FBN / 4);
      const int cv = (tid % (FBN / 4)) * 4;
      const int kk = k0 + r;
      const int n = n0 + cv;
      if (vec_b) {
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kk < Ktot && n < Co)
          val = *reinterpret_cast<const float4*>(w + static_cast<long long>(kk) * Co + n);
        *reinterpret_cast<float4*>(&Bs[r][cv]) = val;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kk < Ktot && n + e < Co;
          Bs[r][cv + e] = ok ? w[static_cast<long long>(kk) * Co + n + e] : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Co) y[m * Co + n] = acc[i][j] + bias[n];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, w, bias and y alike. x [B, T, H,
// W, C] and w [kt, 3, 3, C, Co] contiguous with C % 8 == 0 and 16-byte
// aligned; y [B, T + time_pad - kt + 1, H, W, Co].
extern "C" int fvt_conv3d_ndhwc(const void* x, const void* w, const void* bias, void* y,
                                int dtype, int B, int T, int H, int W, int C, int Co, int kt,
                                int time_pad, void* stream) {
  const int T_out = T + time_pad - kt + 1;
  if (C % 8 != 0 || T_out <= 0 || B <= 0 || Co <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * T_out * H * W;
  const int bm = dtype == 0 ? FBM : BM;
  const long long blocks_m = (M + bm - 1) / bm;
  if (blocks_m > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    dim3 grid(static_cast<unsigned>(blocks_m), (Co + FBN - 1) / FBN);
    conv3d_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), T, H, W, C, Co, kt, time_pad,
        T_out, M, Co % 4 == 0 ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid(static_cast<unsigned>(blocks_m), (Co + BN - 1) / BN);
  conv3d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(y), T, H, W, C, Co, kt, time_pad, T_out, M, Co % 8 == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

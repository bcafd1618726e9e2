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
// w+dw-1, c] is gathered on the fly; no padded copy of x exists. What
// bounds it: the VAE decoder's convs are tensor-core bound (2*M*N*K FLOP,
// e.g. 1.6e13 for one 96-channel 3x3x3 conv over 81 frames at 480x832,
// against ~0.2 GB of activations). Two schedules, chosen by the dtype
// alone (conv_route; ops/conv3d.py:conv_schedule states the same rule; no
// fallback between them):
//  - bf16, every decoder conv: conv3d_sm90.cuh, wgmma with the A operand
//    from TMA boxes of x that hold three taps each (TMA's zero fill is the
//    pad), the weight laid out once a call by the caller as the B operand
//    wants it, a TMA ring, fp32 sums in registers. The first bf16 schedule
//    (WMMA 128x64x32 through shared memory, synchronous loads with a bounds
//    check per element) ran 6x slower than cuDNN and is gone.
//  - fp32 (a decode with vae_decode_precision="fp32", whose JAX convs take
//    fp32 operands): the same implicit GEMM with fp32 FMAs on CUDA cores
//    and an fp32 accumulator, bias and output. wgmma has no fp32 operand,
//    and TF32 would leave the fp32 sum by about 1e-3 relative. It is a plain
//    SIMT tile, BM x BN x BK = 64 x 64 x 16, 256 threads each owning a
//    4 x 4 block of outputs, operands staged k-major in shared memory;
//    bounds checks give the causal pad, the SAME border and the masked Co
//    tail (Co not a multiple of 4). It is bound by the card's fp32 rate (67
//    TFLOP/s), and this first design is not tuned. Grid: (ceil(M / 64),
//    ceil(Co / 64)), 256 threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3d_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
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

// The schedule of a conv of `dtype` (0 = float32, 1 = bfloat16): 1 for the
// Hopper one (conv3d_sm90.cuh, fvt_conv3d_sm90), 0 for the SIMT one
// (fvt_conv3d_ndhwc). C and Co do not choose it.
int conv_route(int dtype) { return dtype == 1 ? 1 : 0; }

namespace s9 = fvt::sm90;

template <int BN>
int launch_sm90(s9::ConvParams& p, long long blocks, int bw, cudaStream_t stream) {
  const size_t smem = s9::conv_smem_bytes<BN>(bw);
  cudaError_t err = s9::set_smem(s9::conv3d_sm90<BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::conv3d_sm90<BN><<<static_cast<unsigned>(blocks), s9::kConvThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fvt_conv3d_route(int dtype, int C, int Co) {
  (void)C;
  (void)Co;
  return conv_route(dtype);
}

// The N tile of the Hopper schedule for Co output channels.
extern "C" int fvt_conv3d_tile_n(int Co) { return s9::conv_tile_n(Co); }

// The Hopper schedule's dynamic shared memory a block (bytes).
extern "C" int fvt_conv3d_sm90_smem(int Co, int bw) {
  const int bn = s9::conv_tile_n(Co);
  return static_cast<int>(bn == 8 ? s9::conv_smem_bytes<8>(bw)
                                  : bn == 96 ? s9::conv_smem_bytes<96>(bw)
                                             : s9::conv_smem_bytes<128>(bw));
}

// The Hopper schedule (bf16). x [B, T, H, W, C] contiguous, 16-byte
// aligned, C % 32 == 0 (the caller pads the channels with zeros); w the
// weight as [kt * 3 * C / 32, 3, Co_pad, 32] (stage (dt, dh, 32-channel
// chunk), tap dw, output channel, channel; zeros past Co and past the real
// channels), Co_pad a multiple of bn = fvt_conv3d_tile_n(Co); bias [Co];
// y [B, T + time_pad - kt + 1, H, W, Co]. bw, the patch width, is a power
// of two from 8 to 128 (the patch is bw x 128 / bw voxels).
extern "C" int fvt_conv3d_sm90(const void* x, const void* w, const void* bias, void* y, int B,
                               int T, int H, int W, int C, int Co, int kt, int time_pad, int bn,
                               int bw, void* stream) {
  const int T_out = T + time_pad - kt + 1;
  int bw_log2 = 0;
  while ((1 << bw_log2) < bw) ++bw_log2;
  if (C % s9::kConvChunk != 0 || T_out <= 0 || B <= 0 || Co <= 0 || (kt != 1 && kt != 3) ||
      bn != s9::conv_tile_n(Co) || bw < 8 || bw > 128 || (1 << bw_log2) != bw)
    return static_cast<int>(cudaErrorInvalidValue);
  s9::ConvParams p;
  const int bh = s9::kConvBM / bw;
  const int n_c = C / s9::kConvChunk;
  const int n_n = (Co + bn - 1) / bn;
  if (!s9::map_conv_x(&p.x, x, B, T, H, W, C, bw, bh) ||
      !s9::map_conv_w(&p.w, w, kt * 3 * n_c, n_n * bn, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  p.y = static_cast<bf16*>(y);
  p.bias = static_cast<const bf16*>(bias);
  p.T = T;
  p.H = H;
  p.W = W;
  p.Co = Co;
  p.kt = kt;
  p.time_pad = time_pad;
  p.T_out = T_out;
  p.n_c = n_c;
  p.bw_log2 = bw_log2;
  p.bh = bh;
  p.n_h = (H + bh - 1) / bh;
  p.n_w = (W + bw - 1) / bw;
  p.n_n = n_n;
  p.a_bytes = (bw + 2) * bh * s9::kConvChunk * 2;
  p.a_stride = static_cast<int>(s9::conv_a_stride(bw));
  const long long blocks = static_cast<long long>(B) * T_out * p.n_h * p.n_w * n_n;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 8 ? launch_sm90<8>(p, blocks, bw, s)
                 : bn == 96 ? launch_sm90<96>(p, blocks, bw, s) : launch_sm90<128>(p, blocks, bw, s);
}

// The SIMT schedule (fp32). x [B, T, H, W, C] and w [kt, 3, 3, C, Co]
// contiguous with C % 8 == 0 and 16-byte aligned; y [B, T + time_pad - kt +
// 1, H, W, Co]. dtype must be 0 (float32): bf16 takes fvt_conv3d_sm90.
extern "C" int fvt_conv3d_ndhwc(const void* x, const void* w, const void* bias, void* y,
                                int dtype, int B, int T, int H, int W, int C, int Co, int kt,
                                int time_pad, void* stream) {
  const int T_out = T + time_pad - kt + 1;
  if (C % 8 != 0 || T_out <= 0 || B <= 0 || Co <= 0 || conv_route(dtype) != 0 || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * T_out * H * W;
  const long long blocks_m = (M + FBM - 1) / FBM;
  if (blocks_m > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks_m), (Co + FBN - 1) / FBN);
  conv3d_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(y), T, H, W, C, Co, kt, time_pad, T_out, M, Co % 4 == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

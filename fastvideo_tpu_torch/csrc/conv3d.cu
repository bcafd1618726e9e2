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
//    fp32 operands): conv3d_tf32_sm90.cuh, the same frame with 3xTF32
//    products (each operand split into TF32 heads and tails, three wgmma
//    products a pair, each stage's sum drained into an fp32 total), which
//    hold the fp32 sum where one TF32 product leaves it by about 1e-3. It
//    is bound by the tensor cores' TF32 rate over three products (9.64 ms
//    at up3's 2-frame chunk, against 23.7 ms for fp32 FMAs at 67 TFLOP/s);
//    the first fp32 kernel (a SIMT 64 x 64 x 16 tile of FMAs, 84 ms there)
//    is gone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3d_sm90.cuh"
#include "conv3d_tf32_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The schedule of a conv of `dtype` (0 = float32, 1 = bfloat16): 1 for the
// bf16 Hopper one (conv3d_sm90.cuh, fvt_conv3d_sm90), 2 for the 3xTF32 one
// (conv3d_tf32_sm90.cuh, fvt_conv3d_tf32). C and Co do not choose it.
int conv_route(int dtype) { return dtype == 1 ? 1 : 2; }

namespace s9 = fvt::sm90;

template <int BN>
int launch_sm90(s9::ConvParams& p, long long blocks, int bw, cudaStream_t stream) {
  const size_t smem = s9::conv_smem_bytes<BN>(bw);
  cudaError_t err = s9::set_smem(s9::conv3d_sm90<BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::conv3d_sm90<BN><<<static_cast<unsigned>(blocks), s9::kConvThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tf32(s9::ConvTf32Params& p, long long blocks, int bw, cudaStream_t stream) {
  const size_t smem = s9::conv_tf32_smem_bytes<BN>(bw);
  cudaError_t err = s9::set_smem(s9::conv3d_tf32_sm90<BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::conv3d_tf32_sm90<BN><<<static_cast<unsigned>(blocks), s9::kConvThreads, smem, stream>>>(p);
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

// The N tile of the 3xTF32 schedule for Co output channels, and its
// dynamic shared memory a block (bytes).
extern "C" int fvt_conv3d_tf32_tile_n(int Co) { return s9::conv_tf32_tile_n(Co); }

extern "C" int fvt_conv3d_tf32_smem(int Co, int bw) {
  return static_cast<int>(s9::conv_tf32_tile_n(Co) == 8 ? s9::conv_tf32_smem_bytes<8>(bw)
                                                         : s9::conv_tf32_smem_bytes<96>(bw));
}

// The 3xTF32 schedule (fp32). x [B, T, H, W, C] contiguous fp32, 16-byte
// aligned, C % 16 == 0 (the caller pads the channels with zeros); w_hi and
// w_lo the weight's TF32 heads and tails, each as [kt * 3 * C / 16, 3,
// Co_pad, 16] (stage (dt, dh, 16-channel chunk), tap dw, output channel,
// channel; zeros past Co), Co_pad a multiple of bn =
// fvt_conv3d_tf32_tile_n(Co); bias [Co]; y [B, T + time_pad - kt + 1, H,
// W, Co]. bw, the patch width, as for fvt_conv3d_sm90.
extern "C" int fvt_conv3d_tf32(const void* x, const void* w_hi, const void* w_lo,
                               const void* bias, void* y, int B, int T, int H, int W, int C,
                               int Co, int kt, int time_pad, int bn, int bw, void* stream) {
  const int T_out = T + time_pad - kt + 1;
  int bw_log2 = 0;
  while ((1 << bw_log2) < bw) ++bw_log2;
  if (C % s9::kConvChunkF32 != 0 || T_out <= 0 || B <= 0 || Co <= 0 || (kt != 1 && kt != 3) ||
      bn != s9::conv_tf32_tile_n(Co) || bw < 8 || bw > 128 || (1 << bw_log2) != bw)
    return static_cast<int>(cudaErrorInvalidValue);
  s9::ConvTf32Params p;
  const int bh = s9::kConvBM / bw;
  const int n_c = C / s9::kConvChunkF32;
  const int n_n = (Co + bn - 1) / bn;
  if (!s9::map_conv_x_f32(&p.x, x, B, T, H, W, C, bw, bh) ||
      !s9::map_conv_w_f32(&p.w_hi, w_hi, kt * 3 * n_c, n_n * bn, bn) ||
      !s9::map_conv_w_f32(&p.w_lo, w_lo, kt * 3 * n_c, n_n * bn, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  p.y = static_cast<float*>(y);
  p.bias = static_cast<const float*>(bias);
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
  p.a_bytes = (bw + 2) * bh * s9::kConvChunkF32 * 4;
  p.a_stride = static_cast<int>(s9::conv_a_stride(bw));
  const long long blocks = static_cast<long long>(B) * T_out * p.n_h * p.n_w * n_n;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 8 ? launch_tf32<8>(p, blocks, bw, s) : launch_tf32<96>(p, blocks, bw, s);
}

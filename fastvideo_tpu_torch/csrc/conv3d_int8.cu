// W8A8 causal 3D convolution (kernel [kt, 3, 3], stride 1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel fastvideo_tpu/ops/conv3d.py:_conv_kernel_thcw_kf_int8
// (K4, the "kf_int8" / "auto_int8" decode convs): y = acc * scale[co] + bias[co]
// in fp32, written as bf16 (or, for an fp32 decode, as fp32: the JAX
// kernel writes out_dtype=x.dtype), where acc is the exact int32 sum over the
// kt*3*3*C taps of int8 x [B, T, H, W, C] (channels-last, one per-tensor
// scale folded into `scale`) times int8 w. `time_pad` zero frames go in
// front (causal) and the spatial padding is SAME.
//
// It is one implicit GEMM, as K3 (conv3d.cu): M = B*T_out*H*W output voxels,
// N = Co, K = kt*9*C, where A[m, (dt, dh, dw, c)] = x[b, t+dt-time_pad,
// h+dh-1, w+dw-1, c] is gathered on the fly and out-of-range taps (the
// causal pad and the spatial border) read zeros through bounds checks.
// Because C % 32 == 0, each 16-byte load of 16 channels lies inside one tap.
// The weight comes transposed as [Co, K] so that both operand tiles are
// rows of K bytes, the layout `mma.sync` reads for A (row) and B (col).
//
// What bounds it: the decoder's int8 convs are tensor-core bound
// (2*M*N*K operations, e.g. 1.6e12 for one 96-channel 3x3x3 conv over 8
// frames at 480x832, against ~1 GB of int8 input and bf16 output). The
// design is plain: a BM x BN x BK = 128 x 96 x 64 tile, 8 warps of
// mma.sync m16n8k32 s8.s8.s32 (each warp 32 x 48), operands loaded through
// registers into shared memory without overlap (no cp.async, TMA or wgmma
// yet). BN = 96 divides every Co the decoder sends here (96, 192); a warp
// skips its n8 tiles past Co (Co % 32 == 0). Rows are padded to 80 bytes,
// so the 32-bit fragment loads of a warp hit 32 different banks. The
// epilogue uses __fmul_rn / __fadd_rn, so it rounds exactly as the plain
// version's separate multiply and add.
//
// Grid: (ceil(M / BM), ceil(Co / BN)), 256 threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 96;
constexpr int BK = 64;  // int8 elements = bytes
constexpr int kThreads = 256;
constexpr int LDS = BK + 16;  // shared row stride in bytes (20 words)
constexpr int WN = 48;        // columns per warp: 6 n8 tiles

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
    conv3d_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       void* __restrict__ y, int out_f32, int T, int H, int W, int C, int Co,
                       int kt, int time_pad, int T_out, long long M) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  __shared__ int row_b[BM], row_t[BM], row_h[BM], row_w[BM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 4 warps along M, 32 rows each
  const int wn = warp & 1;   // 2 warps along N, 48 columns each
  const int g = lane >> 2;   // mma group (row within an 8-row half)
  const int tig = lane & 3;  // thread in group
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

  int acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    // A: BM rows x BK bytes, 16 channels of one tap per 16-byte load
#pragma unroll
    for (int rep = 0; rep < (BM * BK / 16) / kThreads; ++rep) {
      const int idx = tid + rep * kThreads;
      const int r = idx / (BK / 16);
      const int cv = (idx % (BK / 16)) * 16;
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
          const long long off =
              (((static_cast<long long>(b) * T + ti) * H + hi) * W + wi) * C + c;
          val = *reinterpret_cast<const uint4*>(x + off);
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDS + cv) = val;
    }
    // B: BN output channels x BK bytes of w [Co, K]
    for (int idx = tid; idx < BN * BK / 16; idx += kThreads) {
      const int r = idx / (BK / 16);
      const int cv = (idx % (BK / 16)) * 16;
      const int n = n0 + r;
      const int kk = k0 + cv;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < Co && kk < Ktot)
        val = *reinterpret_cast<const uint4*>(w + static_cast<long long>(n) * Ktot + kk);
      *reinterpret_cast<uint4*>(Bs + r * LDS + cv) = val;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = As + (wm * 32 + i * 16 + g) * LDS + ks + tig * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * LDS);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int col = wn * WN + j * 8;
        if (n0 + col >= Co) continue;  // warp-uniform: the n8 tile is past Co
        const int8_t* q = Bs + (col + g) * LDS + ks + tig * 4;
        const uint32_t b[2] = {lds32(q), lds32(q + 16)};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
      }
    }
    __syncthreads();
  }

  // epilogue: c0/c1 are columns (2*tig, 2*tig+1) of row g, c2/c3 of row g+8
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int n = n0 + wn * WN + j * 8 + tig * 2;
    if (n >= Co) continue;
    const float s0 = scale[n], s1 = scale[n + 1];
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 32 + i * 16 + g + half * 8;
        if (m >= M) continue;
        const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][half * 2]), s0), b0);
        const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][half * 2 + 1]), s1), b1);
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(y) + m * Co + n) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + m * Co + n) =
              __floats2bfloat162_rn(v0, v1);
      }
  }
}

}  // namespace

// x [B, T, H, W, C] int8 contiguous and 16-byte aligned, w [Co, kt*9*C] int8
// contiguous, scale and bias fp32 [Co], y [B, T + time_pad - kt + 1, H, W, Co]
// bf16 (out_dtype 1) or fp32 (out_dtype 0); C and Co multiples of 32.
extern "C" int fvt_conv3d_int8_ndhwc(const void* x, const void* w, const void* scale,
                                     const void* bias, void* y, int out_dtype, int B, int T,
                                     int H, int W, int C, int Co, int kt, int time_pad,
                                     void* stream) {
  const int T_out = T + time_pad - kt + 1;
  if (C % 32 != 0 || Co % 32 != 0 || T_out <= 0 || B <= 0 || (kt != 1 && kt != 3) ||
      (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * T_out * H * W;
  const long long blocks_m = (M + BM - 1) / BM;
  if (blocks_m > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks_m), (Co + BN - 1) / BN);
  conv3d_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      y, out_dtype == 0 ? 1 : 0, T, H, W, C, Co, kt, time_pad, T_out, M);
  return static_cast<int>(cudaGetLastError());
}

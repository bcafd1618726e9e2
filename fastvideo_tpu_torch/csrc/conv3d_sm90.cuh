// The causal conv's Hopper schedule (K3 at bf16): conv3d.cu launches it
// for every bf16 conv (fp32 takes its 3xTF32 form, conv3d_tf32_sm90.cuh,
// on this frame). It computes what the Pallas kernels _conv_kernel_thcw_kf and
// _conv_kernel compute (fastvideo_tpu/ops/conv3d.py:180, :55): y = conv(x,
// w) + bias over channels-last x [B, T, H, W, C], w [kt, 3, 3, C, Co],
// `time_pad` zero frames in front and SAME spatial padding, fp32 sums, a
// bf16 output.
//
// One implicit GEMM: M = output voxels, N = Co, K = kt * 9 * C. A block
// owns 128 output voxels, a bh x bw patch (bw * bh = 128, bw a power of two
// from 8 to 128, chosen on the host so that the patches cover W and H with
// the least waste: 64 x 2 at W = 832, 16 x 8 at W = 848) of one output
// frame, and one N tile of BN columns (BN 128, 96 or 8 by Co: 384 and 192
// split into tiles, conv_out's 3 channels take 8): two consumer warpgroups
// of 64 voxels, fp32 sums in registers.
//
// The K loop runs over stages (dt, dh, 32-channel chunk). A stage's A
// operand is ONE TMA box of x: {32 channels, bw + 2 columns, bh rows} at
// (c0, w0 - 1, h0 + dh - 1, t + dt - time_pad, b) of a 5-D tensor map. TMA
// fills zeros for coordinates outside the tensor, negative ones included,
// which is exactly the causal pad and the SAME border: no bounds check and
// no padded copy of x. The box holds the three dw taps at once: tap dw of
// voxel (hh, ww) is box row hh (bw + 2) + ww + dw, so the warps read their
// A fragments with ldmatrix at those rows (64-byte swizzle, no bank
// conflict) and pass them as the register A operand of wgmma; a stage
// reads x from L2 once for three taps. The stage's B operand is a TMA box
// of the weight, laid out once a call as [kt * 3 * nC, 3 (dw), Co_pad, 32]
// (ops/conv3d.py:sm90_weight): the three dw taps' [BN, 32] K-major tiles.
// Each stage is 6 wgmma.m64nBNk16 a warpgroup. Stages stream through a
// ring (sm90.cuh: Ring; thread 0 issues the copies), and a stage's
// products run while the next stage's fragments load. Time taps that read
// only the causal pad (t + dt < time_pad) are skipped: the first chunk's
// kt = 3 convs do a third of the work.
//
// What bounds it: 2 * M * N * K FLOP on the tensor cores (1.59e12 at up3's
// 96-channel conv over 8 output frames of 480 x 832) against ~1.4 GB of
// activations. The design keeps x's L2 traffic near one read a dt and dh
// (the box covers the dw taps) and the weight's at one read a block.
//
// Epilogue: bias added in registers, bf16 stored, masked at the W, H and
// Co tails.
#pragma once

#include "sm90.cuh"

namespace fvt {
namespace sm90 {

constexpr int kConvBM = 128;    // output voxels a block
constexpr int kConvChunk = 32;  // channels a stage (one 64-byte row)
constexpr int kConvThreads = 2 * kWarpgroup;

// The N tile of a bf16 conv with Co output channels. ops/conv3d.py:
// conv_tile_n states the same rule.
__host__ __device__ constexpr int conv_tile_n(int Co) {
  return Co <= 8 ? 8 : (Co % 128 == 0 ? 128 : 96);
}

template <int BN>
__host__ __device__ constexpr int conv_stages() {
  return BN == 128 ? 3 : 4;
}

// A stage's bytes: the x box (at most 160 rows of 64 bytes, at bw = 8) and
// the weight box.
__host__ __device__ constexpr size_t conv_a_stride(int bw) {
  return round_1k(static_cast<size_t>(bw + 2) * (kConvBM / bw) * kConvChunk * 2);
}
template <int BN>
__host__ __device__ constexpr size_t conv_b_stride() {
  return round_1k(3 * BN * kConvChunk * 2);
}

template <int BN>
__host__ __device__ constexpr size_t conv_smem_bytes(int bw) {
  return 1024 + conv_stages<BN>() * (conv_a_stride(bw) + conv_b_stride<BN>()) +
         Ring<conv_stages<BN>()>::bytes();
}

struct ConvParams {
  CUtensorMap x;  // [B, T, H, W, C] (C % 32 == 0), box {32, bw + 2, bh, 1, 1}
  CUtensorMap w;  // [kt * 3 * nC, 3, Co_pad, 32], box {32, BN, 3, 1}
  bf16* y;        // [B, T_out, H, W, Co]
  const bf16* bias;
  int T, H, W, Co, kt, time_pad, T_out;
  int n_c, bw_log2, bh, n_h, n_w, n_n;
  int a_bytes, a_stride;
};

// Shared memory descriptor of a K-major operand with the 64-byte swizzle:
// 64-byte rows (32 bf16), 8-row groups 512 bytes apart; a 16-value step
// along K moves the start 32 bytes.
__device__ __forceinline__ uint64_t desc64(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | 1ull << 16 |
         static_cast<uint64_t>(512 >> 4) << 32 | 2ull << 62;
}

// D[64 x N] (+)= A B, A a 64 x 16 bf16 fragment in registers, B in shared
// memory, K-major with the 64-byte swizzle (desc64).
__device__ __forceinline__ void mma_rs_k_n8(float (&d)[4], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_rs_k_n96(float (&d)[48], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_rs_k_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


template <int N>
__device__ __forceinline__ void mma_rs_k(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  if constexpr (N == 8)
    mma_rs_k_n8(d, a, db, acc);
  else if constexpr (N == 96)
    mma_rs_k_n96(d, a, db, acc);
  else
    mma_rs_k_n128(d, a, db, acc);
}

// One stage of a block's K loop: its A fragments (ldmatrix from the x box),
// then its 6 products, issued behind the previous stage's; that stage is
// released once its products are done. Two fragment buffers alternate, so
// a stage's loads run while the stage before it multiplies.
template <int BN, int NS, class Issue>
__device__ __forceinline__ void conv_stage(float (&acc)[BN / 2], uint32_t (&af)[3][2][4], int i,
                                           int n_steps, const Ring<NS>& ring, Issue& issue,
                                           const unsigned char* sa, const unsigned char* sb,
                                           int a_stride, const uint32_t (&a_off)[3][2]) {
  constexpr int kBStride = static_cast<int>(conv_b_stride<BN>());
  const int s = i % NS;
  ring.wait(i);
  const uint32_t a_base = smem_u32(sa + s * a_stride);
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) ldsm_x4(af[dw][ks], a_base + a_off[dw][ks]);
  const unsigned char* bt = sb + s * kBStride;
  mma_fence();
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      mma_rs_k<BN>(acc, af[dw][ks], desc64(bt + dw * BN * kConvChunk * 2 + ks * 32), 1);
  mma_commit();
  if (i > 0) {
    mma_wait<1>();
    fence_regs(acc);
    ring.release(i - 1, n_steps, issue);
  }
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1) conv3d_sm90(const __grid_constant__ ConvParams p) {
  constexpr int NS = conv_stages<BN>();
  constexpr int kBStride = static_cast<int>(conv_b_stride<BN>());
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  unsigned char* sa = carve.p;
  carve.p += NS * p.a_stride;
  unsigned char* sb = carve.p;
  carve.p += NS * kBStride;
  const Ring<NS> ring(carve);

  int bid = blockIdx.x;
  const int nt = bid % p.n_n;
  bid /= p.n_n;
  const int wt = bid % p.n_w;
  bid /= p.n_w;
  const int ht = bid % p.n_h;
  bid /= p.n_h;
  const int t = bid % p.T_out;
  const int b = bid / p.T_out;
  const int bw = 1 << p.bw_log2;
  const int w0 = wt * bw, h0 = ht * p.bh, n0 = nt * BN;
  // the time taps that read a real frame: t + dt - time_pad in [0, T)
  const int dt_lo = max(0, p.time_pad - t);
  const int dt_hi = min(p.kt, p.T + p.time_pad - t);
  const int per_dt = 3 * p.n_c;
  const int n_steps = max(0, dt_hi - dt_lo) * per_dt;

  auto issue = [&](int i) {
    const int s = i % NS;
    const int dt = dt_lo + i / per_dt;
    const int r = i % per_dt;
    const int dh = r / p.n_c, c = r % p.n_c;
    bar_expect(&ring.full[s], p.a_bytes + 3 * BN * kConvChunk * 2);
    tma_load_5d(sa + s * p.a_stride, &p.x, &ring.full[s], c * kConvChunk, w0 - 1, h0 + dh - 1,
                t + dt - p.time_pad, b);
    tma_load_4d(sb + s * kBStride, &p.w, &ring.full[s], 0, n0, 0, (dt * 3 + dh) * p.n_c + c);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  __syncthreads();  // the ring's barriers are initialised before any wait

  // this thread's ldmatrix rows: matrix j = lane / 8 holds rows 8 (j & 1)
  // .. + 7 and k columns 8 (j >> 1) .. + 7 of the warp's 16 x 16 A step
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWarpgroup, 0);
  const int lane = threadIdx.x % 32;
  const int j = lane / 8;
  const int m = 64 * wg + 16 * ((threadIdx.x % kWarpgroup) / 32) + 8 * (j & 1) + lane % 8;
  const int row0 = (m >> p.bw_log2) * (bw + 2) + (m & (bw - 1));
  uint32_t a_off[3][2];  // byte offset in a stage's x box of tap dw, k step ks
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int row = row0 + dw;
      const int chunk = 2 * ks + (j >> 1);
      a_off[dw][ks] = row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
    }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t af0[3][2][4], af1[3][2][4];

  for (int i = 0; i < n_steps; i += 2) {
    conv_stage<BN>(acc, af0, i, n_steps, ring, issue, sa, sb, p.a_stride, a_off);
    if (i + 1 < n_steps)
      conv_stage<BN>(acc, af1, i + 1, n_steps, ring, issue, sa, sb, p.a_stride, a_off);
  }
  // every product is done on every path before the epilogue reads the
  // sums (a wait in a divergent path would serialize the wgmma)
  mma_wait<0>();
  fence_regs(acc);
  if (n_steps > 0) ring.release(n_steps - 1, n_steps, issue);

  // epilogue: + bias, bf16, masked at the W, H and Co tails
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int r = 64 * wg + frag_row(e);
    const int h = h0 + (r >> p.bw_log2), w = w0 + (r & (bw - 1));
    const int n = n0 + frag_col(e);
    const float a0 = acc[e], a1 = acc[e + 1];
    if (h >= p.H || w >= p.W || n >= p.Co) continue;
    bf16* out = p.y + ((((static_cast<long long>(b) * p.T_out + t) * p.H + h) * p.W + w) * p.Co + n);
    const float v0 = a0 + __bfloat162float(p.bias[n]);
    if (n + 1 < p.Co) {
      const float v1 = a1 + __bfloat162float(p.bias[n + 1]);
      if ((p.Co & 1) == 0) {
        *reinterpret_cast<uint32_t*>(out) = pack_bf16(v0, v1);
      } else {
        out[0] = __float2bfloat16(v0);
        out[1] = __float2bfloat16(v1);
      }
    } else {
      out[0] = __float2bfloat16(v0);
    }
  }
}

// -- host ----------------------------------------------------------------------

// x: a contiguous bf16 [B, T, H, W, C] (C % 32 == 0), box {32, bw + 2, bh}
// of one (t, b), 64-byte swizzled; coordinates outside read as zero.
inline bool map_conv_x(CUtensorMap* map, const void* x, int B, int T, int H, int W, int C, int bw,
                       int bh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * C;
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * T};
  const cuuint32_t box[5] = {kConvChunk, static_cast<cuuint32_t>(bw + 2),
                             static_cast<cuuint32_t>(bh), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w: a contiguous bf16 [S, 3, Co_pad, 32], box {32, BN, 3, 1}: one stage's
// three dw taps of one N tile, 64-byte swizzled.
inline bool map_conv_w(CUtensorMap* map, const void* w, int S, int Co_pad, int bn) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kConvChunk, static_cast<cuuint64_t>(Co_pad), 3,
                              static_cast<cuuint64_t>(S)};
  const cuuint64_t row = 2ull * kConvChunk;
  const cuuint64_t strides[3] = {row, row * Co_pad, row * Co_pad * 3};
  const cuuint32_t box[4] = {kConvChunk, static_cast<cuuint32_t>(bn), 3, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(w), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fvt

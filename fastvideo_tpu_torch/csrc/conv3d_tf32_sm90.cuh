// The causal conv's fp32 form (K3 with fp32 operands, a decode with
// vae_decode_precision="fp32") on Hopper: 3xTF32 wgmma products on the
// bf16 schedule's frame (conv3d_sm90.cuh). It computes what the Pallas
// kernels _conv_kernel_thcw_kf and _conv_kernel compute on fp32 operands
// (fastvideo_tpu/ops/conv3d.py:180, :55): y = conv(x, w) + bias over
// channels-last x [B, T, H, W, C], w [kt, 3, 3, C, Co], `time_pad` zero
// frames in front, SAME spatial padding, fp32 sums and output.
//
// wgmma has no fp32 operand, and one TF32 product leaves the fp32 sum by
// about 1e-3 relative. So each operand is split into a TF32 head and a TF32
// tail, hi = tf32(a) and lo = tf32(a - hi) (cvt.rna.tf32.f32; the host
// splits the weight, ops/conv3d.py:sm90_weight_tf32), and each product a b
// is hi_a hi_b + hi_a lo_b + lo_a hi_b: three wgmma.m64nNk8.f32.tf32.tf32,
// which leaves out lo_a lo_b, about 2^-22 of the product. The tensor
// cores' fp32 sums lose about an ulp of the running sum a product step
// (chained over a whole K of 2,592, 4.4e-5 at outputs of order 1, 0.58 of
// the gate), so each stage's 48 products sum from zero in a stage
// accumulator that is drained into an fp32 total in registers at the
// stage's end (3.8e-6): a drain a stage costs 11 % at up3's conv.
//
// The frame is the bf16 schedule's: a block owns 128 output voxels (a bh x
// bw patch of one output frame) and one N tile of 96 output channels (8
// for conv_out's 3), two consumer warpgroups of 64 voxels. The K loop runs
// over stages (dt, dh, 16-channel chunk): 16 fp32 channels are the 64-byte
// rows of the bf16 schedule's 32, so a stage's x box {16, bw + 2, bh} (TMA
// zero fill is the causal pad and the SAME border), its 64-byte swizzle,
// the ldmatrix rows of its three dw taps and the K-major weight descriptor
// are the bf16 schedule's byte for byte; ldmatrix moves the fp32 values as
// pairs of 16-bit halves, which is the TF32 A fragment's layout (rows g,
// g + 8, columns t, t + 4). Each thread splits its A fragments in
// registers; the stage's B is two TMA boxes, the weight's heads and tails.
// A stage is 18 products a warpgroup (3 dw x 2 k-steps x 3); the next
// stage's fragments load while they run. Time taps that read only the
// causal pad are skipped.
//
// What bounds it: 3 x 2 M N K TF32 FLOP on the tensor cores (3 x 1.590e12
// at up3's 96-channel conv over 8 output frames of 480 x 832: 9.64 ms at
// 494.7 TFLOP/s), against 1.4 GB of fp32 activations. The first fp32
// kernel ran fp32 FMAs on the CUDA cores (23.731 ms of needed work at 67
// TFLOP/s, 84 ms as written).
#pragma once

#include "conv3d_sm90.cuh"

namespace fvt {
namespace sm90 {

constexpr int kConvChunkF32 = 16;  // fp32 channels a stage (one 64-byte row)
constexpr int kConvStagesF32 = 4;

// The N tile of an fp32 conv with Co output channels. ops/conv3d.py:
// conv_tf32_tile_n states the same rule.
__host__ __device__ constexpr int conv_tf32_tile_n(int Co) { return Co <= 8 ? 8 : 96; }

// One of a stage's two weight boxes (heads, tails): three dw taps' [BN, 16].
template <int BN>
__host__ __device__ constexpr size_t conv_tf32_b_stride() {
  return round_1k(3 * BN * kConvChunkF32 * 4);
}

template <int BN>
__host__ __device__ constexpr size_t conv_tf32_smem_bytes(int bw) {
  return 1024 + kConvStagesF32 * (conv_a_stride(bw) + 2 * conv_tf32_b_stride<BN>()) +
         Ring<kConvStagesF32>::bytes();
}

struct ConvTf32Params {
  CUtensorMap x;     // fp32 [B, T, H, W, C] (C % 16 == 0), box {16, bw + 2, bh, 1, 1}
  CUtensorMap w_hi;  // fp32 [kt * 3 * nC, 3, Co_pad, 16], box {16, BN, 3, 1}
  CUtensorMap w_lo;
  float* y;  // [B, T_out, H, W, Co]
  const float* bias;
  int T, H, W, Co, kt, time_pad, T_out;
  int n_c, bw_log2, bh, n_h, n_w, n_n;
  int a_bytes, a_stride;
};

// D[64 x 8] (+)= A B in TF32: A a 64 x 8 fragment in registers (four
// 32-bit values a thread: rows g, g + 8 and columns t, t + 4 of the warp's
// 16 x 8 step), B in shared memory, K-major with the 64-byte swizzle.
__device__ __forceinline__ void mma_tf32_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 96] (+)= A B in TF32, as mma_tf32_n8.
__device__ __forceinline__ void mma_tf32_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  if constexpr (N == 8)
    mma_tf32_n8(d, a, db, acc);
  else
    mma_tf32_n96(d, a, db, acc);
}

// A stage's A fragments: ldmatrix from its x box, split into heads and
// tails.
template <int NS>
__device__ __forceinline__ void conv_tf32_frags(uint32_t (&hi)[3][2][4], uint32_t (&lo)[3][2][4],
                                                int i, const Ring<NS>& ring,
                                                const unsigned char* sa, int a_stride,
                                                const uint32_t (&a_off)[3][2]) {
  ring.wait(i);
  const uint32_t a_base = smem_u32(sa + (i % NS) * a_stride);
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      ldsm_x4(hi[dw][ks], a_base + a_off[dw][ks]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = __uint_as_float(hi[dw][ks][r]);
        const uint32_t h = tf32_rna(a);
        lo[dw][ks][r] = tf32_rna(a - __uint_as_float(h));
        hi[dw][ks][r] = h;
      }
    }
}

// A stage's 18 products, one commit group, into the stage accumulator:
// the first overwrites it, the rest add (the tails first, then the
// heads).
template <int BN, int NS>
__device__ __forceinline__ void conv_tf32_products(float (&acc)[BN / 2],
                                                   const uint32_t (&hi)[3][2][4],
                                                   const uint32_t (&lo)[3][2][4], int i,
                                                   const unsigned char* sb) {
  constexpr int kBStride = static_cast<int>(conv_tf32_b_stride<BN>());
  const unsigned char* b_hi = sb + (i % NS) * 2 * kBStride;
  const unsigned char* b_lo = b_hi + kBStride;
  mma_fence();
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int off = dw * BN * kConvChunkF32 * 4 + ks * 32;
      mma_tf32<BN>(acc, lo[dw][ks], desc64(b_hi + off), dw + ks > 0);
      mma_tf32<BN>(acc, hi[dw][ks], desc64(b_lo + off), 1);
      mma_tf32<BN>(acc, hi[dw][ks], desc64(b_hi + off), 1);
    }
  mma_commit();
}

// The end of a stage: its products done, its stage released, its sum
// added to the total in fp32 (round to nearest).
template <int BN, int NS, class Issue>
__device__ __forceinline__ void conv_tf32_drain(float (&acc)[BN / 2], float (&total)[BN / 2],
                                                int i, int n_steps, const Ring<NS>& ring,
                                                Issue& issue) {
  mma_wait<0>();
  fence_regs(acc);
  ring.release(i, n_steps, issue);
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) total[e] += acc[e];
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    conv3d_tf32_sm90(const __grid_constant__ ConvTf32Params p) {
  constexpr int NS = kConvStagesF32;
  constexpr int kBStride = static_cast<int>(conv_tf32_b_stride<BN>());
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  unsigned char* sa = carve.p;
  carve.p += NS * p.a_stride;
  unsigned char* sb = carve.p;
  carve.p += NS * 2 * kBStride;
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
    const int stage = (dt * 3 + dh) * p.n_c + c;
    unsigned char* bt = sb + s * 2 * kBStride;
    bar_expect(&ring.full[s], p.a_bytes + 2 * 3 * BN * kConvChunkF32 * 4);
    tma_load_5d(sa + s * p.a_stride, &p.x, &ring.full[s], c * kConvChunkF32, w0 - 1, h0 + dh - 1,
                t + dt - p.time_pad, b);
    tma_load_4d(bt, &p.w_hi, &ring.full[s], 0, n0, 0, stage);
    tma_load_4d(bt + kBStride, &p.w_lo, &ring.full[s], 0, n0, 0, stage);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  __syncthreads();  // the ring's barriers are initialised before any wait

  // this thread's ldmatrix rows, as in conv3d_sm90: matrix j = lane / 8
  // holds voxels 8 (j & 1) .. + 7 and the 16-byte half j >> 1 of a k step
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWarpgroup, 0);
  const int lane = threadIdx.x % 32;
  const int j = lane / 8;
  const int m = 64 * wg + 16 * ((threadIdx.x % kWarpgroup) / 32) + 8 * (j & 1) + lane % 8;
  const int row0 = (m >> p.bw_log2) * (bw + 2) + (m & (bw - 1));
  uint32_t a_off[3][2];
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int row = row0 + dw;
      const int chunk = 2 * ks + (j >> 1);
      a_off[dw][ks] = row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
    }

  // the stage accumulator and the fp32 total; two fragment buffers
  // alternate, so a stage's fragments load while the stage before it
  // multiplies
  float acc[BN / 2], total[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;
  uint32_t hi0[3][2][4], lo0[3][2][4], hi1[3][2][4], lo1[3][2][4];

  if (n_steps > 0) conv_tf32_frags<NS>(hi0, lo0, 0, ring, sa, p.a_stride, a_off);
  for (int i = 0; i < n_steps; i += 2) {
    conv_tf32_products<BN, NS>(acc, hi0, lo0, i, sb);
    if (i + 1 < n_steps) conv_tf32_frags<NS>(hi1, lo1, i + 1, ring, sa, p.a_stride, a_off);
    conv_tf32_drain<BN>(acc, total, i, n_steps, ring, issue);
    if (i + 1 < n_steps) {
      conv_tf32_products<BN, NS>(acc, hi1, lo1, i + 1, sb);
      if (i + 2 < n_steps) conv_tf32_frags<NS>(hi0, lo0, i + 2, ring, sa, p.a_stride, a_off);
      conv_tf32_drain<BN>(acc, total, i + 1, n_steps, ring, issue);
    }
  }

  // epilogue: total + bias, fp32, masked at the W, H and Co tails
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int r = 64 * wg + frag_row(e);
    const int h = h0 + (r >> p.bw_log2), w = w0 + (r & (bw - 1));
    const int n = n0 + frag_col(e);
    const float a0 = total[e], a1 = total[e + 1];
    if (h >= p.H || w >= p.W || n >= p.Co) continue;
    float* out = p.y + ((((static_cast<long long>(b) * p.T_out + t) * p.H + h) * p.W + w) * p.Co + n);
    const float v0 = a0 + __ldg(p.bias + n);
    if (n + 1 < p.Co) {
      const float v1 = a1 + __ldg(p.bias + n + 1);
      if ((p.Co & 1) == 0) {
        *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
      } else {
        out[0] = v0;
        out[1] = v1;
      }
    } else {
      out[0] = v0;
    }
  }
}

// -- host ----------------------------------------------------------------------

// x: a contiguous fp32 [B, T, H, W, C] (C % 16 == 0), box {16, bw + 2, bh}
// of one (t, b), 64-byte swizzled; coordinates outside read as zero.
inline bool map_conv_x_f32(CUtensorMap* map, const void* x, int B, int T, int H, int W, int C,
                           int bw, int bh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 4ull * C;
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * T};
  const cuuint32_t box[5] = {kConvChunkF32, static_cast<cuuint32_t>(bw + 2),
                             static_cast<cuuint32_t>(bh), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(x), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w: a contiguous fp32 [S, 3, Co_pad, 16] (heads or tails), box {16, BN,
// 3, 1}: one stage's three dw taps of one N tile, 64-byte swizzled.
inline bool map_conv_w_f32(CUtensorMap* map, const void* w, int S, int Co_pad, int bn) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kConvChunkF32, static_cast<cuuint64_t>(Co_pad), 3,
                              static_cast<cuuint64_t>(S)};
  const cuuint64_t row = 4ull * kConvChunkF32;
  const cuuint64_t strides[3] = {row, row * Co_pad, row * Co_pad * 3};
  const cuuint32_t box[4] = {kConvChunkF32, static_cast<cuuint32_t>(bn), 3, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(w), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fvt

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
// What bounds it: the decoder's int8 convs are tensor-core bound (2*M*N*K
// int8 operations, 1.59e12 at up3's 96-channel conv over 8 output frames of
// 480 x 832, against ~0.4 GB of int8 input and bf16 output), and behind the
// tensor cores by the rows their copies bring (below).
//
// The design is K3's Hopper schedule (conv3d_sm90.cuh) with s8 operands,
// and with fewer, larger copies: one implicit GEMM (M = output voxels, N =
// Co, K = kt * 9 * C); a block owns 128 output voxels, a bw x 128/bw patch
// of one output frame (ops/conv3d.py:conv_tile_w), and one N tile; two
// consumer warpgroups of 64 voxels keep int32 sums in registers. A K
// stage is (dt, 32-channel chunk): ONE TMA box of x {32 channels, bw + 2,
// bh + 2} whose zero fill is the causal pad and the SAME border; tap (dh,
// dw) of voxel (hh, ww) is box row (hh + dh) (bw + 2) + ww + dw, read by
// ldmatrix as the register A operand, so all nine spatial taps share one
// copy. An s8 k32 fragment covers the 16 rows x 32 bytes a bf16 k16
// fragment covers, so K3's ldmatrix addressing carries over byte for
// byte, here on 32-byte rows with the 32-byte swizzle. The stage's B
// operand is the nine taps' [BN, 32] K-major tiles of the weight (8-bit
// wgmma takes B K-major only), laid out once a call as [Co_pad / BN, kt *
// nC, 9 (dh, dw), BN, 32] with the 32-byte swizzle already applied
// (ops/conv3d.py:sm90_weight_int8), so that each (N tile, stage) is one
// contiguous block that ONE bulk copy brings as it is. TMA's cost goes by
// rows, not bytes (with K3's copies, a box of x for each dh and a box of
// 3 BN 32-byte weight rows, a stage took K3's time at half its bytes), so
// a stage reads its x rows once for nine taps and its weight as one
// block. Each stage is 9 wgmma.m64nBNk32.s32.s8.s8 a warpgroup in one
// commit group; stages stream through a ring of 3 (sm90.cuh: Ring; thread
// 0 issues the copies). Time taps that read only the causal pad are
// skipped.
//
// Stage depth: 32 channels (one k32 step a tap). A 64-channel stage would
// halve the stage count at C = 192 and 384, but C = 96 (up3, the hot conv)
// would then split 64 + 32 with a half-empty second stage or multiply a
// third of zeros; 32 divides every C the int8 route takes (C % 32 == 0).
// Three stages fit two blocks an SM at N 96 and the hot patches (bw 64 and
// 16), one at N 192.
//
// N tile (conv8_tile_n; ops/conv3d.py:conv_int8_tile_n states the same
// rule): 192 where it divides Co (192; 384: two tiles), else 96 (96; the
// route's edges 32 and 64 pad to 96). A 192-wide tile reads each x box
// once for 192 outputs, not twice.
//
// Epilogue: float(acc), __fmul_rn by scale[co], __fadd_rn of bias[co], then
// the bf16 or fp32 store, masked at the W and H tails: the int32 sum is
// exact in any order and the epilogue rounds as the plain version's
// separate multiply and add, so the result is bit for bit the plain one.
#include "conv3d_sm90.cuh"

namespace fvt {
namespace sm90 {

// The N tile of an int8 conv with Co output channels (Co % 32 == 0).
// ops/conv3d.py:conv_int8_tile_n states the same rule.
__host__ __device__ constexpr int conv8_tile_n(int Co) { return Co % 192 == 0 ? 192 : 96; }

constexpr int kConv8Stages = 3;

// A stage's bytes: the x box (at most 390 rows of 32 bytes, at bw = 128)
// and the weight block of its nine taps.
__host__ __device__ constexpr size_t conv8_a_stride(int bw) {
  return round_1k(static_cast<size_t>(bw + 2) * (kConvBM / bw + 2) * kConvChunk);
}
template <int BN>
__host__ __device__ constexpr size_t conv8_b_stride() {
  return round_1k(9 * BN * kConvChunk);
}

template <int BN>
__host__ __device__ constexpr size_t conv8_smem_bytes(int bw) {
  return 1024 + kConv8Stages * (conv8_a_stride(bw) + conv8_b_stride<BN>()) +
         Ring<kConv8Stages>::bytes();
}

struct Conv8Params {
  CUtensorMap x;  // int8 [B, T, H, W, C] (C % 32 == 0), box {32, bw + 2, bh + 2, 1, 1}
  const int8_t* w;  // [Co_pad / BN, kt * nC, 9, BN, 32], 32-byte swizzled
  void* y;        // bf16 or fp32 (out_f32) [B, T_out, H, W, Co]
  const float* scale;
  const float* bias;
  int out_f32;
  int T, H, W, Co, kt, time_pad, T_out;
  int n_c, bw_log2, bh, n_h, n_w, n_n;
  int a_bytes, a_stride;
};

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared memory descriptor of a K-major operand with the 32-byte swizzle:
// 32-byte rows (32 int8), 8-row groups 256 bytes apart; one k32 step is
// the whole row.
__device__ __forceinline__ uint64_t desc32(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | 1ull << 16 |
         static_cast<uint64_t>(256 >> 4) << 32 | 3ull << 62;
}

// D[64 x N] (+)= A B in int32, A a 64 x 32 s8 fragment in registers (the
// byte layout of a bf16 k16 fragment), B in shared memory, K-major with
// the 32-byte swizzle (desc32).
__device__ __forceinline__ void mma_s8_n96(int (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_s8_n192(int (&d)[96], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (N == 96)
    mma_s8_n96(d, a, db, acc);
  else
    mma_s8_n192(d, a, db, acc);
}

// Keep the compiler from moving reads or writes of the int32 sums across
// an asynchronous product's issue or its wait.
template <int N>
__device__ __forceinline__ void fence_iregs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Whether a block of N tile BN drains its products at each stage's end: at
// N 96 one fragment buffer keeps a thread within 128 registers, so two
// blocks share an SM and each one's products fill the other's fragment
// loads; at N 192 a block has the SM to itself and double-buffers.
template <int BN>
__host__ __device__ constexpr bool conv8_drain() {
  return BN == 96;
}

// Stage i of a block's K loop: its A fragments of all nine taps (ldmatrix
// from the x box), then its 9 products in one commit group. Draining, the
// stage waits for them and is released; else they are issued behind the
// previous stage's, which is then released, and two fragment buffers
// alternate, so a stage's loads run while the stage before it multiplies.
// (Three commit groups a stage, one a tap row on fewer fragment
// registers, made ptxas serialize the wgmma, C7513.)
template <int BN, int NS, class Issue>
__device__ __forceinline__ void conv8_stage(int (&acc)[BN / 2], uint32_t (&af)[9][4], int i,
                                            int n_steps, const Ring<NS>& ring, Issue& issue,
                                            const unsigned char* sa, const unsigned char* sb,
                                            int a_stride, const uint32_t (&a_off)[9]) {
  constexpr int kBStride = static_cast<int>(conv8_b_stride<BN>());
  const int s = i % NS;
  ring.wait(i);
  const uint32_t a_base = smem_u32(sa + s * a_stride);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) ldsm_x4(af[tap], a_base + a_off[tap]);
  const unsigned char* bt = sb + s * kBStride;
  mma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    mma_s8<BN>(acc, af[tap], desc32(bt + tap * BN * kConvChunk), 1);
  mma_commit();
  if constexpr (conv8_drain<BN>()) {
    mma_wait<0>();
    fence_iregs(acc);
    ring.release(i, n_steps, issue);
  } else if (i > 0) {
    mma_wait<1>();
    fence_iregs(acc);
    ring.release(i - 1, n_steps, issue);
  }
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, conv8_drain<BN>() ? 2 : 1)
    conv3d_int8_sm90(const __grid_constant__ Conv8Params p) {
  constexpr int NS = kConv8Stages;
  constexpr int kBStride = static_cast<int>(conv8_b_stride<BN>());
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
  const int n_steps = max(0, dt_hi - dt_lo) * p.n_c;

  constexpr int kBTile = 9 * BN * kConvChunk;  // a stage's weight bytes
  const int8_t* w_tile = p.w + static_cast<long long>(nt) * p.kt * p.n_c * kBTile;
  auto issue = [&](int i) {
    const int s = i % NS;
    const int dt = dt_lo + i / p.n_c, c = i % p.n_c;
    bar_expect(&ring.full[s], p.a_bytes + kBTile);
    tma_load_5d(sa + s * p.a_stride, &p.x, &ring.full[s], c * kConvChunk, w0 - 1, h0 - 1,
                t + dt - p.time_pad, b);
    bulk_load(sb + s * kBStride, w_tile + static_cast<long long>(dt * p.n_c + c) * kBTile, kBTile,
              &ring.full[s]);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  __syncthreads();  // the ring's barriers are initialised before any wait

  // this thread's ldmatrix rows: matrix j = lane / 8 holds rows 8 (j & 1)
  // .. + 7 and bytes 16 (j >> 1) .. + 15 of the warp's 16 x 32 A step
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWarpgroup, 0);
  const int lane = threadIdx.x % 32;
  const int j = lane / 8;
  const int m = 64 * wg + 16 * ((threadIdx.x % kWarpgroup) / 32) + 8 * (j & 1) + lane % 8;
  const int row0 = (m >> p.bw_log2) * (bw + 2) + (m & (bw - 1));
  uint32_t a_off[9];  // byte offset in a stage's x box of tap (dh, dw)
#pragma unroll
  for (int dh = 0; dh < 3; ++dh)
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      // 32-byte swizzle: 16-byte chunk c of a row at c ^ bit 2 of the row
      const int row = row0 + dh * (bw + 2) + dw;
      a_off[3 * dh + dw] = row * 32 + (((j >> 1) ^ ((row >> 2) & 1)) << 4);
    }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  uint32_t af0[9][4];
  if constexpr (conv8_drain<BN>()) {
    for (int i = 0; i < n_steps; ++i)
      conv8_stage<BN>(acc, af0, i, n_steps, ring, issue, sa, sb, p.a_stride, a_off);
  } else {
    uint32_t af1[9][4];
    for (int i = 0; i < n_steps; i += 2) {
      conv8_stage<BN>(acc, af0, i, n_steps, ring, issue, sa, sb, p.a_stride, a_off);
      if (i + 1 < n_steps)
        conv8_stage<BN>(acc, af1, i + 1, n_steps, ring, issue, sa, sb, p.a_stride, a_off);
    }
  }
  // every product is done on every path before the epilogue reads the
  // sums (a wait in a divergent path would serialize the wgmma)
  mma_wait<0>();
  fence_iregs(acc);
  if (!conv8_drain<BN>() && n_steps > 0) ring.release(n_steps - 1, n_steps, issue);

  // epilogue: acc * scale + bias in fp32 with the plain version's roundings,
  // bf16 or fp32, masked at the W and H tails (Co % 32 == 0 and n is even,
  // so a pair never straddles Co)
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int r = 64 * wg + frag_row(e);
    const int h = h0 + (r >> p.bw_log2), w = w0 + (r & (bw - 1));
    const int n = n0 + frag_col(e);
    if (h >= p.H || w >= p.W || n >= p.Co) continue;
    const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[e]), p.scale[n]), p.bias[n]);
    const float v1 =
        __fadd_rn(__fmul_rn(__int2float_rn(acc[e + 1]), p.scale[n + 1]), p.bias[n + 1]);
    const long long off =
        (((static_cast<long long>(b) * p.T_out + t) * p.H + h) * p.W + w) * p.Co + n;
    if (p.out_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(p.y) + off) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.y) + off) =
          __floats2bfloat162_rn(v0, v1);
  }
}

// -- host ----------------------------------------------------------------------

// x: a contiguous int8 [B, T, H, W, C] (C % 32 == 0), box {32, bw + 2, bh + 2}
// of one (t, b), 32-byte swizzled; coordinates outside read as zero.
inline bool map_conv8_x(CUtensorMap* map, const void* x, int B, int T, int H, int W, int C,
                        int bw, int bh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(C);
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * T};
  const cuuint32_t box[5] = {kConvChunk, static_cast<cuuint32_t>(bw + 2),
                             static_cast<cuuint32_t>(bh + 2), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fvt

namespace {

namespace s9 = fvt::sm90;

template <int BN>
int launch_sm90(s9::Conv8Params& p, long long blocks, int bw, cudaStream_t stream) {
  const size_t smem = s9::conv8_smem_bytes<BN>(bw);
  cudaError_t err = s9::set_smem(s9::conv3d_int8_sm90<BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::conv3d_int8_sm90<BN><<<static_cast<unsigned>(blocks), s9::kConvThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The N tile of the int8 conv for Co output channels.
extern "C" int fvt_conv3d_int8_tile_n(int Co) { return s9::conv8_tile_n(Co); }

// The int8 conv's dynamic shared memory a block (bytes).
extern "C" int fvt_conv3d_int8_sm90_smem(int Co, int bw) {
  return static_cast<int>(s9::conv8_tile_n(Co) == 96 ? s9::conv8_smem_bytes<96>(bw)
                                                     : s9::conv8_smem_bytes<192>(bw));
}

// x [B, T, H, W, C] int8 contiguous and 16-byte aligned; w the weight as
// [Co_pad / bn, kt * C / 32, 9, bn, 32] int8, 16-byte aligned (N tile,
// stage (dt, 32-channel chunk), tap (dh, dw), output channel, channel;
// zeros past Co; the 16-byte halves of rows 4..7 of each 8-row group
// swapped, the 32-byte swizzle), Co_pad a multiple of bn =
// fvt_conv3d_int8_tile_n(Co); scale and bias fp32 [Co]; y [B, T +
// time_pad - kt + 1, H, W, Co] bf16 (out_dtype 1) or fp32 (out_dtype 0);
// C and Co multiples of 32. bw, the patch width, is a power of two from 8
// to 128 (the patch is bw x 128 / bw voxels).
extern "C" int fvt_conv3d_int8_sm90(const void* x, const void* w, const void* scale,
                                    const void* bias, void* y, int out_dtype, int B, int T,
                                    int H, int W, int C, int Co, int kt, int time_pad, int bn,
                                    int bw, void* stream) {
  const int T_out = T + time_pad - kt + 1;
  int bw_log2 = 0;
  while ((1 << bw_log2) < bw) ++bw_log2;
  if (C % 32 != 0 || Co % 32 != 0 || T_out <= 0 || B <= 0 || (kt != 1 && kt != 3) ||
      (out_dtype != 0 && out_dtype != 1) || bn != s9::conv8_tile_n(Co) || bw < 8 || bw > 128 ||
      (1 << bw_log2) != bw || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  s9::Conv8Params p;
  const int bh = s9::kConvBM / bw;
  const int n_c = C / s9::kConvChunk;
  const int n_n = (Co + bn - 1) / bn;
  if (!s9::map_conv8_x(&p.x, x, B, T, H, W, C, bw, bh))
    return static_cast<int>(cudaErrorInvalidValue);
  p.w = static_cast<const int8_t*>(w);
  p.y = y;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out_f32 = out_dtype == 0 ? 1 : 0;
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
  p.a_bytes = (bw + 2) * (bh + 2) * s9::kConvChunk;
  p.a_stride = static_cast<int>(s9::conv8_a_stride(bw));
  const long long blocks = static_cast<long long>(B) * T_out * p.n_h * p.n_w * n_n;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 96 ? launch_sm90<96>(p, blocks, bw, s) : launch_sm90<192>(p, blocks, bw, s);
}

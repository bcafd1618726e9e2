// The flash attention forward's Hopper schedule at a head of 384 (K1 at
// bf16, the VAE's mid-block attention): flash_fwd.cu launches it for K1
// with bf16 operands and D = 384 (fp32 at 384 runs the 3xTF32 form,
// flash_fwd_wide_tf32_sm90.cuh), and keeps attn_tile.cuh for K5 and K1
// struct at heads other than 64 and 128. It replaces the
// Pallas _fwd_kernel (fastvideo_tpu/ops/flash_attention.py:93, call :222)
// as JAX's VAE calls it (fastvideo_tpu/models/vaes/wan.py:296-308): one
// head of 384 over the 6,240 (480x848: 6,360) tokens of a latent frame, a
// frame a batch row, q, k and v column views of one qkv tensor (a row
// stride of 1,152 values), no mask.
//
// What bounds it: the tensor cores (4 D FLOP a (query, key) pair, 1.196e11
// at the 2-frame decode chunk, 0.121 ms at 989 TFLOP/s, against 19 MB of
// operands). What made the first schedule 50x its bound was the width of
// the head: O[64 x 384] in fp32 is 192 registers a thread of a warpgroup,
// so attn_tile.cuh kept S, P and O in shared memory (214 KB, one 4-warp
// block an SM) and ran WMMA 16x16x16 with synchronous loads. Here a block
// owns 128 query rows, a warpgroup 64 of them with all 384 columns of O in
// registers (192 a thread, as two 192-column products) and S over 32 keys
// a chunk (16 more): the needed products only, at the edge of the register
// file (242 registers, no spill). The other layout timed, both warpgroups
// computing S for 64 shared rows and each keeping 192 of O's columns (P
// stays in registers at the price of computing S twice), ran 9-16 %
// slower (PERF.md, PR 12). Shared memory holds Q (128 x 384) and a
// two-stage ring of K and V chunks (TMA boxes of {64, rows} with the
// 128-byte swizzle straight from the strided views; thread 0 keeps the
// copies in flight): 194 KB, one block an SM. The next chunk's S product
// is issued before this chunk's P V product is waited for, as in
// flash_fwd_sm90.cuh, whose online softmax (exp2, P rounded to bf16
// before P V as the Pallas kernel's p.astype(v.dtype)) this schedule
// shares.
//
// Filling the card: a batch of one frame is 49 blocks for 132 SMs, two
// frames 98. The keys of each query tile are cut into `splits` ranges of
// whole chunks (wide_splits: the fewest that fill the card's waves to
// 90 %; ops/flash_attention.py states the same rule), each block writing
// its rows' O / l in fp32 and their LSE, and flash_fwd_combine merges the
// partials (weights exp(lse_z - max), in split order) into the bf16
// output and the LSE. One split writes O and the LSE directly. Masks:
// kv_valid and causal (a tile walks the keys up to its last row); a row
// with no valid key outputs 0 and an LSE of -inf.
#pragma once

#include "sm90.cuh"

namespace fvt {
namespace sm90 {

constexpr int kWideD = 384;
constexpr int kWideStages = 2;
constexpr int kWideThreads = 2 * kWarpgroup;
constexpr int kWideMaxSplits = 8;
constexpr int kCombineRows = 4;  // rows a combine block: 96 threads a row
constexpr int kWideBQ = 128;  // query rows a block: two warpgroups of 64
constexpr int kWideBK = 32;   // keys a chunk

struct WideParams {
  CUtensorMap q, k, v;  // boxes {64, kWideBQ}, {64, kWideBK}, {64, kWideBK}
  bf16* o;              // one split: [B, Sq, H, 384] (strided), and
  float* lse;           // [B, H, Sq] or null
  long long o_sb, o_sh, o_ss;
  float* part;      // splits > 1: O / l [splits, B, H, Sq, 384] and
  float* lse_part;  // the LSE [splits, B, H, Sq], fp32
  int B, H, Sq, Skv, n_qtiles, splits;
  float scale_log2;  // scale * log2(e)
  int causal, kv_valid;
};

// Dynamic shared memory of one block, in the order the kernel carves it.
__host__ __device__ constexpr size_t wide_smem_bytes() {
  return 1024 + round_1k(kWideBQ * kWideD * 2) + 2 * round_1k(kWideStages * kWideBK * kWideD * 2) +
         Ring<kWideStages>::bytes();
}

// Key splits of a launch of `blocks` blocks whose query tiles walk `chunks`
// key chunks each, on `sms` SMs: the fewest (at most kWideMaxSplits and
// `chunks`) whose waves are at least 90 % full, else the fullest.
// ops/flash_attention.py:wide_splits states the same rule.
inline int wide_splits(long long blocks, int chunks, int sms) {
  const int top = chunks < 1 ? 1 : (chunks < kWideMaxSplits ? chunks : kWideMaxSplits);
  int best = 1;
  long long best_n = 0, best_cap = 1;
  for (int s = 1; s <= top; ++s) {
    const long long n = blocks * s;
    const long long cap = (n + sms - 1) / sms * sms;
    if (10 * n >= 9 * cap) return s;
    if (n * best_cap > best_n * cap) {
      best = s;
      best_n = n;
      best_cap = cap;
    }
  }
  return best;
}

// D[64 x 32] (+)= A B, A and B in shared memory, both K-major with the
// 128-byte swizzle.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 192] (+)= A B, A a 64 x 16 bf16 fragment in registers, B in
// shared memory, MN-major with the 128-byte swizzle: three 64-column blocks
// LBO bytes apart.
__device__ __forceinline__ void mma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wide_sm90(const __grid_constant__ WideParams p) {
  constexpr int BQ = kWideBQ, BK = kWideBK, NS = kWideStages, D = kWideD;
  constexpr int NV = D / 192;  // the 192-column products of O
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  bf16* sq = carve.take<bf16>(BQ * D);
  bf16* sk = carve.take<bf16>(NS * BK * D);
  bf16* sv = carve.take<bf16>(NS * BK * D);
  const Ring<NS> ring(carve);

  const int qt = blockIdx.x % p.n_qtiles;
  const int z = blockIdx.x / p.n_qtiles;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int wg = threadIdx.x / kWarpgroup;
  // this split's chunks of the keys the tile walks
  const int kv_end = min(p.kv_valid, p.Skv);
  const int kv_hi = p.causal ? min(kv_end, q0 + BQ) : kv_end;
  const int chunks = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;
  const int c0 = z * chunks / p.splits;
  const int n_steps = (z + 1) * chunks / p.splits - c0;
  __syncthreads();  // the barriers are initialised

  auto issue = [&](int i) {
    const int s = i % NS;
    const int j0 = (c0 + i) * BK;
    bar_expect(&ring.full[s], 2 * BK * D * 2);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      tma_load_4d(sk + s * BK * D + nb * BK * 64, &p.k, &ring.full[s], nb * 64, j0, h, b);
      tma_load_4d(sv + s * BK * D + nb * BK * 64, &p.v, &ring.full[s], nb * 64, j0, h, b);
    }
  };
  if (threadIdx.x == 0) {
    bar_expect(ring.own, BQ * D * 2);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
      tma_load_4d(sq + nb * BQ * 64, &p.q, ring.own, nb * 64, q0, h, b);
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  }

  // the warpgroup's first row in the tile; this thread's two rows
  // (accumulator elements with bit 1 of i clear, set)
  const int qrow = 64 * wg;
  const int row0 = q0 + qrow + frag_row(0);
  const int rows[2] = {row0, row0 + 8};
  int lim[2];  // keys below lim[r] are visible
#pragma unroll
  for (int r = 0; r < 2; ++r) lim[r] = p.causal ? min(kv_end, rows[r] + 1) : kv_end;

  float o[NV][96];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < 96; ++i) o[n][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float s[BK / 2];
  uint32_t pf[BK / 16][4];

  bar_wait(ring.own, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % NS;
    const bf16* ks = sk + st * BK * D;
    const char* vs = reinterpret_cast<const char*>(sv + st * BK * D);
    ring.wait(i);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n32(s, desc_k(sq, BQ, qrow, kk), desc_k(ks, BK, 0, kk), kk > 0);
    mma_commit();
    if (i > 0) {  // the previous chunk's P V is done: its stage is free
      mma_wait<1>();
#pragma unroll
      for (int n = 0; n < NV; ++n) fence_regs(o[n]);
      ring.release(i - 1, n_steps, issue);
    }
    mma_wait<0>();
    fence_regs(s);

    const int j0 = (c0 + i) * BK;
    if (j0 + BK > min(lim[0], lim[1])) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        if (j0 + frag_col(e) >= lim[(e >> 1) & 1]) s[e] = -CUDART_INF_F;
    }

    // online softmax on the fragment, in log2 units of the scaled scores
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_next = fmaxf(m[r], quad_max(mx[r]) * p.scale_log2);
      m_use[r] = m_next == -CUDART_INF_F ? 0.f : m_next;
      alpha[r] = exp2f(m[r] - m_use[r]);  // 0 while the row has seen no key
      m[r] = m_next;
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = exp2f(fmaf(s[e], p.scale_log2, -m_use[r]));
      sum[r] += s[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 96; ++e) o[n][e] *= alpha[(e >> 1) & 1];
    to_a_frags(s, pf);

    // O[:, 192 n ...] += P V: V's 64-column blocks 3 n on, MN-major, a
    // 16-key step 2048 bytes on
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < NV; ++n)
        mma_rs_n192(o[n], pf[kk],
                    desc(vs + 3 * n * BK * 128 + kk * 2048, BK * 128, 1024), 1);
    mma_commit();
  }
  // every product is done on every path before the epilogue reads the sums
  mma_wait<0>();
#pragma unroll
  for (int n = 0; n < NV; ++n) fence_regs(o[n]);
  if (n_steps > 0) ring.release(n_steps - 1, n_steps, issue);

  // epilogue: O / l and LSE = m ln 2 + ln l (-inf for a row with no key),
  // as bf16 O, or as this split's fp32 partials
  float inv[2], row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    row_lse[r] = l[r] == 0.f ? -CUDART_INF_F : m[r] * kLn2 + logf(l[r]);
  }
  const bool lse_writer = threadIdx.x % 4 == 0;
  if (p.splits == 1) {
    bf16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 96; e += 2) {
        const int r = (e >> 1) & 1;
        if (rows[r] < p.Sq)
          *reinterpret_cast<uint32_t*>(out + rows[r] * p.o_ss + 192 * n + frag_col(e)) =
              pack_bf16(o[n][e] * inv[r], o[n][e + 1] * inv[r]);
      }
    if (p.lse != nullptr && lse_writer) {
      float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < p.Sq) lse[rows[r]] = row_lse[r];
    }
  } else {
    const long long slab = ((static_cast<long long>(z) * p.B + b) * p.H + h) * p.Sq;
    float* part = p.part + slab * D;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 96; e += 2) {
        const int r = (e >> 1) & 1;
        if (rows[r] < p.Sq)
          *reinterpret_cast<float2*>(part + static_cast<long long>(rows[r]) * D + 192 * n +
                                     frag_col(e)) =
              make_float2(o[n][e] * inv[r], o[n][e + 1] * inv[r]);
      }
    if (lse_writer) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < p.Sq) p.lse_part[slab + rows[r]] = row_lse[r];
    }
  }
}

// A merged row's four columns, stored as the output's type.
__device__ __forceinline__ void store4(bf16* dst, float4 a) {
  uint2 packed;
  packed.x = pack_bf16(a.x, a.y);
  packed.y = pack_bf16(a.z, a.w);
  *reinterpret_cast<uint2*>(dst) = packed;
}
__device__ __forceinline__ void store4(float* dst, float4 a) {
  *reinterpret_cast<float4*>(dst) = a;
}

// The merge of a split launch's partials: per row, with M the largest
// partial LSE, O = sum_z exp(lse_z - M) O_z / sum_z exp(lse_z - M) and LSE
// = M + ln of that sum, summed in split order; a row whose every partial
// is empty (-inf) outputs 0 and -inf. 96 threads a row, 4 columns each. T
// is the output's type: bf16 for the bf16 wide schedule, fp32 for the
// 3xTF32 one. Bound by bytes: it reads the partials once and writes O.
template <typename T>
__global__ void __launch_bounds__(kCombineRows * kWideD / 4)
    flash_fwd_combine(const float* __restrict__ part, const float* __restrict__ lse_part,
                      T* __restrict__ o, float* __restrict__ lse, int splits, int H, int Sq,
                      long long rows, long long o_sb, long long o_sh, long long o_ss) {
  const long long row = static_cast<long long>(blockIdx.x) * kCombineRows + threadIdx.x / 96;
  if (row >= rows) return;
  const int c = (threadIdx.x % 96) * 4;
  float mx = -CUDART_INF_F;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, __ldg(lse_part + z * rows + row));
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float tot = 0.f;
  if (mx != -CUDART_INF_F) {
    for (int z = 0; z < splits; ++z) {
      const float w = expf(__ldg(lse_part + z * rows + row) - mx);
      const float4 v = __ldg(reinterpret_cast<const float4*>(part + (z * rows + row) * kWideD + c));
      tot += w;
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
  }
  const float inv = tot == 0.f ? 0.f : 1.f / tot;
  const int s = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  store4(o + (bh / H) * o_sb + (bh % H) * o_sh + s * o_ss + c,
         make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  if (lse != nullptr && c == 0) lse[row] = tot == 0.f ? -CUDART_INF_F : mx + logf(tot);
}

}  // namespace sm90
}  // namespace fvt

// The flash attention forward's fp32 form at a head of 384 (K1 with fp32
// operands, the VAE's mid-block attention in a decode with
// vae_decode_precision="fp32") on Hopper: 3xTF32 wgmma products.
// flash_fwd.cu launches it for K1 with fp32 operands and D = 384. It
// computes what the Pallas _fwd_kernel (fastvideo_tpu/ops/flash_attention.py
// :93, call :222) computes on fp32 operands as JAX's VAE calls it
// (fastvideo_tpu/models/vaes/wan.py:296-308): one head of 384, q, k and v
// column views of one qkv tensor (a row stride of 1,152 values), no mask;
// fp32 scores, fp32 softmax statistics, P V with P unrounded. The kv_valid
// and causal masks of the bf16 wide form are kept; a row with no valid key
// outputs 0 and an LSE of -inf.
//
// wgmma has no fp32 operand, and one TF32 product leaves the fp32 result by
// about 1e-3 relative (chip_smoke.py prints it beside this kernel's). So
// each operand a is split into a TF32 head and tail, hi = tf32(a), lo =
// tf32(a - hi) (cvt.rna), and each product is hi hi + hi lo + lo hi on
// wgmma.m64nNk8.f32.tf32.tf32, for S = Q K^T and for O += P V alike. TF32
// wgmma takes K-major operands only, so V reaches the kernel as V^T: a
// pre-pass (flash_tf32_split) writes K's heads and tails [B, H, Skv_pad,
// 384] and V^T's [B, H, 384, Skv_pad], the keys of each group of 8 stored
// in the order 0 2 4 6 1 3 5 7. That order makes the S accumulator's
// fragment (columns 2t, 2t + 1 of each 8 in thread t of a quad) the TF32 A
// fragment of P V (columns t, t + 4) as it stands, so P never leaves
// registers. Q's fragments come from shared memory by ldmatrix (b16 pairs
// are the TF32 A fragment, as in conv3d_tf32_sm90.cuh) and are split in
// registers; P is split in registers.
//
// Registers and shared memory set the layout. O[64 x 384] in fp32 is 192
// registers a thread of one warpgroup, and Q's split fragments must stay
// live while their products run, so a block owns 64 query rows and its two
// warpgroups share them: warpgroup w computes S over D columns [192 w, 192
// w + 192) (24 k-steps), the two halves of S meet through shared memory,
// and warpgroup w keeps O's columns [192 w, 192 w + 192) (96 registers).
// Both then hold the same S (fp32 addition commutes), the same softmax
// statistics and the same P. Q (64 x 384 fp32) takes 96 KB, so each key
// chunk of 32 streams as four 48 KB tiles through a two-stage ring: K's
// heads (the lo hi and hi hi products), K's tails (hi lo), V^T's tails (P
// hi, V lo), V^T's heads (P lo and P hi), each copy overlapping the tile
// before it. The sums chain in the accumulators (the tensor cores' fp32
// sums lose about an ulp of the running sum a step; no drain fits beside
// O). Key splits (wide_splits at 64 rows a block) fill the card; a split
// launch writes fp32 partials that flash_fwd_combine<float> merges.
//
// What bounds it: 3 x 4 D FLOP a (query, key) pair on the tensor cores (3 x
// 5.98e10 at the first decode chunk, 0.363 ms at 494.7 TFLOP/s); fp32 FMAs
// at 67 TFLOP/s would take 0.893 ms. Each 64-row block streams every key's
// four fp32 tiles (38 MB a frame) from L2.
#pragma once

#include "flash_fwd_wide_sm90.cuh"

namespace fvt {
namespace sm90 {

constexpr int kTf32BQ = 64;  // query rows a block, shared by both warpgroups
constexpr int kTf32BK = 32;  // keys a chunk
constexpr int kTf32Stages = 2;
constexpr int kTf32Threads = 2 * kWarpgroup;
constexpr int kTf32Half = kWideD / 2;  // a warpgroup's D columns (S) and O columns
constexpr int kTf32Group = 4;          // Q's k-steps a fragment buffer
constexpr int kTf32XsStride = 40;      // floats a row of the S exchange
constexpr int kSplitTile = 32;         // keys and columns a pre-pass block
// one of a chunk's four tiles: [32 keys x 384] or [384 x 32 keys], fp32
constexpr size_t kTf32Tile = kTf32BK * kWideD * 4;

struct Tf32Params {
  CUtensorMap q;             // fp32 [B, Sq, H, 384] view, box {32, 64}
  CUtensorMap k_hi, k_lo;    // fp32 [B, H, Skv_pad, 384], box {32, 32}
  CUtensorMap vt_hi, vt_lo;  // fp32 [B, H, 384, Skv_pad], box {32, 192}
  float* o;                  // one split: [B, Sq, H, 384] (strided), and
  float* lse;                // [B, H, Sq] or null
  long long o_sb, o_sh, o_ss;
  float* part;      // splits > 1: O / l [splits, B, H, Sq, 384] and
  float* lse_part;  // the LSE [splits, B, H, Sq]
  int B, H, Sq, Skv, n_qtiles, splits;
  float scale_log2;  // scale * log2(e)
  int causal, kv_valid;
};

__host__ __device__ constexpr size_t wide_tf32_smem_bytes() {
  return 1024 + round_1k(kTf32BQ * kWideD * 4) + kTf32Stages * kTf32Tile +
         round_1k(2 * kTf32BQ * kTf32XsStride * 4) + Ring<kTf32Stages>::bytes();
}

// D[64 x 32] (+)= A B in TF32: A a 64 x 8 fragment in registers (rows g, g
// + 8 and columns t, t + 4 of each warp's 16 x 8 step), B in shared memory,
// K-major with the 128-byte swizzle.
__device__ __forceinline__ void mma_tf32_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 192] (+)= A B in TF32, as mma_tf32_n32.
__device__ __forceinline__ void mma_tf32_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
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
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
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

// One buffer of Q's A fragments: kTf32Group k-steps from box `box` (32 of
// Q's columns), split into heads and (with_lo) tails.
__device__ __forceinline__ void q_frags(uint32_t (&hi)[kTf32Group][4],
                                        uint32_t (&lo)[kTf32Group][4], uint32_t q_base,
                                        int box, const uint32_t (&a_off)[4], bool with_lo) {
#pragma unroll
  for (int g = 0; g < kTf32Group; ++g) {
    ldsm_x4(hi[g], q_base + box * (kTf32BQ * 128) + a_off[g]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = __uint_as_float(hi[g][r]);
      const uint32_t h = tf32_rna(a);
      if (with_lo) lo[g][r] = tf32_rna(a - __uint_as_float(h));
      hi[g][r] = h;
    }
  }
}

// One buffer's products of S: batch bb of the chunk's 12 (the first 6
// against K's heads, lo hi then hi hi, the rest against K's tails, hi lo),
// one commit group. The chunk's first product overwrites S.
__device__ __forceinline__ void s_products(float (&s)[16], const uint32_t (&hi)[kTf32Group][4],
                                           const uint32_t (&lo)[kTf32Group][4], int bb,
                                           const unsigned char* kt, int box0) {
  constexpr int NB = kTf32Half / 8 / kTf32Group;
  const unsigned char* base = kt + (box0 + bb % NB) * (kTf32BK * 128);
  mma_fence();
#pragma unroll
  for (int g = 0; g < kTf32Group; ++g) {
    const uint64_t db = desc(base + g * 32, 16, 1024);
    if (bb < NB) {
      mma_tf32_n32(s, lo[g], db, bb + g > 0);
      mma_tf32_n32(s, hi[g], db, 1);
    } else {
      mma_tf32_n32(s, hi[g], db, 1);
    }
  }
  mma_commit();
}

__device__ __forceinline__ void sync_block_pair() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTf32Threads) : "memory");
}

__global__ void __launch_bounds__(kTf32Threads, 1)
    flash_fwd_wide_tf32_sm90(const __grid_constant__ Tf32Params p) {
  constexpr int BQ = kTf32BQ, BK = kTf32BK, NS = kTf32Stages, D = kWideD;
  constexpr int NB = kTf32Half / 8 / kTf32Group;  // fragment batches a pass
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  float* sq = carve.take<float>(BQ * D);
  unsigned char* tiles = carve.take<unsigned char>(NS * kTf32Tile);
  float* xs = carve.take<float>(2 * BQ * kTf32XsStride);
  const Ring<NS> ring(carve);

  const int qt = blockIdx.x % p.n_qtiles;
  const int z = blockIdx.x / p.n_qtiles;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int wg = threadIdx.x / kWarpgroup;
  // this split's chunks of the keys the tile walks; four tiles (units) a
  // chunk
  const int kv_end = min(p.kv_valid, p.Skv);
  const int kv_hi = p.causal ? min(kv_end, q0 + BQ) : kv_end;
  const int chunks = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;
  const int c0 = z * chunks / p.splits;
  const int n_steps = (z + 1) * chunks / p.splits - c0;
  const int n_units = 4 * n_steps;
  __syncthreads();  // the barriers are initialised

  // unit u: chunk u / 4's K heads, K tails, V^T tails, V^T heads
  auto issue = [&](int u) {
    unsigned char* dst = tiles + (u % NS) * kTf32Tile;
    uint64_t* bar = &ring.full[u % NS];
    const int j0 = (c0 + u / 4) * BK;
    const int kind = u % 4;
    bar_expect(bar, kTf32Tile);
    if (kind < 2) {
      const CUtensorMap* m = kind == 0 ? &p.k_hi : &p.k_lo;
#pragma unroll
      for (int nb = 0; nb < D / 32; ++nb) tma_load_4d(dst + nb * BK * 128, m, bar, nb * 32, j0, h, b);
    } else {
      const CUtensorMap* m = kind == 2 ? &p.vt_lo : &p.vt_hi;
#pragma unroll
      for (int n = 0; n < 2; ++n)
        tma_load_4d(dst + n * kTf32Half * 128, m, bar, j0, n * kTf32Half, h, b);
    }
  };
  if (threadIdx.x == 0) {
    bar_expect(ring.own, BQ * D * 4);
#pragma unroll
    for (int nb = 0; nb < D / 32; ++nb) tma_load_4d(sq + nb * BQ * 32, &p.q, ring.own, nb * 32, q0, h, b);
    for (int u = 0; u < min(NS, n_units); ++u) issue(u);
  }

  // this lane's ldmatrix row of Q and its 16-byte chunk in a box, by the
  // k-step's place among the box's four (swizzle: chunk c of row r at c ^ (r
  // % 8))
  const int lane = threadIdx.x % 32;
  const int lrow = 16 * ((threadIdx.x % kWarpgroup) / 32) + 8 * ((lane / 8) & 1) + lane % 8;
  uint32_t a_off[4];
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    const int chunk = 2 * kq + lane / 16;
    a_off[kq] = lrow * 128 + ((chunk ^ (lrow % 8)) << 4);
  }
  const uint32_t q_base = smem_u32(sq);
  const int box0 = wg * (kTf32Half / 32);  // this warpgroup's first Q / K box

  // this thread's two rows (accumulator elements with bit 1 of i clear, set)
  const int row0 = q0 + frag_row(0);
  const int rows[2] = {row0, row0 + 8};
  int lim[2];  // keys below lim[r] are visible
#pragma unroll
  for (int r = 0; r < 2; ++r) lim[r] = p.causal ? min(kv_end, rows[r] + 1) : kv_end;

  float o[96];  // O[:, 192 wg .. 192 wg + 191]
#pragma unroll
  for (int i = 0; i < 96; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float s[BK / 2];
  uint32_t fh0[kTf32Group][4], fl0[kTf32Group][4], fh1[kTf32Group][4], fl1[kTf32Group][4];
  float* xs_mine = xs + wg * BQ * kTf32XsStride;
  const float* xs_other = xs + (1 - wg) * BQ * kTf32XsStride;

  bar_wait(ring.own, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int u = 4 * i;
    const unsigned char* k_hi = tiles + (u % NS) * kTf32Tile;
    const unsigned char* k_lo = tiles + ((u + 1) % NS) * kTf32Tile;

    // this warpgroup's half of S: two fragment buffers alternate, so a
    // batch's fragments load while the batch before it multiplies
    ring.wait(u);
    q_frags(fh0, fl0, q_base, box0, a_off, true);
#pragma unroll
    for (int bb = 0; bb < 2 * NB; ++bb) {
      if (bb == NB) ring.wait(u + 1);
      if (bb % 2 == 0)
        s_products(s, fh0, fl0, bb, bb < NB ? k_hi : k_lo, box0);
      else
        s_products(s, fh1, fl1, bb, bb < NB ? k_hi : k_lo, box0);
      if (bb + 1 < 2 * NB) {
        mma_wait<1>();  // batch bb - 1 is done: its buffer is free
        if (bb == NB) ring.release(u, n_units, issue);  // K's heads are read
        const int nb = bb + 1;
        if (nb % 2 == 0)
          q_frags(fh0, fl0, q_base, box0 + nb % NB, a_off, nb < NB);
        else
          q_frags(fh1, fl1, q_base, box0 + nb % NB, a_off, nb < NB);
      }
    }
    mma_wait<0>();
    fence_regs(s);
    ring.release(u + 1, n_units, issue);

    // S = the two halves' sum, the same in both warpgroups
#pragma unroll
    for (int e = 0; e < BK / 2; e += 2)
      *reinterpret_cast<float2*>(xs_mine + frag_row(e) * kTf32XsStride + frag_col(e)) =
          make_float2(s[e], s[e + 1]);
    sync_block_pair();
#pragma unroll
    for (int e = 0; e < BK / 2; e += 2) {
      const float2 v =
          *reinterpret_cast<const float2*>(xs_other + frag_row(e) * kTf32XsStride + frag_col(e));
      s[e] += v.x;
      s[e + 1] += v.y;
    }
    sync_block_pair();  // both have read before either writes again

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
    for (int e = 0; e < 96; ++e) o[e] *= alpha[(e >> 1) & 1];

    // P's A fragments: k-step kk holds keys 8 kk + 2t (column t) and 8 kk +
    // 2t + 1 (column t + 4), V^T's stored order
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[4 * kk + ((r & 1) << 1) + (r >> 1)];
        ph[kk][r] = tf32_rna(a);
        pl[kk][r] = tf32_rna(a - __uint_as_float(ph[kk][r]));
      }

    // O[:, 192 wg ...] += P V: V^T's rows 192 wg on, a k-step 32 bytes on
    const unsigned char* v_lo = tiles + ((u + 2) % NS) * kTf32Tile + wg * kTf32Half * 128;
    const unsigned char* v_hi = tiles + ((u + 3) % NS) * kTf32Tile + wg * kTf32Half * 128;
    ring.wait(u + 2);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) mma_tf32_n192(o, ph[kk], desc(v_lo + kk * 32, 16, 1024), 1);
    mma_commit();
    ring.wait(u + 3);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t db = desc(v_hi + kk * 32, 16, 1024);
      mma_tf32_n192(o, pl[kk], db, 1);
      mma_tf32_n192(o, ph[kk], db, 1);
    }
    mma_commit();
    mma_wait<1>();
    ring.release(u + 2, n_units, issue);
    mma_wait<0>();
    fence_regs(o);
    ring.release(u + 3, n_units, issue);
  }

  // epilogue: O / l and LSE = m ln 2 + ln l (-inf for a row with no key),
  // as fp32 O, or as this split's partials
  float inv[2], row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    row_lse[r] = l[r] == 0.f ? -CUDART_INF_F : m[r] * kLn2 + logf(l[r]);
  }
  const bool lse_writer = wg == 0 && threadIdx.x % 4 == 0;
  const int col0 = kTf32Half * wg;
  float* out;
  long long row_stride;
  float* lse;
  if (p.splits == 1) {
    out = p.o + b * p.o_sb + h * p.o_sh + col0;
    row_stride = p.o_ss;
    lse = p.lse == nullptr ? nullptr : p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
  } else {
    const long long slab = ((static_cast<long long>(z) * p.B + b) * p.H + h) * p.Sq;
    out = p.part + slab * D + col0;
    row_stride = D;
    lse = p.lse_part + slab;
  }
#pragma unroll
  for (int e = 0; e < 96; e += 2) {
    const int r = (e >> 1) & 1;
    if (rows[r] < p.Sq)
      *reinterpret_cast<float2*>(out + rows[r] * row_stride + frag_col(e)) =
          make_float2(o[e] * inv[r], o[e + 1] * inv[r]);
  }
  if (lse != nullptr && lse_writer) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < p.Sq) lse[rows[r]] = row_lse[r];
  }
}

// The pre-pass: K's TF32 heads and tails [B, H, Skv_pad, 384] and V^T's
// [B, H, 384, Skv_pad] (keys of each group of 8 in the order 0 2 4 6 1 3 5
// 7), zero past Skv, from the strided [B, Skv, H, 384] views. A block turns
// a 32 x 32 tile (keys x columns), V's through shared memory. Bound by
// bytes: k and v read once, four fp32 arrays written once.
__global__ void __launch_bounds__(256)
    flash_tf32_split(const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ k_hi, float* __restrict__ k_lo,
                     float* __restrict__ vt_hi, float* __restrict__ vt_lo, int H, int Skv,
                     int Skv_pad, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss) {
  constexpr int T = kSplitTile;
  __shared__ float tile[T][T + 1];
  const int j0 = blockIdx.x * T, d0 = blockIdx.y * T;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int x = threadIdx.x % T;
  for (int r = threadIdx.x / T; r < T; r += 256 / T) {
    const int key = j0 + r;
    float kv = 0.f, vv = 0.f;
    if (key < Skv) {
      kv = __ldg(k + b * k_sb + h * k_sh + key * k_ss + d0 + x);
      vv = __ldg(v + b * v_sb + h * v_sh + key * v_ss + d0 + x);
    }
    const long long at = (static_cast<long long>(bh) * Skv_pad + key) * kWideD + d0 + x;
    const uint32_t hb = tf32_rna(kv);
    k_hi[at] = __uint_as_float(hb);
    k_lo[at] = __uint_as_float(tf32_rna(kv - __uint_as_float(hb)));
    tile[r][x] = vv;
  }
  __syncthreads();
  // position x of a group of 8 holds key 2x (x < 4) or 2x - 7
  const int src = (x & ~7) | ((x & 7) < 4 ? 2 * (x & 7) : 2 * (x & 7) - 7);
  for (int r = threadIdx.x / T; r < T; r += 256 / T) {
    const float vv = tile[src][r];
    const long long at = (static_cast<long long>(bh) * kWideD + d0 + r) * Skv_pad + j0 + x;
    const uint32_t hb = tf32_rna(vv);
    vt_hi[at] = __uint_as_float(hb);
    vt_lo[at] = __uint_as_float(tf32_rna(vv - __uint_as_float(hb)));
  }
}

// -- host ----------------------------------------------------------------------

// A map over an fp32 [B, S, H, D] view (element strides sb, sh, ss; unit
// stride along D) whose box is {32, rows}: 32 columns (128 bytes) of `rows`
// rows of one (batch, head), 128-byte swizzled. Rows past S read as zero.
inline bool map_bshd_f32(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                         long long sb, long long sh, long long ss, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const long long packed[3] = {D, static_cast<long long>(D) * S,
                               static_cast<long long>(D) * S * H};
  const long long given[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(4 * (dims[i + 1] == 1 ? packed[i] : given[i]));
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fvt

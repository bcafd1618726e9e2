// The flash attention forward's Hopper schedule (K1, K5, K1 struct at bf16
// with a head of 64 or 128): flash_fwd.cu launches it, and keeps its first
// schedule (attn_tile.cuh) for fp32 and for other heads (the VAE's 384, the
// tiny models' 16 and 32). With flash_fwd.cu it replaces the Pallas
// _fwd_kernel (fastvideo_tpu/ops/flash_attention.py:93, call :222) in its
// plain, kv-mask and structural-mask uses. At every main-path shape the
// work is bound by the tensor cores (4 D FLOP a visible (query, key) pair
// against a few bytes of unique input a pair), so the design keeps them
// fed: no score, probability or output tile goes through shared memory,
// and copies run behind the products.
//
// A block owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows each, 256 threads, one block an SM. Thread 0 keeps
// the copies in flight: Q once, then the key chunks (128 keys of K and of
// V a chunk) through a ring of two stages, each a TMA copy that completes
// to the stage's "full" mbarrier; every warp arrives on the stage's
// "empty" mbarrier when its products have read it, and thread 0 refills
// the stage with the chunk two ahead. So the next chunk's copy overlaps
// this chunk's products, and the two warpgroups overlap each other's
// softmax with their products.
//
// Per chunk and warpgroup: S = Q K^T is one wgmma.m64n128k16 chain with
// both operands in shared memory and fp32 sums in registers; the online
// softmax runs on that register fragment (a row's max over the 4 threads
// that hold it, 2 shuffles; its sum stays a per-thread partial until the
// end); P is rounded to bf16 in registers (the Pallas kernel's
// p.astype(v.dtype)) and is the A operand of O += P V (wgmma with A in
// registers, V MN-major in shared memory); O stays in registers across all
// chunks and is rescaled there. The exponent is exp2 with scale * log2(e)
// folded in. The next chunk's S product is issued before this chunk's
// P V product is waited for, so the tensor cores see no gap between them.
//
// Masks are a compile-time mode, so K1, K5 and K1 struct stay three
// kernels: kPlain, kv_valid and causal (the tile walks keys up to its last
// row); kKvMask (K5), one byte a key: the block classifies each chunk as
// empty (skipped, for every warp alike), full or partial; kStruct (K1
// struct), the ranges of struct_mask.cuh: the tile walks the union of its
// rows' key ranges. In every mode a thread checks single elements only in
// a chunk that is partial for one of its two rows. Masked scores are -inf:
// a row with no valid key outputs 0 and an LSE of -inf. The query tiles
// run last to first (grid z), since under the causal and structural masks
// the late tiles see the most keys.
#pragma once

#include "sm90.cuh"
#include "struct_mask.cuh"

namespace fvt {

// The mask mode of a flash forward instance: K1 (kPlain), K5 (kKvMask), K1
// struct (kStruct).
enum MaskMode : int { kPlain = 0, kKvMask = 1, kStruct = 2 };

namespace sm90 {

constexpr int kFwdBQ = 128;  // query rows a block: 2 warpgroups of 64
constexpr int kFwdBK = 128;  // keys a chunk
constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 2 * kWarpgroup;
constexpr int kFullChunk = 1 << 30;  // K5's chunk list: the chunk is all visible

struct FwdParams {
  CUtensorMap q, k, v;  // boxes {64, kFwdBQ}, {64, kFwdBK}, {64, kFwdBK}
  bf16* o;
  float* lse;  // [B, H, Sq] or null
  long long o_sb, o_sh, o_ss;
  const unsigned char* kv_mask;  // K5: [Skv]
  int H, Sq, Skv, n_qtiles;
  float scale_log2;  // scale * log2(e)
  int causal, kv_valid, chunk_tokens, tf_clean_len;
};

// Dynamic shared memory of one block, in the order the kernel carves it.
template <int D, int kMode>
__host__ __device__ constexpr size_t fwd_smem_bytes(int Skv) {
  const int chunks = (Skv + kFwdBK - 1) / kFwdBK;
  return 1024 + round_1k(kFwdBQ * D * 2) + 2 * round_1k(kFwdStages * kFwdBK * D * 2) +
         Ring<kFwdStages>::bytes() + (kMode == kStruct ? round_1k(3 * kFwdBQ * 4) : 0) +
         (kMode == kKvMask ? round_1k((chunks + 1) * 4) + round_1k(chunks) : 0);
}

template <int D, int kMode>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_sm90(const __grid_constant__ FwdParams p) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK, NS = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  bf16* sq = carve.take<bf16>(BQ * D);
  bf16* sk = carve.take<bf16>(NS * BK * D);
  bf16* sv = carve.take<bf16>(NS * BK * D);
  const Ring<NS> ring(carve);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (p.n_qtiles - 1 - blockIdx.z) * BQ;
  const int wg = threadIdx.x / kWarpgroup;
  const int kv_end = min(p.kv_valid, p.Skv);

  // The chunks this tile visits: a walk over key ranges, or (K5) a list.
  Walk walk;
  int n_steps = 0;
  int* list = nullptr;
  if constexpr (kMode == kStruct) {
    int* sa = carve.take<int>(3 * BQ);
    int* sb = sa + BQ;
    int* sc = sa + 2 * BQ;
    for (int r = threadIdx.x; r < BQ; r += kFwdThreads) {
      int a = 0, b0 = 0, c = 0;
      if (q0 + r < p.Sq)
        struct_row_keys(q0 + r, p.chunk_tokens, p.tf_clean_len, kv_end, a, b0, c);
      sa[r] = a;
      sb[r] = b0;
      sc[r] = c;
    }
    __syncthreads();
    const Ranges keys = struct_tile_keys(sa, sb, sc, min(BQ, p.Sq - q0));
    for (int i = 0; i < keys.n; ++i) walk.add(keys.lo[i], keys.hi[i], BK);
    n_steps = walk.steps;
  } else if constexpr (kMode == kKvMask) {
    const int chunks = (p.Skv + BK - 1) / BK;
    list = carve.take<int>(chunks + 1);
    unsigned char* cls = carve.take<unsigned char>(chunks);
    for (int c = threadIdx.x; c < chunks; c += kFwdThreads) {
      const int j_end = min(c * BK + BK, p.Skv);
      int any = 0, all = 1;
#pragma unroll 16
      for (int j = c * BK; j < j_end; ++j) {
        const int m = p.kv_mask[j] != 0;
        any |= m;
        all &= m;
      }
      cls[c] = any ? (all && j_end == c * BK + BK ? 2 : 1) : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int c = 0; c < chunks; ++c)
        if (cls[c]) list[n++] = c | (cls[c] == 2 ? kFullChunk : 0);
      list[chunks] = n;
    }
    __syncthreads();
    n_steps = list[chunks];
  } else {
    walk.add(0, p.causal ? min(kv_end, q0 + BQ) : kv_end, BK);
    n_steps = walk.steps;
  }
  __syncthreads();  // the barriers are initialised

  // chunk i: keys [j0, j0 + BK), of which those below `end` are in range
  auto chunk = [&](int i, int& j0, int& end, bool& all_visible) {
    if constexpr (kMode == kKvMask) {
      const int e = list[i];
      j0 = (e & (kFullChunk - 1)) * BK;
      end = p.Skv;
      all_visible = (e & kFullChunk) != 0;
    } else {
      walk.at(i, BK, j0, end);
      all_visible = false;
    }
  };
  auto issue = [&](int i) {
    int j0, end;
    bool all_visible;
    chunk(i, j0, end, all_visible);
    const int s = i % NS;
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

  // this thread's two rows (accumulator elements with bit 1 of i clear, set)
  const int row0 = q0 + 64 * wg + frag_row(0);
  const int rows[2] = {row0, row0 + 8};
  // kPlain: keys below lim[r] are visible; kStruct: [0, a) and [bk, ck)
  int lim[2], a[2], bk[2], ck[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lim[r] = p.causal ? min(kv_end, rows[r] + 1) : kv_end;
    a[r] = bk[r] = ck[r] = 0;
    if constexpr (kMode == kStruct)
      if (rows[r] < p.Sq)
        struct_row_keys(rows[r], p.chunk_tokens, p.tf_clean_len, kv_end, a[r], bk[r], ck[r]);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float s[BK / 2];
  uint32_t pf[BK / 16][4];

  bar_wait(ring.own, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % NS;
    const bf16* ks = sk + st * BK * D;
    const bf16* vs = sv + st * BK * D;
    ring.wait(i);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BK>(s, desc_k(sq, BQ, 64 * wg, kk), desc_k(ks, BK, 0, kk), kk > 0);
    mma_commit();
    if (i > 0) {  // the previous chunk's P V is done: its stage is free
      mma_wait<1>();
      fence_regs(o);
      ring.release(i - 1, n_steps, issue);
    }
    mma_wait<0>();
    fence_regs(s);

    int j0, end;
    bool all_visible;
    chunk(i, j0, end, all_visible);
    bool partial = !all_visible;
    if constexpr (kMode == kPlain) {
      partial = j0 + BK > min(lim[0], lim[1]);
    } else if constexpr (kMode == kStruct) {
      partial = false;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        partial |= !(j0 + BK <= end &&
                     (j0 + BK <= a[r] || (j0 >= bk[r] && j0 + BK <= ck[r])));
    }
    if (partial) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int r = (e >> 1) & 1;
        const int col = j0 + frag_col(e);
        bool ok;
        if constexpr (kMode == kPlain)
          ok = col < lim[r];
        else if constexpr (kMode == kStruct)
          ok = col < end && (col < a[r] || (col >= bk[r] && col < ck[r]));
        else
          ok = col < p.Skv && __ldg(p.kv_mask + col) != 0;
        if (!ok) s[e] = -CUDART_INF_F;
      }
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
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    to_a_frags(s, pf);

    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(o, pf[kk], desc_mn(vs, BK, kk), 1);
    mma_commit();
  }
  if (n_steps > 0) {
    mma_wait<0>();
    fence_regs(o);
    ring.release(n_steps - 1, n_steps, issue);
  }

  // epilogue: O / l in bf16, LSE = m ln 2 + ln l
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
  bf16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = (e >> 1) & 1;
    if (rows[r] < p.Sq)
      *reinterpret_cast<uint32_t*>(out + rows[r] * p.o_ss + frag_col(e)) =
          pack_bf16(o[e] * inv[r], o[e + 1] * inv[r]);
  }
  if (p.lse != nullptr && threadIdx.x % 4 == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < p.Sq) lse[rows[r]] = l[r] == 0.f ? -CUDART_INF_F : m[r] * kLn2 + logf(l[r]);
  }
}

}  // namespace sm90
}  // namespace fvt

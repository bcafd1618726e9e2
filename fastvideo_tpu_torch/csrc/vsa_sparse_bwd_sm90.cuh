// The block-sparse backward's Hopper schedule (K7 bwd at bf16 with a head
// of 64 or 128): vsa_sparse_bwd.cu launches it, and keeps its first
// schedule (attn_bwd_tile.cuh) for other heads. It is K6's Hopper backward
// (flash_bwd_sm90.cuh: the same arithmetic, rounding points, ring and
// register fragments) on a list walk (sm90.cuh: TileList, Cursor) in place
// of a walk over key ranges. Bound by the tensor cores: five products of
// 2 D FLOP a (query row, valid key) pair of the sparsity.
//
// q/k/v/dO are tile-major [B, H, nT * E, D] views, read through 5-D tensor
// maps over [B, H, nT, E, D] (map_tiles) in units of 64 rows: a unit that
// runs past a tile's E rows (E = 280 at 480p: four units and one of 24)
// reads zeros there, not the next tile's rows. Two kernels, as the Pallas
// backward has; deterministic, no atomics. A block is two consumer
// warpgroups that own two consecutive 64-row units of one tile (so a tile
// of E rows is ceil(E / 128) blocks); a warpgroup whose unit starts at or
// past its last live row waits on and releases the ring's stages without
// products.
//  - dQ: a block owns 128 rows of query tile qt and walks its top-k key
//    tiles (indices[b, h, qt], -1 slots skipped), unit by unit; per unit
//    S = Q K^T and dP = dO V^T, p and dS on the register fragments, then
//    dQ += dS K (dS the register A operand, K MN-major); the next unit's S
//    and dP are issued before dS K is waited for.
//  - dK/dV: a block owns 128 keys of key tile kt and walks the compacted
//    transpose of the sparsity: the ascending list of query tiles that
//    selected kt (built in the caller), each in units of 64 query rows,
//    with their LSE and delta. S^T = K Q^T and dP^T = V dO^T put p^T and
//    dS^T in the A operand's layout for dV += p^T dO and dK += dS^T Q. The
//    grid runs the key tiles with the longest lists first (`order`, an
//    argsort of the list lengths in the caller).
// Semantics of the first schedule (vsa_sparse_bwd.cu): a probability is
// live only below the key tile's valid count and where the row's LSE is
// above MASK_VALUE / 2, selected as 0 before its exponent is used, so a row
// with no valid key contributes exactly 0; padded query rows below E are
// computed like any row; rows past E (the zero fill of the last unit) are
// masked and never stored. p rounds to bf16 before p^T dO, dS before dS K
// and dS^T Q. A unit is copied whole, so the padded key slots of a tile
// (past its valid count) are read: they must hold finite values, as the
// tiling's zero fill leaves them (a masked p of 0 times a NaN is NaN).
#pragma once

#include "flash_bwd_sm90.cuh"

namespace fvt {
namespace sm90 {

// a row whose LSE is at or below this saw no valid key (vsa.py:747)
constexpr float kSparseMaskHalf = -0.35f * 3.4028234663852886e38f;

struct SparseBwdParams {
  CUtensorMap q, k, v, dout;  // map_tiles, box {64, kUnit}
  CUtensorMap lse, delta;     // dK/dV: [B * H * S] fp32, box {kStatBox}
  const float* lse_p;         // dQ: [B, H, S]
  const float* delta_p;
  const int* list;    // dQ: indices [B, H, nT, slots]; dK/dV: [B, H, nT, nT]
  const int* counts;  // dK/dV: [B, H, nT] list lengths; dQ: null (slots)
  const int* sizes;   // [nT] valid rows of each tile
  const int* order;   // dK/dV: [B * H * nT] (batch, head, tile) in launch order
  bf16* g0;           // dq, or dk
  bf16* g1;           // dv
  long long g0_sb, g0_sh, g0_ss, g1_sb, g1_sh, g1_ss;
  int H, nT, E, slots, n_sub;
  float scale, scale_log2;
};

template <int D>
__host__ __device__ constexpr size_t sparse_dq_smem_bytes(int slots) {
  return 1024 + 2 * round_1k(kBwdOwn * D * 2) + 2 * round_1k(kBwdStages * kBwdStep * D * 2) +
         Ring<kBwdStages>::bytes() + TileList::bytes(slots, false);
}

template <int D>
__host__ __device__ constexpr size_t sparse_dkv_smem_bytes(int n_tiles) {
  return 1024 + 2 * round_1k(kBwdOwn * D * 2) + 2 * round_1k(kBwdStages * kBwdStep * D * 2) +
         2 * round_1k(kBwdStages * kStatStride * 4) + Ring<kBwdStages>::bytes() +
         TileList::bytes(n_tiles, false);
}

// The warpgroup index, known to the compiler to be the same in a warp.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWarpgroup, 0);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    vsa_sparse_bwd_dq_sm90(const __grid_constant__ SparseBwdParams p) {
  constexpr int BR = kBwdOwn, BC = kBwdStep, NS = kBwdStages;
  static_assert(BC == kUnit, "a streamed chunk is one unit of the list walk");
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  bf16* sq = carve.take<bf16>(BR * D);
  bf16* sdo = carve.take<bf16>(BR * D);
  bf16* sk = carve.take<bf16>(NS * BC * D);
  bf16* sv = carve.take<bf16>(NS * BC * D);
  const Ring<NS> ring(carve);
  TileList list(carve, p.slots, false);

  const int flat = blockIdx.x / p.n_sub;  // (batch, head, query tile)
  const int sub = blockIdx.x % p.n_sub;
  const int qt = flat % p.nT;
  const int h = (flat / p.nT) % p.H;
  const int b = flat / (p.nT * p.H);
  const int wg = warpgroup();
  const int r0 = sub * BR;  // the block's first row in the tile
  const int live_units = min(2, (p.E - r0 + BC - 1) / BC);

  list.build(p.list + static_cast<long long>(flat) * p.slots, nullptr, p.slots, p.sizes, p.E);
  const int n_steps = *list.total;

  Cursor fill;  // thread 0's: the unit it issues next
  fill.start(list);
  auto issue = [&](int i) {
    const int s = i % NS;
    const int kt = fill.tile(list), c0 = fill.row0();
    bar_expect(&ring.full[s], 2 * BC * D * 2);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      tma_load_5d(sk + s * BC * D + nb * BC * 64, &p.k, &ring.full[s], nb * 64, c0, kt, h, b);
      tma_load_5d(sv + s * BC * D + nb * BC * 64, &p.v, &ring.full[s], nb * 64, c0, kt, h, b);
    }
    fill.next(list);
  };
  if (threadIdx.x == 0) {
    bar_expect(ring.own, live_units * 2 * BC * D * 2);
    for (int u = 0; u < live_units; ++u)
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb) {
        const int c0 = r0 + u * BC;
        tma_load_5d(sq + u * BC * D + nb * BC * 64, &p.q, ring.own, nb * 64, c0, qt, h, b);
        tma_load_5d(sdo + u * BC * D + nb * BC * 64, &p.dout, ring.own, nb * 64, c0, qt, h, b);
      }
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  }

  if (wg >= live_units) {  // rows past E: release the stages, nothing else
    for (int i = 0; i < n_steps; ++i) {
      ring.wait(i);
      ring.release(i, n_steps, issue);
    }
    return;
  }

  // this thread's two rows of the tile, their LSE (log2 units) and delta;
  // a row past E, or one that saw no valid key, has no live probability
  const long long row_base =
      (static_cast<long long>(b) * p.H + h) * p.nT * p.E + static_cast<long long>(qt) * p.E;
  const int row0 = r0 + 64 * wg + frag_row(0);
  const int rows[2] = {row0, row0 + 8};
  float lse2[2], dlt[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < p.E;
    const float l = in ? p.lse_p[row_base + rows[r]] : 0.f;
    row_ok[r] = in && l > kSparseMaskHalf;
    lse2[r] = row_ok[r] ? l * kLog2e : 0.f;
    dlt[r] = in ? p.delta_p[row_base + rows[r]] : 0.f;
  }
  const bf16* sq_w = sq + wg * BC * D;
  const bf16* sdo_w = sdo + wg * BC * D;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[BC / 2], dp[BC / 2];
  uint32_t dsf[BC / 16][4];
  Cursor at;  // the unit this thread consumes
  at.start(list);

  bar_wait(ring.own, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % NS;
    const bf16* ks = sk + st * BC * D;
    const bf16* vs = sv + st * BC * D;
    ring.wait(i);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BC>(s, desc_k(sq_w, BC, 0, kk), desc_k(ks, BC, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BC>(dp, desc_k(sdo_w, BC, 0, kk), desc_k(vs, BC, 0, kk), kk > 0);
    mma_commit();
    if (i > 0) {  // the previous unit's dS K is done: its stage is free
      mma_wait<1>();
      fence_regs(dq);
      ring.release(i - 1, n_steps, issue);
    }
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int nk = at.rows(list);  // the unit's valid keys
    at.next(list);
#pragma unroll
    for (int e = 0; e < BC / 2; ++e) {
      const int r = (e >> 1) & 1;
      const bool live = row_ok[r] & (frag_col(e) < nk);
      const float pr = live ? exp2f(fmaf(s[e], p.scale_log2, -lse2[r])) : 0.f;
      s[e] = pr * (dp[e] - dlt[r]) * p.scale;
    }
    to_a_frags(s, dsf);

    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) mma_rs<D>(dq, dsf[kk], desc_mn(ks, BC, kk), 1);
    mma_commit();
  }
  if (n_steps > 0) {
    mma_wait<0>();
    fence_regs(dq);
    ring.release(n_steps - 1, n_steps, issue);
  }

  bf16* out = p.g0 + b * p.g0_sb + h * p.g0_sh + static_cast<long long>(qt) * p.E * p.g0_ss;
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = (e >> 1) & 1;
    if (rows[r] < p.E)
      *reinterpret_cast<uint32_t*>(out + rows[r] * p.g0_ss + frag_col(e)) =
          pack_bf16(dq[e], dq[e + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    vsa_sparse_bwd_dkv_sm90(const __grid_constant__ SparseBwdParams p) {
  constexpr int BR = kBwdOwn, BC = kBwdStep, NS = kBwdStages;
  static_assert(BC == kUnit, "a streamed chunk is one unit of the list walk");
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  bf16* sk = carve.take<bf16>(BR * D);
  bf16* sv = carve.take<bf16>(BR * D);
  bf16* sq = carve.take<bf16>(NS * BC * D);
  bf16* sdo = carve.take<bf16>(NS * BC * D);
  float* slse = carve.take<float>(NS * kStatStride);
  float* sdelta = carve.take<float>(NS * kStatStride);
  const Ring<NS> ring(carve);
  TileList list(carve, p.nT, false);

  const int flat = p.order[blockIdx.x / p.n_sub];  // (batch, head, key tile)
  const int sub = blockIdx.x % p.n_sub;
  const int kt = flat % p.nT;
  const int h = (flat / p.nT) % p.H;
  const int b = flat / (p.nT * p.H);
  const int bh = b * p.H + h;
  const int wg = warpgroup();
  const int r0 = sub * BR;  // the block's first key in the tile
  const int kv_valid = max(0, min(p.sizes[kt], p.E));
  // keys past the valid count get zero gradients: a block with none walks
  // nothing, a warpgroup with none runs no products
  const int live_units = max(0, min(2, (kv_valid - r0 + BC - 1) / BC));
  const int S = p.nT * p.E;

  list.build(p.list + static_cast<long long>(flat) * p.nT, nullptr,
             live_units > 0 ? p.counts[flat] : 0, nullptr, p.E);
  const int n_steps = *list.total;

  Cursor fill;
  fill.start(list);
  auto issue = [&](int i) {
    const int s = i % NS;
    const int qt = fill.tile(list), c0 = fill.row0();
    bar_expect(&ring.full[s], 2 * BC * D * 2 + 2 * kStatBox * 4);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      tma_load_5d(sq + s * BC * D + nb * BC * 64, &p.q, &ring.full[s], nb * 64, c0, qt, h, b);
      tma_load_5d(sdo + s * BC * D + nb * BC * 64, &p.dout, &ring.full[s], nb * 64, c0, qt, h,
                  b);
    }
    // the 4-aligned run of kStatBox statistics that covers the unit's rows
    // (rows past E read the next tile's, or zeros past the end: never live)
    const int at = (bh * S + qt * p.E + c0) & ~3;
    tma_load_1d(slse + s * kStatStride, &p.lse, &ring.full[s], at);
    tma_load_1d(sdelta + s * kStatStride, &p.delta, &ring.full[s], at);
    fill.next(list);
  };
  if (threadIdx.x == 0 && live_units > 0) {
    bar_expect(ring.own, live_units * 2 * BC * D * 2);
    for (int u = 0; u < live_units; ++u)
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb) {
        const int c0 = r0 + u * BC;
        tma_load_5d(sk + u * BC * D + nb * BC * 64, &p.k, ring.own, nb * 64, c0, kt, h, b);
        tma_load_5d(sv + u * BC * D + nb * BC * 64, &p.v, ring.own, nb * 64, c0, kt, h, b);
      }
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  }

  // this thread's two keys of the tile
  const int key0 = r0 + 64 * wg + frag_row(0);
  const int keys[2] = {key0, key0 + 8};
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (wg >= live_units) {
    for (int i = 0; i < n_steps; ++i) {
      ring.wait(i);
      ring.release(i, n_steps, issue);
    }
  } else {
    const bool key_ok[2] = {keys[0] < kv_valid, keys[1] < kv_valid};
    const bf16* sk_w = sk + wg * BC * D;
    const bf16* sv_w = sv + wg * BC * D;
    float s[BC / 2], dp[BC / 2];
    uint32_t pf[BC / 16][4], dsf[BC / 16][4];
    Cursor at;
    at.start(list);

    bar_wait(ring.own, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % NS;
      const bf16* qs = sq + st * BC * D;
      const bf16* dos = sdo + st * BC * D;
      const int qt = at.tile(list), c0 = at.row0();
      at.next(list);
      const int off = (bh * S + qt * p.E + c0) & 3;
      const float* ls = slse + st * kStatStride + off;
      const float* dls = sdelta + st * kStatStride + off;
      const int rows_left = p.E - c0;  // query rows of the unit below E
      ring.wait(i);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BC>(s, desc_k(sk_w, BC, 0, kk), desc_k(qs, BC, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BC>(dp, desc_k(sv_w, BC, 0, kk), desc_k(dos, BC, 0, kk), kk > 0);
      mma_commit();
      mma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

#pragma unroll
      for (int x = 0; x < BC / 2; ++x) {
        const int r = (x >> 1) & 1;
        const int c = frag_col(x);
        const float l = ls[c];
        const bool live = key_ok[r] & (c < rows_left) & (l > kSparseMaskHalf);
        const float pr = live ? exp2f(fmaf(s[x], p.scale_log2, -l * kLog2e)) : 0.f;
        dp[x] = pr * (dp[x] - dls[c]) * p.scale;
        s[x] = pr;
      }
      to_a_frags(s, pf);
      to_a_frags(dp, dsf);

      mma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) mma_rs<D>(dv, pf[kk], desc_mn(dos, BC, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) mma_rs<D>(dk, dsf[kk], desc_mn(qs, BC, kk), 1);
      mma_commit();
      mma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      ring.release(i, n_steps, issue);
    }
  }

  // every key of the block below E: its gradients, 0 past the valid count
  const long long tile_row = static_cast<long long>(kt) * p.E;
  bf16* ok = p.g0 + b * p.g0_sb + h * p.g0_sh + tile_row * p.g0_ss;
  bf16* ov = p.g1 + b * p.g1_sb + h * p.g1_sh + tile_row * p.g1_ss;
#pragma unroll
  for (int x = 0; x < D / 2; x += 2) {
    const int key = keys[(x >> 1) & 1];
    if (key < p.E) {
      *reinterpret_cast<uint32_t*>(ok + key * p.g0_ss + frag_col(x)) = pack_bf16(dk[x], dk[x + 1]);
      *reinterpret_cast<uint32_t*>(ov + key * p.g1_ss + frag_col(x)) = pack_bf16(dv[x], dv[x + 1]);
    }
  }
}

}  // namespace sm90
}  // namespace fvt

// The flash attention backward's Hopper schedule (K6 and K6 struct at bf16
// with a head of 64 or 128): flash_bwd.cu launches it, and keeps its first
// schedule (attn_bwd_tile.cuh) for other heads (the tiny models' 16, 32
// and 48). With flash_bwd.cu it replaces the Pallas _bwd_dq_kernel and
// _bwd_dkv_kernel (fastvideo_tpu/ops/flash_attention.py:310, :355; calls
// :432, :459). At every main-path shape it is bound by the tensor cores:
// five products of 2 D FLOP a visible pair (S and dP in both kernels, dS K;
// p^T dO, dS^T Q), so the design keeps every elementwise step in registers
// and the copies behind the products.
//
// Two kernels, as the Pallas backward has (_bwd_dq_kernel, _bwd_dkv_kernel):
// deterministic, no atomics. Each block runs two consumer warpgroups, 256
// threads, one block an SM; thread 0 keeps the copies in flight (its own
// tiles once, then the streamed chunks through a four-stage ring of TMA
// copies that complete to mbarriers; every warp releases a stage when its
// products have read it). Products are wgmma with fp32 sums in registers;
// the elementwise middle runs on the register fragments (sm90.cuh has the
// layout), and P and dS go from accumulator to A operand without leaving
// registers.
//
//  - dQ: a block owns 128 query rows (64 a warpgroup) with their Q and dO;
//    K and V stream in chunks of 64 keys. Per chunk S = Q K^T and dP = dO
//    V^T (both operands in shared memory), p = exp(s * scale - lse), dS =
//    p (dP - delta) scale, then dQ += dS K (dS from registers, K MN-major);
//    the next chunk's S and dP are issued before that product is waited
//    for. Its element mask is branch-free: a divergent branch that wrote
//    the products' registers made the compiler serialize the struct
//    instances' products.
//  - dK/dV: a block owns 128 keys (64 a warpgroup) with their K and V; Q,
//    dO, LSE and delta stream in chunks of 64 query rows. It computes the
//    transposes directly, S^T = K Q^T and dP^T = V dO^T, so that p^T and
//    dS^T come out in the accumulator layout that is the A operand of dV +=
//    p^T dO and dK += dS^T Q (dO and Q MN-major). With `splits` > 1 the
//    query rows are cut into that many contiguous ranges over the grid,
//    each writing fp32 partial sums, which flash_bwd_dkv_reduce adds in a
//    fixed order: at the cross-attention's 512 keys a split-free grid has
//    48 blocks for 132 SMs.
//
// Rounding points (attn_bwd_tile.cuh): s, dP, p and dS are fp32; p rounds
// to bf16 before p^T dO, dS before dS K and dS^T Q. A masked element's p
// is selected as 0 before the exponent is used, so a row with no valid key
// (LSE -inf) has exactly zero gradients. Masks as the forward's: kv_valid
// and causal, or the struct ranges of struct_mask.cuh; a thread checks
// single elements only in a chunk that is partial for one of its rows
// (keys).
#pragma once

#include "sm90.cuh"
#include "struct_mask.cuh"

namespace fvt {
namespace sm90 {

constexpr int kBwdOwn = 128;  // rows a block owns: dQ query rows, dK/dV keys
constexpr int kBwdStep = 64;  // streamed rows a chunk: dQ keys, dK/dV query rows
constexpr int kBwdStages = 4;
constexpr int kBwdThreads = 2 * kWarpgroup;
// A TMA box must start 16-byte aligned along its innermost dimension, and a
// chunk's LSE and delta start at any row: each stage loads the 4-aligned
// run of kStatBox values that covers the chunk, kStatStride apart.
constexpr int kStatBox = kBwdStep + 4;
constexpr int kStatStride = 128;

struct BwdMasks {
  int Sq, Skv, causal, kv_valid, chunk_tokens, tf_clean_len;
  float scale, scale_log2;
};

struct DqParams {
  CUtensorMap q, dout;  // box {64, kBwdOwn}
  CUtensorMap k, v;     // box {64, kBwdStep}
  const float* lse;     // [B, H, Sq]
  const float* delta;
  bf16* dq;
  long long dq_sb, dq_sh, dq_ss;
  int H, n_tiles;
  BwdMasks m;
};

struct DkvParams {
  CUtensorMap k, v;        // box {64, kBwdOwn}
  CUtensorMap q, dout;     // box {64, kBwdStep}
  CUtensorMap lse, delta;  // [B * H * Sq], box {kStatBox}
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  float* part_k;  // or null: [splits, B, H, Skv, D] fp32 partial sums
  float* part_v;
  int B, H, n_tiles, splits, split_rows;
  BwdMasks m;
};

template <int D, bool kStruct>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return 1024 + 2 * round_1k(kBwdOwn * D * 2) + 2 * round_1k(kBwdStages * kBwdStep * D * 2) +
         Ring<kBwdStages>::bytes() + (kStruct ? round_1k(3 * kBwdOwn * 4) : 0);
}

template <int D, bool kStruct>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return 1024 + 2 * round_1k(kBwdOwn * D * 2) + 2 * round_1k(kBwdStages * kBwdStep * D * 2) +
         2 * round_1k(kBwdStages * kStatStride * 4) + Ring<kBwdStages>::bytes() +
         (kStruct ? round_1k(4 * kBwdOwn * 4) : 0);
}

template <int D, bool kStruct>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ DqParams p) {
  constexpr int BR = kBwdOwn, BC = kBwdStep, NS = kBwdStages;
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  bf16* sq = carve.take<bf16>(BR * D);
  bf16* sdo = carve.take<bf16>(BR * D);
  bf16* sk = carve.take<bf16>(NS * BC * D);
  bf16* sv = carve.take<bf16>(NS * BC * D);
  const Ring<NS> ring(carve);

  const BwdMasks& m = p.m;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (p.n_tiles - 1 - blockIdx.z) * BR;
  const int wg = threadIdx.x / kWarpgroup;
  const int kv_end = min(m.kv_valid, m.Skv);

  Walk walk;
  if constexpr (kStruct) {
    int* sa = carve.take<int>(3 * BR);
    int* sb = sa + BR;
    int* sc = sa + 2 * BR;
    for (int r = threadIdx.x; r < BR; r += kBwdThreads) {
      int a = 0, b0 = 0, c = 0;
      if (q0 + r < m.Sq) struct_row_keys(q0 + r, m.chunk_tokens, m.tf_clean_len, kv_end, a, b0, c);
      sa[r] = a;
      sb[r] = b0;
      sc[r] = c;
    }
    __syncthreads();
    const Ranges keys = struct_tile_keys(sa, sb, sc, min(BR, m.Sq - q0));
    for (int i = 0; i < keys.n; ++i) walk.add(keys.lo[i], keys.hi[i], BC);
  } else {
    walk.add(0, m.causal ? min(kv_end, q0 + BR) : kv_end, BC);
  }
  __syncthreads();  // the barriers are initialised
  const int n_steps = walk.steps;

  auto issue = [&](int i) {
    int j0, end;
    walk.at(i, BC, j0, end);
    const int s = i % NS;
    bar_expect(&ring.full[s], 2 * BC * D * 2);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      tma_load_4d(sk + s * BC * D + nb * BC * 64, &p.k, &ring.full[s], nb * 64, j0, h, b);
      tma_load_4d(sv + s * BC * D + nb * BC * 64, &p.v, &ring.full[s], nb * 64, j0, h, b);
    }
  };
  if (threadIdx.x == 0) {
    bar_expect(ring.own, 2 * BR * D * 2);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      tma_load_4d(sq + nb * BR * 64, &p.q, ring.own, nb * 64, q0, h, b);
      tma_load_4d(sdo + nb * BR * 64, &p.dout, ring.own, nb * 64, q0, h, b);
    }
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  }

  // this thread's two rows, their LSE (log2 units) and delta
  const int row0 = q0 + 64 * wg + frag_row(0);
  const int rows[2] = {row0, row0 + 8};
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * m.Sq;
  float lse2[2], dlt[2];
  int lim[2], a[2], bk[2], ck[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < m.Sq;
    lse2[r] = in ? p.lse[stat0 + rows[r]] * kLog2e : 0.f;
    dlt[r] = in ? p.delta[stat0 + rows[r]] : 0.f;
    lim[r] = m.causal ? min(kv_end, rows[r] + 1) : kv_end;
    a[r] = bk[r] = ck[r] = 0;
    if (!in) lim[r] = 0;
    if constexpr (kStruct)
      if (in) struct_row_keys(rows[r], m.chunk_tokens, m.tf_clean_len, kv_end, a[r], bk[r], ck[r]);
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[BC / 2], dp[BC / 2];
  uint32_t dsf[BC / 16][4];

  bar_wait(ring.own, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % NS;
    const bf16* ks = sk + st * BC * D;
    const bf16* vs = sv + st * BC * D;
    ring.wait(i);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BC>(s, desc_k(sq, BR, 64 * wg, kk), desc_k(ks, BC, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BC>(dp, desc_k(sdo, BR, 64 * wg, kk), desc_k(vs, BC, 0, kk), kk > 0);
    mma_commit();
    if (i > 0) {  // the previous chunk's dS K is done: its stage is free
      mma_wait<1>();
      fence_regs(dq);
      ring.release(i - 1, n_steps, issue);
    }
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    int j0, end;
    walk.at(i, BC, j0, end);
    bool partial = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kStruct)
        partial |= !(j0 + BC <= end &&
                     (j0 + BC <= a[r] || (j0 >= bk[r] && j0 + BC <= ck[r])));
      else
        partial |= j0 + BC > lim[r];
    }
#pragma unroll
    for (int e = 0; e < BC / 2; ++e) {
      const int r = (e >> 1) & 1;
      const int col = j0 + frag_col(e);
      bool live;
      if constexpr (kStruct)
        live = (!partial) | ((col < end) & ((col < a[r]) | ((col >= bk[r]) & (col < ck[r]))));
      else
        live = (!partial) | (col < lim[r]);
      const float pr = live ? exp2f(fmaf(s[e], m.scale_log2, -lse2[r])) : 0.f;
      s[e] = pr * (dp[e] - dlt[r]) * m.scale;
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

  bf16* out = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = (e >> 1) & 1;
    if (rows[r] < m.Sq)
      *reinterpret_cast<uint32_t*>(out + rows[r] * p.dq_ss + frag_col(e)) =
          pack_bf16(dq[e], dq[e + 1]);
  }
}

template <int D, bool kStruct>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ DkvParams p) {
  constexpr int BR = kBwdOwn, BC = kBwdStep, NS = kBwdStages;
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  bf16* sk = carve.take<bf16>(BR * D);
  bf16* sv = carve.take<bf16>(BR * D);
  bf16* sq = carve.take<bf16>(NS * BC * D);
  bf16* sdo = carve.take<bf16>(NS * BC * D);
  float* slse = carve.take<float>(NS * kStatStride);
  float* sdelta = carve.take<float>(NS * kStatStride);
  const Ring<NS> ring(carve);

  const BwdMasks& m = p.m;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z / p.splits;
  const int split = blockIdx.z % p.splits;
  const int k0 = kt * BR;
  const int wg = threadIdx.x / kWarpgroup;
  const int kv_end = min(m.kv_valid, m.Skv);
  // the query rows of this split
  const int r_lo = min(split * p.split_rows, m.Sq);
  const int r_hi = min(r_lo + p.split_rows, m.Sq);

  Walk walk;
  if constexpr (kStruct) {
    int* sd = carve.take<int>(4 * BR);
    int* se = sd + BR;
    int* sf = sd + 2 * BR;
    int* sg = sd + 3 * BR;
    for (int r = threadIdx.x; r < BR; r += kBwdThreads) {
      int d = 0, e = 0, f = 0, g = 0;
      if (k0 + r < m.Skv)
        struct_key_rows(k0 + r, m.chunk_tokens, m.tf_clean_len, m.Sq, kv_end, d, e, f, g);
      sd[r] = d;
      se[r] = e;
      sf[r] = f;
      sg[r] = g;
    }
    __syncthreads();
    const Ranges rows =
        struct_tile_rows(sd, se, sf, sg, min(BR, m.Skv - k0), k0, m.tf_clean_len);
    for (int i = 0; i < rows.n; ++i) walk.add(max(rows.lo[i], r_lo), min(rows.hi[i], r_hi), BC);
  } else if (k0 < kv_end) {  // a tile wholly past kv_valid gets zero gradients
    walk.add(max(m.causal ? k0 : 0, r_lo), r_hi, BC);
  }
  __syncthreads();  // the barriers are initialised
  const int n_steps = walk.steps;
  const int bh = b * p.H + h;

  auto issue = [&](int i) {
    int i0, end;
    walk.at(i, BC, i0, end);
    const int s = i % NS;
    bar_expect(&ring.full[s], 2 * BC * D * 2 + 2 * kStatBox * 4);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      tma_load_4d(sq + s * BC * D + nb * BC * 64, &p.q, &ring.full[s], nb * 64, i0, h, b);
      tma_load_4d(sdo + s * BC * D + nb * BC * 64, &p.dout, &ring.full[s], nb * 64, i0, h, b);
    }
    // rows past Sq read the next head's statistics (or zeros past the end):
    // those rows are never live
    const int at = (bh * m.Sq + i0) & ~3;
    tma_load_1d(slse + s * kStatStride, &p.lse, &ring.full[s], at);
    tma_load_1d(sdelta + s * kStatStride, &p.delta, &ring.full[s], at);
  };
  if (threadIdx.x == 0) {
    bar_expect(ring.own, 2 * BR * D * 2);
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb) {
      tma_load_4d(sk + nb * BR * 64, &p.k, ring.own, nb * 64, k0, h, b);
      tma_load_4d(sv + nb * BR * 64, &p.v, ring.own, nb * 64, k0, h, b);
    }
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  }

  // this thread's two keys and the query rows that see them: kPlain, rows
  // from first[r] on when the key is below kv_valid; kStruct, [d, e) and
  // [f, g)
  const int key0 = k0 + 64 * wg + frag_row(0);
  const int keys[2] = {key0, key0 + 8};
  int first[2], d[2], e[2], f[2], g[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    first[r] = keys[r] < kv_end ? (m.causal ? keys[r] : 0) : INT_MAX;
    d[r] = e[r] = f[r] = g[r] = 0;
    if constexpr (kStruct)
      if (keys[r] < m.Skv)
        struct_key_rows(keys[r], m.chunk_tokens, m.tf_clean_len, m.Sq, kv_end, d[r], e[r], f[r],
                        g[r]);
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[BC / 2], dp[BC / 2];
  uint32_t pf[BC / 16][4], dsf[BC / 16][4];

  bar_wait(ring.own, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % NS;
    const bf16* qs = sq + st * BC * D;
    const bf16* dos = sdo + st * BC * D;
    // the chunk's first row sits `(bh * Sq + i0) % 4` values into the stage
    int i0, end;
    walk.at(i, BC, i0, end);
    const int off = (bh * m.Sq + i0) & 3;
    const float* ls = slse + st * kStatStride + off;
    const float* dls = sdelta + st * kStatStride + off;
    ring.wait(i);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BC>(s, desc_k(sk, BR, 64 * wg, kk), desc_k(qs, BC, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BC>(dp, desc_k(sv, BR, 64 * wg, kk), desc_k(dos, BC, 0, kk), kk > 0);
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    bool partial = i0 + BC > end;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kStruct)
        partial |= !((i0 >= d[r] && i0 + BC <= e[r]) || (i0 >= f[r] && i0 + BC <= g[r]));
      else
        partial |= i0 < first[r];
    }
#pragma unroll
    for (int x = 0; x < BC / 2; ++x) {
      const int r = (x >> 1) & 1;
      const int c = frag_col(x);
      bool live = true;
      if (partial) {
        const int row = i0 + c;
        if constexpr (kStruct)
          live = row < end && ((row >= d[r] && row < e[r]) || (row >= f[r] && row < g[r]));
        else
          live = row < end && row >= first[r];
      }
      const float pr = live ? exp2f(fmaf(s[x], m.scale_log2, -ls[c] * kLog2e)) : 0.f;
      dp[x] = pr * (dp[x] - dls[c]) * m.scale;
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

  if (p.part_k == nullptr) {
    bf16* ok = p.dk + b * p.dk_sb + h * p.dk_sh;
    bf16* ov = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
    for (int x = 0; x < D / 2; x += 2) {
      const int key = keys[(x >> 1) & 1];
      if (key < m.Skv) {
        *reinterpret_cast<uint32_t*>(ok + key * p.dk_ss + frag_col(x)) = pack_bf16(dk[x], dk[x + 1]);
        *reinterpret_cast<uint32_t*>(ov + key * p.dv_ss + frag_col(x)) = pack_bf16(dv[x], dv[x + 1]);
      }
    }
  } else {
    const long long base = ((static_cast<long long>(split) * p.B + b) * p.H + h) * m.Skv;
#pragma unroll
    for (int x = 0; x < D / 2; x += 2) {
      const int key = keys[(x >> 1) & 1];
      if (key < m.Skv) {
        const long long at = (base + key) * D + frag_col(x);
        *reinterpret_cast<float2*>(p.part_k + at) = make_float2(dk[x], dk[x + 1]);
        *reinterpret_cast<float2*>(p.part_v + at) = make_float2(dv[x], dv[x + 1]);
      }
    }
  }
}

// dk, dv [B, Skv, H, D] (strides batch, head, row) = the sum over the
// splits of part_k, part_v [splits, B, H, Skv, D], in split order, rounded
// once to bf16. One thread a 4-value group.
__global__ void flash_bwd_dkv_reduce(const float* __restrict__ part_k,
                                     const float* __restrict__ part_v, bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, int splits, int B, int H, int Skv,
                                     int D, long long dk_sb, long long dk_sh, long long dk_ss,
                                     long long dv_sb, long long dv_sh, long long dv_ss) {
  const long long n = static_cast<long long>(B) * H * Skv * D;
  const long long at = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (at >= n) return;
  const int d = static_cast<int>(at % D);
  long long rest = at / D;
  const int key = static_cast<int>(rest % Skv);
  rest /= Skv;
  const int h = static_cast<int>(rest % H);
  const int b = static_cast<int>(rest / H);
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int z = 0; z < splits; ++z) {
    const float4 a = *reinterpret_cast<const float4*>(part_k + z * n + at);
    const float4 c = *reinterpret_cast<const float4*>(part_v + z * n + at);
    sk.x += a.x;
    sk.y += a.y;
    sk.z += a.z;
    sk.w += a.w;
    sv.x += c.x;
    sv.y += c.y;
    sv.z += c.z;
    sv.w += c.w;
  }
  uint2 ok = make_uint2(pack_bf16(sk.x, sk.y), pack_bf16(sk.z, sk.w));
  uint2 ov = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  *reinterpret_cast<uint2*>(dk + b * dk_sb + h * dk_sh + key * dk_ss + d) = ok;
  *reinterpret_cast<uint2*>(dv + b * dv_sb + h * dv_sh + key * dv_ss + d) = ov;
}

}  // namespace sm90
}  // namespace fvt

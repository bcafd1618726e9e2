// The count-driven sparse forward's Hopper schedule (K9a and K9b at bf16
// with a head of 64 or 128): dyn_sparse_fwd.cu launches it, and keeps its
// first schedule (attn_tile.cuh) for other heads. It is K1's Hopper forward
// (flash_fwd_sm90.cuh: two consumer warpgroups of 64 query rows, a TMA
// ring of 128-key chunks, the online softmax on the register fragment with
// exp2, P as the register A operand of P V, the next S issued before P V is
// waited for) on a list walk (sm90.cuh: TileList, Cursor). Bound by the
// tensor cores at NABLA's and BSA's kept fractions: 4 D FLOP a (query row,
// kept key) pair.
//
// A block owns 128 consecutive query rows. Where a query tile has fewer
// rows (K9a's 64-row tiles, K9b's 32 pruned queries of a tile), the block's
// rows hold a group of `group` = 128 / rows query tiles, and it walks the
// ascending union of their lists, built in the caller (ops/
// sparse_schedule.py:grouped_lists) with, per entry, the bit set of the
// group's tiles that keep it; each row masks the key tiles its own tile
// does not keep (p = 0, and the row's max ignores them), so the result is
// each tile's own. A row of a tile with no key stores 0, as the Pallas
// kernel's l_inv does. The key tiles are read through a 5-D map over
// [B, H, nK, E, D] in 64-row units, two units a chunk (an odd walk's last
// chunk loads its unit twice and masks the second copy), whole: a unit's
// K rows past its valid keys are masked in the scores, and its V rows are
// zeroed in shared memory before P V, so the padded slots of a tile may
// hold anything (0 * NaN would be NaN). The grid runs the groups with the
// longest unions first (`order`).
//
// The padded sparse forward (K8, and K7 fwd, its LSE mode) runs the same
// body (vsa_sparse_padded_fwd.cu): each query tile walks its own top-k row
// as it is (no counts, no bits: a -1 slot has no valid row and is
// skipped), and the LSE is written where its pointer is set (a row with no valid key: 0 and kEmptyLse, the Pallas kernels'
// MASK_VALUE). Its tiles of 64 rows (SLA) run one warpgroup a block over
// 64-key chunks (kWGs = 1), so each tile walks its own list: a group of
// two 10 % lists walks close to their sum.
//
// The VSA forward on full tiles (K2, vsa_sparse_fwd.cu) runs it too, on
// each query group's top-k row, with two cuts its contract allows: a
// block's 128 rows tile the group's G E rows back to back (`rows` = G E,
// so a group of 840 rows is 7 blocks, the last 72 rows deep), and, where E
// is a multiple of 8, the keys are walked as ONE stream (kStream): the
// group's K full tiles back to back, K E keys in 64-key units, each unit
// one {64, 64} box where it lies in one tile and eight {64, 8} boxes
// where it crosses a tile's end (an 8-row box never does), so only the
// stream's last unit is ragged. The stream's copies are issued by a
// producer warpgroup of their own (one warp of it, one box a lane; 384
// threads a block), so no copy code sits between a consumer's products
// and their wait (issued from a consumer warp, it made ptxas serialize the
// wgmma, C7518); the producer gives its registers to the consumers
// (setmaxnreg: 40 and 232 a thread; with 288 threads ptxas capped every
// thread at 168 and spilled). Its padded slots are real, finite rows
// (never zeroed: their weight is exactly 0).
#pragma once

#include "flash_fwd_sm90.cuh"

namespace fvt {
namespace sm90 {

constexpr int kDynBQ = kFwdBQ;       // query rows a block: 2 warpgroups of 64
constexpr int kDynBK = 2 * kUnit;    // keys a chunk: two units of the walk
constexpr int kDynStages = kFwdStages;
static_assert(kDynBK == kFwdBK, "a chunk is K1's 128 keys");

// the LSE of a row with no valid key: the Pallas kernels' MASK_VALUE
constexpr float kEmptyLse = -0.7f * 3.4028234663852886e38f;

struct DynFwdParams {
  CUtensorMap q;     // map_bshd over [B, H, Sq, D], box {64, 64}
  CUtensorMap k, v;  // map_tiles over [B, H, nK, E, D], box {64, kUnit};
                     // K2's stream: map_bshd over [B, H, S, D], box {64, 64}
  CUtensorMap k8, v8;  // K2's stream: map_bshd, box {64, 8}
  bf16* o;
  float* lse;  // [B, H, Sq] or null
  long long o_sb, o_sh, o_ss;
  const int* list;    // [B, H, nG, stride] each group's union, ascending, then -1
  const int* counts;  // [B, H, nG], or null: a list's every entry
  const int* bits;    // [B, H, nG, stride] the group's tiles that keep each
                      // entry, or null: a group of one tile keeps every entry
  const int* sizes;   // [nK]
  const int* order;   // [B * H * nG] flat (batch, head, group) in launch
                      // order, or null: in order
  int H, Sq, E, rows, group, nG, n_sub;
  int stride;  // entries a list row holds (nK for a union list)
  float scale_log2;
};

// A block of kWGs consumer warpgroups (64 query rows each) walks chunks of
// kWGs units: 128 keys (K9's and K1's chunk) with two, 64 with one.
template <int kWGs>
__host__ __device__ constexpr int dyn_chunk_keys() {
  return kWGs == 2 ? kDynBK : kUnit;
}

// The dynamic shared memory of a block whose list rows hold `stride`
// entries.
template <int D, int kWGs = 2>
__host__ __device__ constexpr size_t dyn_fwd_smem_bytes(int stride) {
  return 1024 + round_1k(64 * kWGs * D * 2) +
         2 * round_1k(kDynStages * dyn_chunk_keys<kWGs>() * D * 2) +
         Ring<kDynStages, 4 * kWGs>::bytes() + TileList::bytes(stride, true);
}

template <int D, int kWGs, bool kStream = false>
__device__ __forceinline__ void dyn_fwd_body(const DynFwdParams& p) {
  constexpr int BQ = 64 * kWGs, BK = dyn_chunk_keys<kWGs>(), NS = kDynStages;
  constexpr int U = BK / kUnit;  // units a chunk
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  bf16* sq = carve.take<bf16>(BQ * D);
  bf16* sk = carve.take<bf16>(NS * BK * D);
  bf16* sv = carve.take<bf16>(NS * BK * D);
  const Ring<NS, 4 * kWGs> ring(carve);
  TileList list(carve, p.stride, true);

  const int flat = p.order == nullptr ? blockIdx.x / p.n_sub
                                      : p.order[blockIdx.x / p.n_sub];  // (batch, head, group)
  const int sub = blockIdx.x % p.n_sub;
  const int g = flat % p.nG;
  const int h = (flat / p.nG) % p.H;
  const int b = flat / (p.nG * p.H);
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWarpgroup, 0);
  const int span = p.group * p.rows;  // the group's rows
  const int base = g * span;          // its first row
  const int r0 = sub * BQ;            // the block's first row in the group
  const int live_wgs = max(0, min(kWGs, (min(span, p.Sq - base) - r0 + 63) / 64));

  const long long row = static_cast<long long>(flat) * p.stride;
  const int count = live_wgs == 0 ? 0 : p.counts == nullptr ? p.stride : p.counts[flat];
  int units, keys = 0;  // the walk's units; the stream's keys
  if constexpr (kStream) {
    for (int t = threadIdx.x; t < count; t += blockDim.x) list.id[t] = __ldg(p.list + row + t);
    __syncthreads();
    keys = count * p.E;
    units = (keys + kUnit - 1) / kUnit;
  } else {
    list.build(p.list + row, p.bits == nullptr ? nullptr : p.bits + row, count, p.sizes, p.E);
    units = *list.total;
  }
  const int n_steps = (units + U - 1) / U;

  Cursor fill;
  fill.start(list);
  int filled = 0;  // units issued
  auto issue = [&](int i) {
    const int s = i % NS;
    if constexpr (kStream) {  // every lane of the producer warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) bar_expect(&ring.full[s], 2 * BK * D * 2);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k0 = min(i * U + u, units - 1) * kUnit;  // past the walk: the last unit again
        const int j = k0 / p.E, r0 = k0 - j * p.E;
        const int at = s * BK * D + u * kUnit * 64;
        if (r0 + kUnit <= p.E) {  // in one tile: a box a half of D, of K and of V
          if (lane < 2 * (D / 64)) {
            const int nb = lane % (D / 64);
            const bool is_v = lane >= D / 64;
            tma_load_4d((is_v ? sv : sk) + at + nb * BK * 64, is_v ? &p.v : &p.k,
                        &ring.full[s], nb * 64, list.id[j] * p.E + r0, h, b);
          }
        } else if (lane < 16 * (D / 64)) {  // across a tile's end: 8-row boxes
          const int bx = lane % 8, nb = (lane / 8) % (D / 64);
          const bool is_v = lane >= 8 * (D / 64);
          const int kk = min(k0 + 8 * bx, keys - 8);  // past the stream: a real row, masked
          const int jj = kk / p.E;
          tma_load_4d((is_v ? sv : sk) + at + nb * BK * 64 + 8 * bx * 64, is_v ? &p.v8 : &p.k8,
                      &ring.full[s], nb * 64, list.id[jj] * p.E + kk - jj * p.E, h, b);
        }
      }
      __syncwarp();
      return;
    }
    bar_expect(&ring.full[s], 2 * BK * D * 2);
    int kt = 0, c0 = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (filled < units) {  // else: the last unit again, masked
        kt = fill.tile(list);
        c0 = fill.row0();
        fill.next(list);
        ++filled;
      }
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb) {
        const int at = s * BK * D + nb * BK * 64 + u * kUnit * 64;
        tma_load_5d(sk + at, &p.k, &ring.full[s], nb * 64, c0, kt, h, b);
        tma_load_5d(sv + at, &p.v, &ring.full[s], nb * 64, c0, kt, h, b);
      }
    }
  };
  if (threadIdx.x == 0) {
    bar_expect(ring.own, live_wgs * 64 * D * 2);
    for (int w = 0; w < live_wgs; ++w)
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
        tma_load_4d(sq + nb * BQ * 64 + w * 64 * 64, &p.q, ring.own, nb * 64, base + r0 + 64 * w,
                    h, b);
  }
  if constexpr (kStream) {
    if (wg == kWGs) {  // the producer: chunk i once its stage is free
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      if (threadIdx.x < kWGs * kWarpgroup + 32)
        for (int i = 0; i < n_steps; ++i) {
          if (i >= NS) bar_wait(&ring.empty[i % NS], (i / NS - 1) & 1);
          issue(i);
        }
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  } else if (threadIdx.x == 0) {
    for (int i = 0; i < min(NS, n_steps); ++i) issue(i);
  }
  auto release = [&](int i) {
    if constexpr (kStream)
      ring.arrive(i);
    else
      ring.release(i, n_steps, issue);
  };

  if (wg >= live_wgs) {  // rows past the group: release the stages
    for (int i = 0; i < n_steps; ++i) {
      ring.wait(i);
      release(i);
    }
    return;
  }

  // this thread's two rows (in the group) and the bit of each one's tile
  const int lrow0 = r0 + 64 * wg + frag_row(0);
  const int lrows[2] = {lrow0, lrow0 + 8};
  unsigned mine[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mine[r] = lrows[r] < span && base + lrows[r] < p.Sq ? 1u << (lrows[r] / p.rows) : 0u;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float s[BK / 2];
  uint32_t pf[BK / 16][4];
  Cursor at;
  at.start(list);
  int used = 0;  // units consumed

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
      release(i - 1);
    }
    // the visible keys of each unit for each row: below lim[r][u]
    int lim[2][U], valid[U];
    bool ragged = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int nk = 0;
      unsigned keep = 0;
      if (used < units) {
        if constexpr (kStream) {
          nk = min(kUnit, keys - used * kUnit);
          keep = 1u;
        } else {
          nk = at.rows(list);
          keep = static_cast<unsigned>(list.bits[at.j]);
          at.next(list);
        }
        ++used;
      }
      valid[u] = nk;
      ragged = ragged || nk < kUnit;
#pragma unroll
      for (int r = 0; r < 2; ++r) lim[r][u] = (keep & mine[r]) ? nk : 0;
    }
    if (!kStream && ragged) {  // the same for every thread of the block
      // V rows past a unit's valid keys may hold anything (a tile's padded
      // slots): zero them, so that their zero weights give 0, not NaN
      bf16* vz = sv + st * BK * D;
      const int t = threadIdx.x % kWarpgroup;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int nb = 0; nb < D / 64; ++nb)
          for (int c = valid[u] * 8 + t; c < kUnit * 8; c += kWarpgroup)  // 16-byte chunks
            reinterpret_cast<uint4*>(vz + nb * BK * 64 + u * kUnit * 64)[c] = make_uint4(0, 0, 0, 0);
      // the generic stores before this warpgroup's P V reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWarpgroup) : "memory");
    }
    mma_wait<0>();
    fence_regs(s);

#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int u = U == 2 && e >= BK / 4;  // columns 64 on: the second unit
      const bool ok = frag_col(e) - u * kUnit < lim[(e >> 1) & 1][u];
      s[e] = ok ? s[e] : -CUDART_INF_F;
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
    release(n_steps - 1);
  }

  // epilogue: O / l in bf16 (0 for a row that saw no key), and the LSE
  // m ln 2 + ln l (kEmptyLse for such a row) where it is asked for
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
  bf16* out = p.o + b * p.o_sb + h * p.o_sh + static_cast<long long>(base) * p.o_ss;
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = (e >> 1) & 1;
    if (mine[r] != 0u)
      *reinterpret_cast<uint32_t*>(out + lrows[r] * p.o_ss + frag_col(e)) =
          pack_bf16(o[e] * inv[r], o[e + 1] * inv[r]);
  }
  if (p.lse != nullptr && threadIdx.x % 4 == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq + base;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (mine[r] != 0u) lse[lrows[r]] = l[r] == 0.f ? kEmptyLse : m[r] * kLn2 + logf(l[r]);
  }
}

// K9a (kQTile false) and K9b (true): two instances, listed apart.
template <int D, bool kQTile>
__global__ void __launch_bounds__(kFwdThreads, 1)
    dyn_sparse_fwd_sm90(const __grid_constant__ DynFwdParams p) {
  dyn_fwd_body<D, 2>(p);
}

// K8 / K7 fwd: kWGs warpgroups a block (1 for tiles of 64 rows).
template <int D, int kWGs>
__global__ void __launch_bounds__(kWGs * kWarpgroup, 1)
    vsa_sparse_padded_fwd_sm90(const __grid_constant__ DynFwdParams p) {
  dyn_fwd_body<D, kWGs>(p);
}

}  // namespace sm90
}  // namespace fvt

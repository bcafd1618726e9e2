// Block-sparse attention backward for Hopper (sm_90a): K7 bwd.
//
// Replaces the Pallas kernels fastvideo_tpu/ops/vsa.py:
// _sparse_bwd_dq_kernel (dQ) and _sparse_bwd_dkv_kernel (dK, dV), reached
// through _block_sparse_bwd, the custom VJP of
// block_sparse_attention_trainable and of the exact-tile _bsa_fast. The
// forward is K7's LSE mode (vsa_sparse_padded_fwd.cu). The arithmetic and
// its rounding points are attn_bwd_tile.cuh's.
//
// What bounds it: five products of 2 * D FLOP per (query row, valid key)
// pair of the sparsity, against reads of q, k, v, dO and writes of dq, dk,
// dv: 3.38e12 FLOP at 480p top-24, operations-bound. Two schedules, chosen
// by the head alone (fvt_vsa_sparse_bwd_sm90 says which; the kernels take
// bf16 only; no fallback between them):
//  - a head of 64 or 128, every DiT launch: vsa_sparse_bwd_sm90.cuh, K6's
//    Hopper backward (wgmma, registers, a TMA ring) on a list walk. The
//    first schedule lost its time in WMMA round trips through shared
//    memory and synchronous loads.
// Both schedules' dK/dV walk a compacted transpose of the sparsity (per key
// tile the ascending query tiles that selected it, built in the caller),
// the key tiles with the longest lists first.
//  - other heads (the tiny models): the first schedule below.
//
// q/k/v/dO are [B, H, nB*E, D] in tile-major order; tile t holds
// block_sizes[t] real tokens, then padding. The first schedule:
//   * dQ: each block owns 64 rows of one query tile and walks that tile's
//     top-k key tiles (indices [B, H, nB, K], per tile: a grouped selection
//     is expanded before the launch, as vsa.py:1033-1035 does), skipping
//     -1 slots and stopping each tile at its valid count.
//   * dK/dV: the transposed sparsity, as lists built in the caller from the
//     membership JAX builds outside its kernel (vsa.py:934-946): per key
//     tile the ascending query tiles that selected it. Each block owns 64
//     rows of one key tile and walks that list. Top-k gives no duplicate
//     slot, so a pair is counted once. A key tile of E = 280 rows is 5
//     blocks (280 fp32 rows of dK and dV do not fit in one block's shared
//     memory), so there are 117 x 5 x 12 blocks at 480p, launched in
//     `order`, the longest lists first.
//   * A probability is live where its key is below the tile's valid count
//     and the row's LSE is above MASK_VALUE / 2, as in JAX: a row with no
//     valid key (LSE MASK_VALUE) contributes exactly 0. Padded query rows
//     are computed like any row, as in JAX (their dO is 0 on every caller).
//   * E need not be a multiple of 64 (280 at 480p): the ragged last chunk
//     of a tile is masked on the query side and on the key side by bounds
//     checks, the rows past it zero-filled, as in K2.
//   * WMMA bf16 tiles through shared memory, no load/compute overlap.
#include "attn_bwd_tile.cuh"
#include "vsa_sparse_bwd_sm90.cuh"

namespace {

using fvt::bf16;
using fvt::BwdSmem;

constexpr int kBQ = 64;
constexpr int kBK = 64;
// a row whose LSE is at or below this saw no valid key (vsa.py:747)
constexpr float kMaskHalf = -0.35f * 3.4028234663852886e38f;

__global__ void __launch_bounds__(fvt::kThreads)
    vsa_sparse_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, const int* __restrict__ indices,
                             const int* __restrict__ block_sizes, int H, int S, int D, int E,
                             int n_tiles, int topk, int n_sub, long long q_sb, long long q_sh,
                             long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                             long long o_sh, long long o_ss, long long dq_sb, long long dq_sh,
                             long long dq_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  BwdSmem<kBQ, kBK> t;
  t.carve(smem, D, 1);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = blockIdx.x / n_sub;
  const int sub = blockIdx.x - qi * n_sub;
  const long long row0 = static_cast<long long>(qi) * E + sub * kBQ;
  const int nq = min(kBQ, E - sub * kBQ);
  const long long bh = static_cast<long long>(b) * H + h;
  const int* idx = indices + (bh * n_tiles + qi) * topk;
  const int warp = threadIdx.x / 32;

  t.zero_acc(1);
  fvt::load_bf16_rows(t.own0, t.ldt, q + b * q_sb + h * q_sh + row0 * q_ss, q_ss, nq, kBQ, D);
  fvt::load_bf16_rows(t.own1, t.ldt, dout + b * o_sb + h * o_sh + row0 * o_ss, o_ss, nq, kBQ, D);
  for (int r = threadIdx.x; r < kBQ; r += fvt::kThreads) {
    t.lse[r] = r < nq ? lse[bh * S + row0 + r] : 0.f;
    t.delta[r] = r < nq ? delta[bh * S + row0 + r] : 0.f;
  }
  const bf16* kp = k + b * k_sb + h * k_sh;
  const bf16* vp = v + b * v_sb + h * v_sh;

  // idx[j] and block_sizes are the same for every thread of the block, so
  // the skips below are uniform and the barrier pairs stay matched
  for (int j = 0; j < topk; ++j) {
    const int tile = idx[j];
    if (tile < 0) continue;  // a -1 sentinel slot
    const int valid = min(block_sizes[tile], E);
    const long long tile_row = static_cast<long long>(tile) * E;
    for (int c0 = 0; c0 < valid; c0 += kBK) {
      const int nk = min(kBK, valid - c0);
      __syncthreads();  // every warp is done with the previous chunk
      fvt::load_bf16_rows(t.str0, t.ldt, kp + (tile_row + c0) * k_ss, k_ss, nk, kBK, D);
      fvt::load_bf16_rows(t.str1, t.ldt, vp + (tile_row + c0) * v_ss, v_ss, nk, kBK, D);
      __syncthreads();
      fvt::warp_abt(t.s + warp * 16 * t.lds, t.lds, t.own0 + warp * 16 * t.ldt, t.str0, t.ldt,
                    kBK, D);
      fvt::warp_abt(t.dp + warp * 16 * t.lds, t.lds, t.own1 + warp * 16 * t.ldt, t.str1, t.ldt,
                    kBK, D);
      __syncwarp();
      fvt::grad_scores<kBK>(
          t.s, t.dp, t.lds, nullptr, t.ds, t.ldp, scale, false,
          [&](int r, int c) { return r < nq && c < nk && t.lse[r] > kMaskHalf; },
          [&](int r, int) { return t.lse[r]; }, [&](int r, int) { return t.delta[r]; });
      fvt::warp_acc_ab(t.acc0 + warp * 16 * t.ldo, t.ldo, t.ds + warp * 16 * t.ldp, t.ldp,
                       t.str0, t.ldt, kBK, D);
    }
  }
  __syncwarp();
  t.store(t.acc0, dq + b * dq_sb + h * dq_sh + row0 * dq_ss, dq_ss, nq);
}

__global__ void __launch_bounds__(fvt::kThreads)
    vsa_sparse_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              const int* __restrict__ t_list, const int* __restrict__ t_counts,
                              const int* __restrict__ order, const int* __restrict__ block_sizes,
                              int H, int S, int D, int E, int n_tiles, int n_sub,
                              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                              long long dk_sb, long long dk_sh, long long dk_ss,
                              long long dv_sb, long long dv_sh, long long dv_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  BwdSmem<kBK, kBQ> t;
  t.carve(smem, D, 2);
  const int flat = order[blockIdx.x / n_sub];  // (batch, head, key tile)
  const int sub = blockIdx.x % n_sub;
  const int kt = flat % n_tiles;
  const int h = (flat / n_tiles) % H;
  const int b = flat / (n_tiles * H);
  const long long k0 = static_cast<long long>(kt) * E + sub * kBK;
  const int nk = min(kBK, E - sub * kBK);
  // keys of this block below the tile's valid count; the rest get 0
  const int nvalid = max(0, min(min(block_sizes[kt], E) - sub * kBK, nk));
  const long long bh = static_cast<long long>(b) * H + h;
  const int* row = t_list + static_cast<long long>(flat) * n_tiles;
  const bf16* qp = q + b * q_sb + h * q_sh;
  const bf16* op = dout + b * o_sb + h * o_sh;
  const int warp = threadIdx.x / 32;

  t.zero_acc(2);
  fvt::load_bf16_rows(t.own0, t.ldt, k + b * k_sb + h * k_sh + k0 * k_ss, k_ss, nvalid, kBK, D);
  fvt::load_bf16_rows(t.own1, t.ldt, v + b * v_sb + h * v_sh + k0 * v_ss, v_ss, nvalid, kBK, D);

  // the list and nvalid are block-uniform: barriers stay matched
  const int count = nvalid > 0 ? t_counts[flat] : 0;
  for (int j = 0; j < count; ++j) {
    const int qi = row[j];
    for (int c0 = 0; c0 < E; c0 += kBQ) {
      const int nq = min(kBQ, E - c0);
      const long long r0 = static_cast<long long>(qi) * E + c0;
      __syncthreads();  // every warp is done with the previous chunk
      fvt::load_bf16_rows(t.str0, t.ldt, qp + r0 * q_ss, q_ss, nq, kBQ, D);
      fvt::load_bf16_rows(t.str1, t.ldt, op + r0 * o_ss, o_ss, nq, kBQ, D);
      for (int c = threadIdx.x; c < kBQ; c += fvt::kThreads) {
        t.lse[c] = c < nq ? lse[bh * S + r0 + c] : 0.f;
        t.delta[c] = c < nq ? delta[bh * S + r0 + c] : 0.f;
      }
      __syncthreads();
      // rows of s are keys, columns query rows: s = K Q^T, dp = V dO^T
      fvt::warp_abt(t.s + warp * 16 * t.lds, t.lds, t.own0 + warp * 16 * t.ldt, t.str0, t.ldt,
                    kBQ, D);
      fvt::warp_abt(t.dp + warp * 16 * t.lds, t.lds, t.own1 + warp * 16 * t.ldt, t.str1, t.ldt,
                    kBQ, D);
      __syncwarp();
      fvt::grad_scores<kBQ>(
          t.s, t.dp, t.lds, t.p, t.ds, t.ldp, scale, true,
          [&](int r, int c) { return r < nvalid && c < nq && t.lse[c] > kMaskHalf; },
          [&](int, int c) { return t.lse[c]; }, [&](int, int c) { return t.delta[c]; });
      fvt::warp_acc_ab(t.acc1 + warp * 16 * t.ldo, t.ldo, t.p + warp * 16 * t.ldp, t.ldp,
                       t.str1, t.ldt, kBQ, D);
      fvt::warp_acc_ab(t.acc0 + warp * 16 * t.ldo, t.ldo, t.ds + warp * 16 * t.ldp, t.ldp,
                       t.str0, t.ldt, kBQ, D);
    }
  }
  __syncwarp();
  t.store(t.acc0, dk + b * dk_sb + h * dk_sh + k0 * dk_ss, dk_ss, nk);
  t.store(t.acc1, dv + b * dv_sb + h * dv_sh + k0 * dv_ss, dv_ss, nk);
}

bool bad_shape(int B, int H, int S, int D, int E) {
  return D % 16 != 0 || D > 128 || B <= 0 || H <= 0 || E <= 0 || S <= 0 || S % E != 0;
}

// Whether a head of D takes the Hopper schedule (the kernels are bf16
// only). ops/sparse_schedule.py:sparse_schedule states the same rule.
bool use_sm90(int D) { return D == 64 || D == 128; }

namespace s9 = fvt::sm90;

// The maps and sizes both Hopper kernels share; false when a tensor map
// cannot be encoded (an unaligned base or stride).
bool sm90_params(s9::SparseBwdParams& p, const void* q, const void* k, const void* v,
                 const void* dout, int B, int H, int S, int D, int E, const long long* st,
                 float scale) {
  const int nT = S / E;
  if (!s9::map_tiles(&p.q, q, B, H, nT, E, D, st[0], st[1], st[2]) ||
      !s9::map_tiles(&p.k, k, B, H, nT, E, D, st[3], st[4], st[5]) ||
      !s9::map_tiles(&p.v, v, B, H, nT, E, D, st[6], st[7], st[8]) ||
      !s9::map_tiles(&p.dout, dout, B, H, nT, E, D, st[9], st[10], st[11]))
    return false;
  p.H = H;
  p.nT = nT;
  p.E = E;
  p.n_sub = (E + s9::kBwdOwn - 1) / s9::kBwdOwn;
  p.scale = scale;
  p.scale_log2 = scale * s9::kLog2e;
  return static_cast<long long>(B) * H * nT * p.n_sub <= 2147483647LL;
}

template <int D>
int launch_dq_sm90(s9::SparseBwdParams& p, long long blocks, cudaStream_t stream) {
  const size_t smem = s9::sparse_dq_smem_bytes<D>(p.slots);
  cudaError_t err = s9::set_smem(s9::vsa_sparse_bwd_dq_sm90<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::vsa_sparse_bwd_dq_sm90<D><<<static_cast<unsigned>(blocks), s9::kBwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_sm90(s9::SparseBwdParams& p, long long blocks, cudaStream_t stream) {
  const size_t smem = s9::sparse_dkv_smem_bytes<D>(p.nT);
  cudaError_t err = s9::set_smem(s9::vsa_sparse_bwd_dkv_sm90<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::vsa_sparse_bwd_dkv_sm90<D><<<static_cast<unsigned>(blocks), s9::kBwdThreads, smem, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a head of D runs the Hopper schedule (vsa_sparse_bwd_sm90.cuh), 0
// when it runs the first one.
extern "C" int fvt_vsa_sparse_bwd_sm90(int D) { return use_sm90(D) ? 1 : 0; }

// The Hopper schedule's dynamic shared memory a block (bytes): kind 0 dQ
// (n = top-k slots), 1 dK/dV (n = tiles); a head of D (64 or 128).
extern "C" int fvt_vsa_sparse_bwd_sm90_smem(int kind, int D, int n) {
  size_t bytes;
  if (kind == 0)
    bytes = D == 64 ? s9::sparse_dq_smem_bytes<64>(n) : s9::sparse_dq_smem_bytes<128>(n);
  else
    bytes = D == 64 ? s9::sparse_dkv_smem_bytes<64>(n) : s9::sparse_dkv_smem_bytes<128>(n);
  return static_cast<int>(bytes);
}

// bfloat16 only, D a multiple of 16 up to 128. S = nB * E rows; lse and
// delta fp32 [B, H, S] contiguous; indices int32 [B, H, nB, topk]
// contiguous with -1 sentinels; block_sizes int32 [nB]. Strides in elements
// (batch, head, row) for q, k, v, dO and dq. A head of 64 or 128 runs the
// Hopper schedule, any other the first one.
extern "C" int fvt_vsa_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, const void* indices, const void* block_sizes,
                                     int B, int H, int S, int D, int E, int topk, long long q_sb,
                                     long long q_sh, long long q_ss, long long k_sb,
                                     long long k_sh, long long k_ss, long long v_sb,
                                     long long v_sh, long long v_ss, long long o_sb,
                                     long long o_sh, long long o_ss, long long dq_sb,
                                     long long dq_sh, long long dq_ss, float scale,
                                     void* stream) {
  if (bad_shape(B, H, S, D, E) || topk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (use_sm90(D)) {
    const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
    s9::SparseBwdParams p;
    if (!sm90_params(p, q, k, v, dout, B, H, S, D, E, st, scale))
      return static_cast<int>(cudaErrorInvalidValue);
    p.lse_p = static_cast<const float*>(lse);
    p.delta_p = static_cast<const float*>(delta);
    p.list = static_cast<const int*>(indices);
    p.counts = nullptr;
    p.sizes = static_cast<const int*>(block_sizes);
    p.order = nullptr;
    p.g0 = static_cast<bf16*>(dq);
    p.g1 = nullptr;
    p.g0_sb = dq_sb;
    p.g0_sh = dq_sh;
    p.g0_ss = dq_ss;
    p.slots = topk;
    const long long blocks = static_cast<long long>(B) * H * p.nT * p.n_sub;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return D == 64 ? launch_dq_sm90<64>(p, blocks, s) : launch_dq_sm90<128>(p, blocks, s);
  }
  const size_t smem = BwdSmem<kBQ, kBK>::bytes(D, 1);
  cudaError_t err = fvt::set_smem(vsa_sparse_bwd_dq_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = S / E;
  const int n_sub = (E + kBQ - 1) / kBQ;
  dim3 grid(n_tiles * n_sub, H, B);
  vsa_sparse_bwd_dq_kernel<<<grid, fvt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<const int*>(indices), static_cast<const int*>(block_sizes), H, S, D, E,
      n_tiles, topk, n_sub, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss, dq_sb, dq_sh, dq_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

// t_list int32 [B, H, nB, nB]: per key tile the ascending query tiles that
// selected it, then -1; t_counts int32 [B, H, nB]: their number; order
// int32 [B * H * nB]: the flat (batch, head, key tile) of each block in
// launch order (longest lists first). Otherwise as fvt_vsa_sparse_bwd_dq,
// writing dk and dv.
extern "C" int fvt_vsa_sparse_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* t_list, const void* t_counts,
    const void* order, const void* block_sizes, int B, int H, int S, int D, int E, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, float scale, void* stream) {
  if (bad_shape(B, H, S, D, E)) return static_cast<int>(cudaErrorInvalidValue);
  if (use_sm90(D)) {
    const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
    s9::SparseBwdParams p;
    const long long n_stats = static_cast<long long>(B) * H * S;
    if (!sm90_params(p, q, k, v, dout, B, H, S, D, E, st, scale) ||
        !s9::map_f32(&p.lse, lse, n_stats, s9::kStatBox) ||
        !s9::map_f32(&p.delta, delta, n_stats, s9::kStatBox) || n_stats > 2147483647LL)
      return static_cast<int>(cudaErrorInvalidValue);
    p.lse_p = nullptr;
    p.delta_p = nullptr;
    p.list = static_cast<const int*>(t_list);
    p.counts = static_cast<const int*>(t_counts);
    p.sizes = static_cast<const int*>(block_sizes);
    p.order = static_cast<const int*>(order);
    p.g0 = static_cast<bf16*>(dk);
    p.g1 = static_cast<bf16*>(dv);
    p.g0_sb = dk_sb;
    p.g0_sh = dk_sh;
    p.g0_ss = dk_ss;
    p.g1_sb = dv_sb;
    p.g1_sh = dv_sh;
    p.g1_ss = dv_ss;
    p.slots = p.nT;
    const long long blocks = static_cast<long long>(B) * H * p.nT * p.n_sub;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return D == 64 ? launch_dkv_sm90<64>(p, blocks, s) : launch_dkv_sm90<128>(p, blocks, s);
  }
  const size_t smem = BwdSmem<kBK, kBQ>::bytes(D, 2);
  cudaError_t err = fvt::set_smem(vsa_sparse_bwd_dkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = S / E;
  const int n_sub = (E + kBK - 1) / kBK;
  const long long blocks = static_cast<long long>(B) * H * n_tiles * n_sub;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  vsa_sparse_bwd_dkv_kernel<<<static_cast<unsigned>(blocks), fvt::kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const int*>(t_list), static_cast<const int*>(t_counts),
      static_cast<const int*>(order), static_cast<const int*>(block_sizes), H, S, D, E, n_tiles,
      n_sub, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, dk_sb, dk_sh,
      dk_ss, dv_sb, dv_sh, dv_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

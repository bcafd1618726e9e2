// Count-driven block-sparse attention forward for Hopper (sm_90a): K9a and
// K9b.
//
// Replaces the Pallas kernel _dyn_sparse_kernel of
// fastvideo_tpu/ops/nabla.py (:60) in both of its uses:
//   * K9a, entry fvt_dyn_sparse_fwd: NABLA's masked_block_sparse_attention
//     (nabla.py:134, call :188); a query tile is a whole key tile (E rows);
//   * K9b, entry fvt_dyn_sparse_qtile_fwd: BSA's _masked_sparse_qtile
//     (fastvideo_tpu/ops/bsa.py:91, call :137); a query tile is the q_rows
//     pruned queries of one key tile (a multiple of 8, at most 64).
// One kernel body; the two entries are two instances (the kQTile flag), so
// the profiler and the launch counters list them apart.
//
// q is [B, H, nQ * rows, D], k/v [B, H, nB * E, D] in tile-major order
// (strided; the last dim contiguous). Query tile qi attends the key tiles
// indices[b, h, qi, 0 .. counts[b, h, qi] - 1] (ascending; the slots past
// the count hold -1). The loop runs exactly counts[b, h, qi] times: unlike
// the fixed top-k of K2 / K7 / K8, each query tile has its own trip count,
// and no slot past it is read. Keys at or past block_sizes[tile] get no
// weight. Online softmax in fp32, P rounded to bf16 before P@V (the Pallas
// kernel's p.astype(v.dtype)); a row with no key (count 0) stores 0, as the
// Pallas kernel's l_inv does.
//
// What bounds it: 4*D FLOP per (query row, kept key) pair, against bf16
// reads of q, o and the gathered key tiles; at NABLA's thresholds most
// pairs are kept, so it is tensor-core bound. Two schedules, chosen by the
// head alone (fvt_dyn_sparse_fwd_sm90_route says which; the kernels take
// bf16 only; no fallback between them):
//  - a head of 64 or 128, every DiT launch: dyn_sparse_fwd_sm90.cuh, K1's
//    Hopper forward on a list walk; a block's 128 query rows hold a group
//    of query tiles that walk the union of their lists (built in the
//    caller), each row masking the key tiles its own tile does not keep, so
//    K9b's 32-row tiles fill the 64-row products. The first schedule lost
//    its time in WMMA round trips through shared memory and synchronous
//    loads, and ran a K9b tile of 32 rows in a 64-row tile of zeros.
//  - other heads (the tiny models): the padded kernel's schedule
//    (attn_tile.cuh: WMMA 16x16x16 tiles through shared memory, 4 warps on
//    64 query rows, grid (nQ * ceil(rows / 64), H, B), 128 threads); a K9b
//    tile of q_rows < 64 rows fills the rest of the 64-row tile with zeros
//    and does not store them.
// The TPU kernel's scalar-prefetched (8, 128) index blocks, its DMA double
// buffer and its row = qi % 8 have no counterpart: each block reads its own
// count and indices.
#include "attn_tile.cuh"
#include "dyn_sparse_fwd_sm90.cuh"

namespace {

using fvt::AttnTile;
using fvt::bf16;

template <typename T, int BQ, int BK, bool kQTile>
__global__ void __launch_bounds__(fvt::kThreads)
    dyn_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          const int* __restrict__ indices, const int* __restrict__ counts,
                          const int* __restrict__ block_sizes, int H, int D, int E, int rows,
                          int nq_tiles, int n_slots, int n_sub, long long q_sb, long long q_sh,
                          long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                          long long o_sh, long long o_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  AttnTile<T, BQ, BK> t;
  t.carve(smem, D);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = blockIdx.x / n_sub;
  const int sub = blockIdx.x - qi * n_sub;
  const long long row0 = static_cast<long long>(qi) * rows + sub * BQ;
  const int nq = min(BQ, rows - sub * BQ);
  const long long row_id = (static_cast<long long>(b) * H + h) * nq_tiles + qi;
  const int* idx = indices + row_id * n_slots;
  // the trip count: the same for every thread of the block, so the barrier
  // pairs below stay matched
  const int count = min(counts[row_id], n_slots);
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  t.init();
  t.load_rows(t.q, q + b * q_sb + h * q_sh + row0 * q_ss, q_ss, nq, BQ);
  __syncthreads();

  for (int j = 0; j < count; ++j) {
    const int tile = idx[j];
    if (tile < 0) continue;  // a -1 inside the count: no key tile
    const int valid = min(block_sizes[tile], E);
    const long long tile_row = static_cast<long long>(tile) * E;
    for (int c0 = 0; c0 < valid; c0 += BK) {
      const int nk = min(BK, valid - c0);
      __syncthreads();  // every warp is done with the previous chunk
      t.load_rows(t.k, kp + (tile_row + c0) * k_ss, k_ss, nk, BK);
      t.load_rows(t.v, vp + (tile_row + c0) * v_ss, v_ss, nk, BK);
      __syncthreads();
      t.scores();
      t.softmax_update(scale, [&](int, int c) { return c < nk; });
      t.accumulate_pv();
    }
  }
  t.store(o + b * o_sb + h * o_sh + row0 * o_ss, o_ss, nq, nullptr, 0.f);
}

// Whether a head of D takes the Hopper schedule (the kernels are bf16
// only). ops/sparse_schedule.py:sparse_schedule states the same rule.
bool use_sm90(int D) { return D == 64 || D == 128; }

namespace s9 = fvt::sm90;

template <int D, bool kQTile>
int launch_sm90(s9::DynFwdParams& p, long long blocks, cudaStream_t stream) {
  const size_t smem = s9::dyn_fwd_smem_bytes<D>(p.stride);
  cudaError_t err = s9::set_smem(s9::dyn_sparse_fwd_sm90<D, kQTile>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::dyn_sparse_fwd_sm90<D, kQTile>
      <<<static_cast<unsigned>(blocks), s9::kFwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The Hopper schedule over grouped union lists (see fvt_dyn_sparse_fwd_sm90).
template <bool kQTile>
int launch_grouped(const void* q, const void* k, const void* v, void* o, const void* list,
                   const void* counts, const void* bits, const void* order,
                   const void* block_sizes, int B, int H, int Sq, int Skv, int D, int E, int rows,
                   int group, const long long* st, float scale, void* stream) {
  if (!use_sm90(D) || E <= 0 || rows <= 0 || Skv % E != 0 || Sq % rows != 0 || group < 1 ||
      group > 16 || (group > 1 && group * rows > s9::kDynBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  s9::DynFwdParams p;
  const int nK = Skv / E;
  if (!s9::map_bshd(&p.q, q, B, Sq, H, D, st[0], st[1], st[2], 64) ||
      !s9::map_tiles(&p.k, k, B, H, nK, E, D, st[3], st[4], st[5]) ||
      !s9::map_tiles(&p.v, v, B, H, nK, E, D, st[6], st[7], st[8]))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = nullptr;
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_ss = st[11];
  p.list = static_cast<const int*>(list);
  p.counts = static_cast<const int*>(counts);
  p.bits = static_cast<const int*>(bits);
  p.sizes = static_cast<const int*>(block_sizes);
  p.order = static_cast<const int*>(order);
  p.H = H;
  p.Sq = Sq;
  p.E = E;
  p.rows = rows;
  p.group = group;
  p.nG = (Sq / rows + group - 1) / group;
  p.n_sub = (group * rows + s9::kDynBQ - 1) / s9::kDynBQ;
  p.stride = nK;
  p.scale_log2 = scale * s9::kLog2e;
  const long long blocks = static_cast<long long>(B) * H * p.nG * p.n_sub;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_sm90<64, kQTile>(p, blocks, s) : launch_sm90<128, kQTile>(p, blocks, s);
}

template <bool kQTile>
int launch(const void* q, const void* k, const void* v, void* o, const void* indices,
           const void* counts, const void* block_sizes, int B, int H, int Sq, int Skv, int D,
           int E, int rows, int n_slots, const long long* st, float scale, void* stream) {
  constexpr int BQ = 64, BK = 64;
  if (D % 16 != 0 || D > 128 || use_sm90(D) || E <= 0 || rows <= 0 || n_slots <= 0 ||
      Sq % rows != 0 || Skv % E != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = AttnTile<bf16, BQ, BK>::smem_bytes(D);
  cudaError_t err = fvt::set_smem(dyn_sparse_fwd_kernel<bf16, BQ, BK, kQTile>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq_tiles = Sq / rows;
  const int n_sub = (rows + BQ - 1) / BQ;
  dim3 grid(nq_tiles * n_sub, H, B);
  dyn_sparse_fwd_kernel<bf16, BQ, BK, kQTile>
      <<<grid, fvt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<bf16*>(o), static_cast<const int*>(indices), static_cast<const int*>(counts),
          static_cast<const int*>(block_sizes), H, D, E, rows, nq_tiles, n_slots, n_sub, st[0],
          st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a head of D runs the Hopper schedule (dyn_sparse_fwd_sm90.cuh and
// the entries fvt_dyn_sparse_fwd_sm90 / fvt_dyn_sparse_qtile_fwd_sm90), 0
// when it runs the first one (fvt_dyn_sparse_fwd / fvt_dyn_sparse_qtile_fwd).
extern "C" int fvt_dyn_sparse_fwd_sm90_route(int D) { return use_sm90(D) ? 1 : 0; }

// The Hopper schedule's dynamic shared memory a block (bytes), for a head
// of D (64 or 128) over nK key tiles.
extern "C" int fvt_dyn_sparse_fwd_sm90_smem(int D, int nK) {
  return static_cast<int>(D == 64 ? s9::dyn_fwd_smem_bytes<64>(nK)
                                  : s9::dyn_fwd_smem_bytes<128>(nK));
}

// K9a's Hopper schedule (a head of 64 or 128): query tiles of E rows,
// `group` of them a block (group * E <= 128, or group 1). list int32
// [B, H, nG, nK] (nG = ceil(nQ / group)): each group's union of its tiles'
// key tiles, ascending, then -1; counts int32 [B, H, nG]; bits int32
// [B, H, nG, nK]: bit t of entry j set where the group's tile t keeps it;
// order int32 [B * H * nG]: the flat (batch, head, group) of each block in
// launch order; block_sizes int32 [nK]. Strides as fvt_dyn_sparse_fwd's.
extern "C" int fvt_dyn_sparse_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                       const void* list, const void* counts, const void* bits,
                                       const void* order, const void* block_sizes, int B, int H,
                                       int Sq, int Skv, int D, int E, int group, long long q_sb,
                                       long long q_sh, long long q_ss, long long k_sb,
                                       long long k_sh, long long k_ss, long long v_sb,
                                       long long v_sh, long long v_ss, long long o_sb,
                                       long long o_sh, long long o_ss, float scale,
                                       void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch_grouped<false>(q, k, v, o, list, counts, bits, order, block_sizes, B, H, Sq, Skv,
                               D, E, E, group, st, scale, stream);
}

// K9b's Hopper schedule: as fvt_dyn_sparse_fwd_sm90 with query tiles of
// q_rows rows (a multiple of 8 up to 64).
extern "C" int fvt_dyn_sparse_qtile_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, const void* list, const void* counts,
    const void* bits, const void* order, const void* block_sizes, int B, int H, int Sq, int Skv,
    int D, int E, int q_rows, int group, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale, void* stream) {
  if (q_rows % 8 != 0 || q_rows > 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch_grouped<true>(q, k, v, o, list, counts, bits, order, block_sizes, B, H, Sq, Skv,
                              D, E, q_rows, group, st, scale, stream);
}

// The first schedule (heads other than 64 and 128). bfloat16 only, D a
// multiple of 16 up to 128. indices int32
// [B, H, nQ, n_slots] contiguous, ascending ids then -1; counts int32
// [B, H, nQ] contiguous; block_sizes int32 [nB]. q and o are
// [B, H, nQ * E, D], k and v [B, H, nB * E, D]. Strides in elements, of q,
// k, v and o in turn: batch, head, row.
extern "C" int fvt_dyn_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                  const void* indices, const void* counts,
                                  const void* block_sizes, int B, int H, int Sq, int Skv, int D,
                                  int E, int n_slots, long long q_sb, long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                                  long long o_ss, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch<false>(q, k, v, o, indices, counts, block_sizes, B, H, Sq, Skv, D, E, E,
                       n_slots, st, scale, stream);
}

// The first schedule's K9b: the same with a query tile of q_rows rows (a
// multiple of 8 up to 64):
// q and o are [B, H, nQ * q_rows, D], k and v [B, H, nB * E, D].
extern "C" int fvt_dyn_sparse_qtile_fwd(const void* q, const void* k, const void* v, void* o,
                                        const void* indices, const void* counts,
                                        const void* block_sizes, int B, int H, int Sq, int Skv,
                                        int D, int E, int q_rows, int n_slots, long long q_sb,
                                        long long q_sh, long long q_ss, long long k_sb,
                                        long long k_sh, long long k_ss, long long v_sb,
                                        long long v_sh, long long v_ss, long long o_sb,
                                        long long o_sh, long long o_ss, float scale,
                                        void* stream) {
  if (q_rows % 8 != 0 || q_rows > 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch<true>(q, k, v, o, indices, counts, block_sizes, B, H, Sq, Skv, D, E, q_rows,
                      n_slots, st, scale, stream);
}

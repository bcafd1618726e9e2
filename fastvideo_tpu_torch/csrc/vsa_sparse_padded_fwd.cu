// Block-sparse attention forward over PADDED tiles for Hopper (sm_90a).
//
// Replaces two Pallas kernels of fastvideo_tpu/ops/vsa.py that compute the
// same function: _sparse_fwd_lse_kernel (K7 fwd, reached through
// block_sparse_attention_trainable; output and log-sum-exp) and
// _sparse_kernel (K8, reached through block_sparse_attention; output only,
// serving STA and SLA). One function: a null lse pointer is the second.
//
// q/k/v are [B, H, nB*E, D] in tile-major token order; tile t holds
// block_sizes[t] real tokens followed by padding. indices[b, h, qi, :] lists
// the K key tiles that query tile qi attends; -1 marks an unused slot.
//   * a sentinel slot contributes nothing and no tile is read for it;
//   * keys at or past block_sizes[tile] get no weight;
//   * padded QUERY rows are computed like any row (the caller drops them).
// Masked scores are -inf, so a query row whose every slot is masked keeps
// l == 0 and stores 0 with an LSE of kEmptyLse. The Pallas kernels mask with
// the finite -0.7 * FLT_MAX instead, which gives such a row an average over
// tile 0; no caller produces such a row (an STA window holds the query's own
// tile, top-k picks real tiles, every tile has a token), and wherever a row
// sees at least one real key the two maskings agree.
//
// What bounds it: 4*D FLOP per (query row, valid key) pair against bf16
// reads of S*D*3 plus the gathered tiles, so it is tensor-core bound (at
// the 480x848 VSA shape: S=43008, K=34, E=256, D=128). Two schedules,
// chosen by the head alone (padded_route; ops/sparse_schedule.py:
// sparse_schedule states the same rule; the kernels take bf16 only; no
// fallback between them):
//  - a head of 64 or 128, every DiT launch: K9's Hopper forward
//    (dyn_sparse_fwd_sm90.cuh: wgmma, softmax on the register fragment, a
//    TMA ring over a 5-D tile-major map that reads zeros past a tile's E
//    rows) on each query tile's own top-k row, walked as it is (a -1 slot
//    has no valid row and is skipped); the caller launches the longest
//    rows first. Tiles of more than 64 rows (E 256, 280) run two
//    warpgroups a 128-row block (a tile of 280 rows is three blocks, the
//    third with one live warpgroup); tiles of 64 rows (SLA) one warpgroup
//    a block over 64-key chunks, so that no tile walks a neighbour's list.
//    Tiles of fewer rows (the tiny models) group as many as fill 64 rows
//    over the union of their lists (ops/sparse_schedule.py:grouped_lists,
//    padded_walk). Whole 64-row units are read; the keys past a
//    tile's valid count are masked and their V rows zeroed in shared
//    memory, so those slots may hold anything, as the contract says.
//  - other heads (the tiny models): the first schedule, kept from the
//    port's first slice: each block owns 64 query rows of one query tile,
//    reads that tile's K indices itself (the TPU's scalar prefetch) and
//    gathers each selected tile from row idx*E in chunks of 64 rows through
//    attn_tile.cuh (WMMA through shared memory), stopping at the tile's
//    valid count. Grid: (nQ * ceil(E / 64), H, B), 128 threads.
// The TPU kernels' (8, 128)-aligned index blocks, DMA rings and [.., 128]
// LSE lanes have no counterpart here.
#include "attn_tile.cuh"
#include "dyn_sparse_fwd_sm90.cuh"

namespace {

using fvt::AttnTile;
using fvt::bf16;

using fvt::sm90::kEmptyLse;

// Whether a head of D takes the Hopper schedule (the kernels are bf16
// only). ops/sparse_schedule.py:sparse_schedule states the same rule.
bool use_sm90(int D) { return D == 64 || D == 128; }

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(fvt::kThreads)
    vsa_sparse_padded_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ o,
                                 float* __restrict__ lse, const int* __restrict__ indices,
                                 const int* __restrict__ block_sizes, int H, int S, int D, int E,
                                 int nq_tiles, int topk, int n_sub, long long q_sb,
                                 long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                 long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                 long long o_sb, long long o_sh, long long o_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  AttnTile<T, BQ, BK> t;
  t.carve(smem, D);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = blockIdx.x / n_sub;
  const int sub = blockIdx.x - qi * n_sub;
  const long long row0 = static_cast<long long>(qi) * E + sub * BQ;
  const int nq = min(BQ, E - sub * BQ);
  const long long bh = static_cast<long long>(b) * H + h;
  const int* idx = indices + (bh * nq_tiles + qi) * topk;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  t.init();
  t.load_rows(t.q, q + b * q_sb + h * q_sh + row0 * q_ss, q_ss, nq, BQ);
  __syncthreads();

  // idx[j] and block_sizes are the same for every thread of the block, so
  // the skips below are uniform and the barrier pairs stay matched
  for (int j = 0; j < topk; ++j) {
    const int tile = idx[j];
    if (tile < 0) continue;
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
  t.store(o + b * o_sb + h * o_sh + row0 * o_ss, o_ss, nq,
          lse == nullptr ? nullptr : lse + bh * S + row0, kEmptyLse);
}

template <typename T, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const int* indices,
           const int* block_sizes, int B, int H, int S, int D, int E, int topk,
           const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = AttnTile<T, BQ, BK>::smem_bytes(D);
  cudaError_t err = fvt::set_smem(vsa_sparse_padded_fwd_kernel<T, BQ, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq_tiles = S / E;
  const int n_sub = (E + BQ - 1) / BQ;
  dim3 grid(nq_tiles * n_sub, H, B);
  vsa_sparse_padded_fwd_kernel<T, BQ, BK><<<grid, fvt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, indices, block_sizes, H, S, D, E, nq_tiles, topk, n_sub, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

namespace s9 = fvt::sm90;

template <int D, int kWGs>
int launch_sm90(s9::DynFwdParams& p, long long blocks, cudaStream_t stream) {
  const size_t smem = s9::dyn_fwd_smem_bytes<D, kWGs>(p.stride);
  cudaError_t err = s9::set_smem(s9::vsa_sparse_padded_fwd_sm90<D, kWGs>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::vsa_sparse_padded_fwd_sm90<D, kWGs>
      <<<static_cast<unsigned>(blocks), kWGs * s9::kWarpgroup, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a head of D runs the Hopper schedule (fvt_vsa_sparse_padded_fwd_sm90),
// 0 when it runs the first one (fvt_vsa_sparse_padded_fwd).
extern "C" int fvt_vsa_sparse_padded_fwd_route(int D) { return use_sm90(D) ? 1 : 0; }

// The Hopper schedule's dynamic shared memory a block (bytes), for a head
// of D (64 or 128), wgs warpgroups a block, list rows of `stride` entries.
extern "C" int fvt_vsa_sparse_padded_fwd_sm90_smem(int D, int wgs, int stride) {
  if (D == 64)
    return static_cast<int>(wgs == 1 ? s9::dyn_fwd_smem_bytes<64, 1>(stride)
                                     : s9::dyn_fwd_smem_bytes<64, 2>(stride));
  return static_cast<int>(wgs == 1 ? s9::dyn_fwd_smem_bytes<128, 1>(stride)
                                   : s9::dyn_fwd_smem_bytes<128, 2>(stride));
}

// The Hopper schedule (a head of 64 or 128). S = nB * E rows. list int32
// [B, H, nG, stride], one row a group of `group` query tiles. group 1:
// the indices as they are (stride = topk; -1 slots are skipped), counts
// and bits null. group > 1: the group's ascending union of its tiles' key
// tiles, then -1 (stride = nB), counts int32 [B, H, nG] and bits int32
// [B, H, nG, nB] (bit t set where the group's tile t keeps the entry).
// order int32 [B * H * nG]: flat (batch, head, group) in launch order;
// block_sizes int32 [nB]; lse fp32 [B, H, S] contiguous, or null. wgs
// warpgroups a block: 1 (64 rows, 64-key chunks) where group * E <= 64,
// else 2 (128 rows, group 1). Strides in elements, of q, k, v and o in
// turn: batch, head, row.
extern "C" int fvt_vsa_sparse_padded_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* list,
    const void* counts, const void* bits, const void* order, const void* block_sizes, int B, int H,
    int S, int D, int E, int group, int wgs, int stride, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, float scale, void* stream) {
  if (!use_sm90(D) || E <= 0 || S % E != 0 || group < 1 || group > 16 || stride <= 0 ||
      (wgs != 1 && wgs != 2) || (wgs == 2 && group != 1) || (wgs == 1 && group * E > 64) ||
      (group > 1 && (counts == nullptr || bits == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  s9::DynFwdParams p;
  const int nB = S / E;
  if (!s9::map_bshd(&p.q, q, B, S, H, D, q_sb, q_sh, q_ss, 64) ||
      !s9::map_tiles(&p.k, k, B, H, nB, E, D, k_sb, k_sh, k_ss) ||
      !s9::map_tiles(&p.v, v, B, H, nB, E, D, v_sb, v_sh, v_ss))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.list = static_cast<const int*>(list);
  p.counts = static_cast<const int*>(counts);
  p.bits = static_cast<const int*>(bits);
  p.sizes = static_cast<const int*>(block_sizes);
  p.order = static_cast<const int*>(order);
  p.H = H;
  p.Sq = S;
  p.E = E;
  p.rows = E;
  p.group = group;
  p.nG = (nB + group - 1) / group;
  p.n_sub = (group * E + 64 * wgs - 1) / (64 * wgs);
  p.stride = stride;
  p.scale_log2 = scale * s9::kLog2e;
  const long long blocks = static_cast<long long>(B) * H * p.nG * p.n_sub;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return wgs == 1 ? launch_sm90<64, 1>(p, blocks, s) : launch_sm90<64, 2>(p, blocks, s);
  return wgs == 1 ? launch_sm90<128, 1>(p, blocks, s) : launch_sm90<128, 2>(p, blocks, s);
}

// The first schedule (heads other than 64 and 128). bfloat16 only, D a
// multiple of 16 up to 128. S = nB * E rows; indices int32
// [B, H, nB, topk] contiguous with -1 sentinels; block_sizes int32 [nB];
// lse fp32 [B, H, S] contiguous, or null.
extern "C" int fvt_vsa_sparse_padded_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, const void* indices,
                                         const void* block_sizes, int B, int H, int S, int D,
                                         int E, int topk, long long q_sb, long long q_sh,
                                         long long q_ss, long long k_sb, long long k_sh,
                                         long long k_ss, long long v_sb, long long v_sh,
                                         long long v_ss, long long o_sb, long long o_sh,
                                         long long o_ss, float scale, void* stream) {
  if (D % 16 != 0 || D > 128 || use_sm90(D) || E <= 0 || topk <= 0 || S % E != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch<bf16, 64, 64>(q, k, v, o, static_cast<float*>(lse),
                              static_cast<const int*>(indices),
                              static_cast<const int*>(block_sizes), B, H, S, D, E, topk, st,
                              scale, static_cast<cudaStream_t>(stream));
}

// Block-sparse attention forward over PADDED tiles for Hopper (sm_90a).
//
// Replaces two Pallas kernels of fastvideo_tpu/ops/vsa.py that compute the
// same function: _sparse_fwd_lse_kernel (reached through
// block_sparse_attention_trainable; output and log-sum-exp) and
// _sparse_kernel (reached through block_sparse_attention; output only,
// serving STA and SLA). One entry point: a null lse pointer is the second.
//
// q/k/v are [B, H, nB*E, D] in tile-major token order; tile t holds
// block_sizes[t] real tokens followed by padding. indices[b, h, qi, :] lists
// the K key tiles that query tile qi attends; -1 marks an unused slot.
//   * a sentinel slot contributes nothing and no tile is read for it;
//   * keys at or past block_sizes[tile] get no weight and are not read;
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
// the 480x848 VSA shape: S=43008, K=34, E=256, D=128). Each block owns BQ
// query rows of one query tile, reads that tile's K indices itself (the
// TPU's scalar prefetch) and gathers each selected tile from row idx*E in
// chunks of BK rows, stopping at the tile's valid count. The TPU kernels'
// (8, 128)-aligned index blocks, DMA rings and [.., 128] LSE lanes have no
// counterpart here.
//
// Grid: (nQ * ceil(E / BQ), H, B), 128 threads.
#include "attn_tile.cuh"

namespace {

using fvt::AttnTile;
using fvt::bf16;

// the LSE of a row with no valid key: the Pallas kernels' MASK_VALUE
constexpr float kEmptyLse = -0.7f * 3.4028234663852886e38f;

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

}  // namespace

// bfloat16 only, D a multiple of 16 up to 128. S = nB * E rows; indices int32
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
  if (D % 16 != 0 || D > 128 || E <= 0 || topk <= 0 || S % E != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch<bf16, 64, 64>(q, k, v, o, static_cast<float*>(lse),
                              static_cast<const int*>(indices),
                              static_cast<const int*>(block_sizes), B, H, S, D, E, topk, st,
                              scale, static_cast<cudaStream_t>(stream));
}

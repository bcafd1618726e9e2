// Video Sparse Attention (VSA) block-sparse forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel fastvideo_tpu/ops/vsa.py:_sparse_fast_kernel
// (reached through block_sparse_attention_fast). q/k/v are [B, H, nB*E, D]
// in tile-major token order with full tiles of E tokens. A query group is
// G = nB / nG consecutive tiles (G*E rows) that share one top-k set:
// indices[b, h, g, :] lists the K key tiles group g attends. Each query row
// sees exactly K*E keys, so no row is empty.
//
// What bounds it: 4*B*H*S*K*E*D FLOP (1.35e12 per launch at the 480p main
// path: S=32760, K=24, E=280, D=128) against S*D*(3 + K/G) bf16 reads, so it
// is tensor-core bound. The design gives each block BQ query rows of one
// group; the block reads its own K indices and gathers each selected key
// tile at row idx*E in chunks of BK rows. E=280 is not a multiple of BK, so
// the ragged last chunk of each tile is masked inside the kernel (rows past
// E are zero-filled and their scores are -inf) rather than padding the
// tensors. The Pallas kernel's unroll and duplicate-index padding exist for
// Mosaic's grid-step cost and have no counterpart here.
//
// Grid: (nG * ceil(G*E / BQ), H, B), 128 threads.
#include "attn_tile.cuh"

namespace {

using fvt::AttnTile;
using fvt::bf16;

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(fvt::kThreads)
    vsa_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          const int* __restrict__ indices, int H, int D, int E, int ng,
                          int topk, int group_rows, int n_sub, long long q_sb, long long q_sh,
                          long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                          long long o_sh, long long o_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  AttnTile<T, BQ, BK> t;
  t.carve(smem, D);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int g = blockIdx.x / n_sub;
  const int sub = blockIdx.x - g * n_sub;
  const int row0 = g * group_rows + sub * BQ;
  const int nq = min(BQ, (g + 1) * group_rows - row0);
  const int* idx = indices + ((static_cast<long long>(b) * H + h) * ng + g) * topk;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  t.init();
  t.load_rows(t.q, q + b * q_sb + h * q_sh + row0 * q_ss, q_ss, nq, BQ);
  __syncthreads();

  for (int j = 0; j < topk; ++j) {
    const long long tile_row = static_cast<long long>(idx[j]) * E;
    for (int c0 = 0; c0 < E; c0 += BK) {
      const int nk = min(BK, E - c0);
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

template <typename T, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, const int* indices, int B,
           int H, int S, int D, int E, int ng, int topk, const long long* st, float scale,
           cudaStream_t stream) {
  const size_t smem = AttnTile<T, BQ, BK>::smem_bytes(D);
  cudaError_t err = fvt::set_smem(vsa_sparse_fwd_kernel<T, BQ, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group_rows = S / ng;
  const int n_sub = (group_rows + BQ - 1) / BQ;
  dim3 grid(ng * n_sub, H, B);
  vsa_sparse_fwd_kernel<T, BQ, BK><<<grid, fvt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), indices, H, D, E, ng, topk, group_rows, n_sub, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 only, D a multiple of 16 up to 128 (the main path's D is 128).
// S = nB * E rows, ng divides nB; indices int32 [B, H, ng, topk], contiguous.
extern "C" int fvt_vsa_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                  const void* indices, int B, int H, int S, int D, int E,
                                  int ng, int topk, long long q_sb, long long q_sh,
                                  long long q_ss, long long k_sb, long long k_sh,
                                  long long k_ss, long long v_sb, long long v_sh,
                                  long long v_ss, long long o_sb, long long o_sh,
                                  long long o_ss, float scale, void* stream) {
  if (D % 16 != 0 || D > 128 || E <= 0 || ng <= 0 || topk <= 0 || S % E != 0 ||
      (S / E) % ng != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch<bf16, 64, 64>(q, k, v, o, static_cast<const int*>(indices), B, H, S, D, E, ng,
                              topk, st, scale, static_cast<cudaStream_t>(stream));
}

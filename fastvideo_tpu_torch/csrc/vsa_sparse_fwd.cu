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
// is tensor-core bound. Two schedules, chosen by the head alone (use_sm90;
// ops/sparse_schedule.py:sparse_schedule states the same rule; bf16 only;
// no fallback between them):
//  - a head of 64 or 128, every DiT launch: the list-walk forward of K8
//    and K9 (dyn_sparse_fwd_sm90.cuh: wgmma, the online softmax on the
//    register fragment, P as the register A operand of P V, a TMA ring of
//    128-key chunks; instances vsa_sparse_fwd_sm90<D, stream>) on each
//    group's top-k row, with the two cuts K2's full tiles allow. Rows: a
//    block's 128 rows tile the group's G E rows back to back (840 rows: 7
//    blocks, 896 row slots; K8's per-tile blocks would take 1,152). Keys:
//    where E % 8 == 0 (stream_walk; ops/sparse_schedule.py:fast_key_walk)
//    the group's K tiles are walked as one stream of K E keys in 64-key
//    units, each a {64, 64} box inside one tile or eight {64, 8} boxes
//    across a tile's end, so 6,720 keys are 105 units and only the last is
//    ragged (K8's walk of a 280-row tile in 64-row units reads 320 rows);
//    other E walk each tile in 64-row units of a 5-D tile map that reads
//    zeros past E, as K8 does. All lists have K valid slots, so the blocks
//    run in order and need no bit sets.
//  - other heads (the tiny models): the first schedule, kept from the
//    port's first slice: each block owns BQ query rows of one group, reads
//    its own K indices and gathers each selected key tile at row idx*E in
//    chunks of BK rows through attn_tile.cuh (WMMA through shared memory);
//    the ragged last chunk of each tile is masked inside the kernel. Grid:
//    (nG * ceil(G*E / BQ), H, B), 128 threads.
// The Pallas kernel's unroll and duplicate-index padding exist for Mosaic's
// grid-step cost and have no counterpart here.
#include "attn_tile.cuh"
#include "dyn_sparse_fwd_sm90.cuh"

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

// Whether a head of D takes the Hopper schedule (the kernels are bf16
// only). ops/sparse_schedule.py:sparse_schedule states the same rule.
bool use_sm90(int D) { return D == 64 || D == 128; }

// Whether the Hopper schedule walks the keys as one stream (else per
// tile): a tile's rows split into 8-row boxes. ops/sparse_schedule.py:
// fast_key_walk states the same rule.
bool stream_walk(int E) { return E % 8 == 0; }

}  // namespace

namespace fvt {
namespace sm90 {

// Threads a block of K2's Hopper instances: two consumer warpgroups, and a
// producer warpgroup for the key stream.
template <bool kStream>
constexpr int fast_threads() {
  return kFwdThreads + (kStream ? kWarpgroup : 0);
}

// K2's Hopper instances: kStream walks the keys as one stream, else per tile.
template <int D, bool kStream>
__global__ void __launch_bounds__(fast_threads<kStream>(), 1)
    vsa_sparse_fwd_sm90(const __grid_constant__ DynFwdParams p) {
  dyn_fwd_body<D, 2, kStream>(p);
}

}  // namespace sm90
}  // namespace fvt

namespace {

namespace s9 = fvt::sm90;

template <int D, bool kStream>
int launch_sm90(s9::DynFwdParams& p, long long blocks, cudaStream_t stream) {
  const size_t smem = s9::dyn_fwd_smem_bytes<D, 2>(p.stride);
  cudaError_t err = s9::set_smem(s9::vsa_sparse_fwd_sm90<D, kStream>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::vsa_sparse_fwd_sm90<D, kStream>
      <<<static_cast<unsigned>(blocks), s9::fast_threads<kStream>(), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a head of D runs the Hopper schedule (fvt_vsa_sparse_fwd_sm90), 0
// when it runs the first one (fvt_vsa_sparse_fwd).
extern "C" int fvt_vsa_sparse_fwd_route(int D) { return use_sm90(D) ? 1 : 0; }

// The Hopper schedule's key walk for tiles of E rows: 1 the stream, 0 per
// tile.
extern "C" int fvt_vsa_sparse_fwd_walk(int E) { return stream_walk(E) ? 1 : 0; }

// The Hopper schedule's dynamic shared memory a block (bytes), for a head
// of D (64 or 128) and top-k lists of topk tiles.
extern "C" int fvt_vsa_sparse_fwd_sm90_smem(int D, int topk) {
  return static_cast<int>(D == 64 ? s9::dyn_fwd_smem_bytes<64, 2>(topk)
                                  : s9::dyn_fwd_smem_bytes<128, 2>(topk));
}

// The Hopper schedule (a head of 64 or 128). S = nB * E rows, ng divides
// nB; indices int32 [B, H, ng, topk] contiguous, every slot a tile id.
// walk: 1 the key stream (E % 8 == 0), 0 per tile (any E). Strides in
// elements, of q, k, v and o in turn: batch, head, row.
extern "C" int fvt_vsa_sparse_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                       const void* indices, int B, int H, int S, int D, int E,
                                       int ng, int topk, int walk, long long q_sb,
                                       long long q_sh, long long q_ss, long long k_sb,
                                       long long k_sh, long long k_ss, long long v_sb,
                                       long long v_sh, long long v_ss, long long o_sb,
                                       long long o_sh, long long o_ss, float scale,
                                       void* stream) {
  if (!use_sm90(D) || E <= 0 || ng <= 0 || topk <= 0 || S % E != 0 || (S / E) % ng != 0 ||
      (walk != 0 && walk != 1) || (walk == 1 && !stream_walk(E)))
    return static_cast<int>(cudaErrorInvalidValue);
  s9::DynFwdParams p;
  const int nB = S / E;
  const bool ok =
      s9::map_bshd(&p.q, q, B, S, H, D, q_sb, q_sh, q_ss, 64) &&
      (walk == 1 ? s9::map_bshd(&p.k, k, B, S, H, D, k_sb, k_sh, k_ss, s9::kUnit) &&
                       s9::map_bshd(&p.v, v, B, S, H, D, v_sb, v_sh, v_ss, s9::kUnit) &&
                       s9::map_bshd(&p.k8, k, B, S, H, D, k_sb, k_sh, k_ss, 8) &&
                       s9::map_bshd(&p.v8, v, B, S, H, D, v_sb, v_sh, v_ss, 8)
                 : s9::map_tiles(&p.k, k, B, H, nB, E, D, k_sb, k_sh, k_ss) &&
                       s9::map_tiles(&p.v, v, B, H, nB, E, D, v_sb, v_sh, v_ss));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = nullptr;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.list = static_cast<const int*>(indices);
  p.counts = nullptr;
  p.bits = nullptr;
  p.sizes = nullptr;
  p.order = nullptr;
  p.H = H;
  p.Sq = S;
  p.E = E;
  p.rows = (nB / ng) * E;  // a group's rows, tiled by the blocks back to back
  p.group = 1;
  p.nG = ng;
  p.n_sub = (p.rows + s9::kDynBQ - 1) / s9::kDynBQ;
  p.stride = topk;
  p.scale_log2 = scale * s9::kLog2e;
  const long long blocks = static_cast<long long>(B) * H * ng * p.n_sub;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return walk == 1 ? launch_sm90<64, true>(p, blocks, s) : launch_sm90<64, false>(p, blocks, s);
  return walk == 1 ? launch_sm90<128, true>(p, blocks, s)
                   : launch_sm90<128, false>(p, blocks, s);
}

// The first schedule (heads other than 64 and 128). bfloat16 only, D a
// multiple of 16 up to 128. S = nB * E rows, ng divides nB; indices int32
// [B, H, ng, topk], contiguous.
extern "C" int fvt_vsa_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                  const void* indices, int B, int H, int S, int D, int E,
                                  int ng, int topk, long long q_sb, long long q_sh,
                                  long long q_ss, long long k_sb, long long k_sh,
                                  long long k_ss, long long v_sb, long long v_sh,
                                  long long v_ss, long long o_sb, long long o_sh,
                                  long long o_ss, float scale, void* stream) {
  if (D % 16 != 0 || D > 128 || use_sm90(D) || E <= 0 || ng <= 0 || topk <= 0 || S % E != 0 ||
      (S / E) % ng != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch<bf16, 64, 64>(q, k, v, o, static_cast<const int*>(indices), B, H, S, D, E, ng,
                              topk, st, scale, static_cast<cudaStream_t>(stream));
}

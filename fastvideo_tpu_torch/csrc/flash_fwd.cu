// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel fastvideo_tpu/ops/flash_attention.py:_fwd_kernel
// (:93, reached through _flash_attention_fwd_bhsd, call :222). Computes
// softmax(Q K^T * scale) V over [B, H, S, D] tensors with an online softmax,
// emitting O and the per-row log-sum-exp in fp32. Masks: keys at index >=
// kv_valid, and causal (key <= query). Key tiles that no row of the query
// tile can reach are skipped, as the Pallas kernel's _tile_reachable does.
//
// K5 is the same kernel with a per-key mask (fvt_flash_fwd_kv_mask): it
// replaces _fwd_kernel with has_kv_mask, reached through
// flash_attention_kv_mask (:539), the streaming KV-cache attention of the
// causal Wan. kv_mask [Skv] holds one byte a key, shared by every batch row
// and head; key j is visible when kv_mask[j] != 0 (and j < kv_valid). A key
// chunk whose mask is all zero is skipped: it would add exactly nothing,
// since masked scores are -inf. Early in a stream most of the window is
// empty (at the first block of the 1.3B stream, 28,080 of 32,760 keys), so
// the skip saves those chunks' loads and products.
//
// K1 struct is the same kernel with the causal Wan training forward's
// chunk-causal and teacher-forcing masks (fvt_flash_fwd_struct): it replaces
// _fwd_kernel with chunk_tokens > 0 or tf_clean_len > 0 (_mask_tile and
// _tile_reachable, :39-90), reached through flash_attention(chunk_tokens=,
// tf_clean_len=) from models/dits/causal_wan.py:_masked_block_forward.
// struct_mask.cuh has the rule. Each query tile computes the key ranges of
// its rows and loops their union, at most two ranges (for a noisy tile the
// clean keys of earlier chunks, then its own noisy chunk: the masked keys
// between them are skipped, which JAX's upper bound visits). At 480x832 the
// mask keeps 28/49 of the pairs, so the work is that share of the dense
// product.
//
// What bounds it: at the main path's shapes it is tensor-core bound, 4 * B *
// H * Sq * Skv_visible * D FLOP against ~3 bytes of unique input per FLOP
// at the DiT cross-attention [1,32760,12,128] x [1,512,12,128], and far
// less at the self-attention shapes of K5 and K1 struct (32,760 keys). Three
// schedules, chosen by shape alone (fvt_flash_fwd_sm90 says which; there is
// no fallback between them):
//  - bf16 with a head of 64 or 128, every DiT launch: flash_fwd_sm90.cuh,
//    wgmma products with the scores, the softmax and O in registers, TMA
//    copies through a two-stage ring, two warpgroups a block. The first
//    schedule lost its time in shared-memory round trips of S, P and O,
//    in one-row-at-a-time softmax rounds, and in synchronous loads.
//  - K1 at bf16 with a head of 384, the VAE's mid-block attention:
//    flash_fwd_wide_sm90.cuh, the same products with O split over two
//    warpgroups' registers and the keys over blocks (fvt_flash_fwd_wide,
//    which also launches flash_fwd_combine, the merge of the splits).
//  - K1 at fp32 with a head of 384, the VAE attention of an fp32 decode:
//    flash_fwd_wide_tf32_sm90.cuh, 3xTF32 wgmma products on K and V^T
//    split into TF32 heads and tails by a pre-pass (fvt_flash_tf32_split,
//    then fvt_flash_fwd_wide_tf32 and, where it splits the keys,
//    fvt_flash_fwd_combine_f32). fvt_flash_fwd refuses this case.
//  - K1 at heads of 640 and 1024 (the Wan2.2 VAE's attention) is
//    flash_fwd_cols.cu's, a source of its own: this one refuses them.
//  - fp32 at other heads, bf16 K1 with other heads (the tiny models' 16
//    and 32), and K5 and K1 struct at heads other than 64 and 128:
//    attn_tile.cuh's schedule, WMMA 16x16x16 (bf16) or scalar FMA (fp32)
//    through shared memory, one 64-row (fp32: 32-row) tile a block.
//
// Strides are in elements and let the caller pass [B, S, H, D] views
// without a transpose copy.
#include "attn_tile.cuh"
#include "flash_fwd_sm90.cuh"
#include "flash_fwd_wide_sm90.cuh"
#include "flash_fwd_wide_tf32_sm90.cuh"
#include "struct_mask.cuh"

namespace {

using fvt::AttnTile;
using fvt::bf16;
using fvt::kKvMask;
using fvt::kPlain;
using fvt::kStruct;
namespace s9w = fvt::sm90;

// The mask mode is a compile-time parameter: K1's instance (kPlain) has no
// mask code beyond kv_valid and causal, and K5's (kKvMask) and K1 struct's
// (kStruct) are kernels of their own, so a profiler names the three apart.
// K5 always runs with causal = 0; K1 struct ignores causal, as the Pallas
// kernel does when chunk_tokens > 0.

template <typename T, int BQ, int BK, int kMode>
__global__ void __launch_bounds__(fvt::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv, int D,
                     long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                     long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                     float scale, int causal, int kv_valid,
                     const unsigned char* __restrict__ kv_mask, int chunk_tokens,
                     int tf_clean_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned char mask_chunk[kMode == kKvMask ? BK : 1];
  // K1 struct: the key ranges [0, a) and [b, c) each row sees
  __shared__ int span[kMode == kStruct ? 3 * BQ : 1];
  AttnTile<T, BQ, BK> t;
  t.carve(smem, D);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Sq - q0);
  const T* qp = q + b * q_sb + h * q_sh + q0 * q_ss;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  t.init();
  t.load_rows(t.q, qp, q_ss, nq, BQ);
  __syncthreads();

  // one key chunk of nk keys from j0 into the online softmax
  auto step = [&](int j0, int nk, auto valid) {
    t.load_rows(t.k, kp + j0 * k_ss, k_ss, nk, BK);
    t.load_rows(t.v, vp + j0 * v_ss, v_ss, nk, BK);
    __syncthreads();
    t.scores();
    t.softmax_update(scale, valid);
    t.accumulate_pv();
  };

  // keys past kv_end are masked for every row of this tile
  int kv_end = min(kv_valid, Skv);
  if constexpr (kMode == kStruct) {
    int* sa = span;
    int* sb = span + BQ;
    int* sc = span + 2 * BQ;
    for (int r = threadIdx.x; r < BQ; r += fvt::kThreads) {
      int a = 0, b0 = 0, c = 0;
      if (r < nq) fvt::struct_row_keys(q0 + r, chunk_tokens, tf_clean_len, kv_end, a, b0, c);
      sa[r] = a;
      sb[r] = b0;
      sc[r] = c;
    }
    __syncthreads();
    const fvt::Ranges keys = fvt::struct_tile_keys(sa, sb, sc, nq);
    for (int i = 0; i < keys.n; ++i) {
      for (int j0 = keys.lo[i]; j0 < keys.hi[i]; j0 += BK) {
        const int nk = min(BK, keys.hi[i] - j0);
        __syncthreads();  // every warp is done with the previous chunk
        step(j0, nk, [&](int r, int c) {
          const int col = j0 + c;
          return c < nk && (col < sa[r] || (col >= sb[r] && col < sc[r]));
        });
      }
    }
  } else {
    if (causal) kv_end = min(kv_end, q0 + BQ);
    for (int j0 = 0; j0 < kv_end; j0 += BK) {
      const int nk = min(BK, Skv - j0);
      __syncthreads();  // every warp is done with the previous chunk
      if constexpr (kMode == kKvMask) {
        int any = 0;
        for (int c = threadIdx.x; c < BK; c += fvt::kThreads) {
          const unsigned char m = c < nk ? kv_mask[j0 + c] : 0;
          mask_chunk[c] = m;
          any |= m;
        }
        if (!__syncthreads_or(any)) continue;  // block-uniform: nothing visible
      }
      step(j0, nk, [&](int r, int c) {
        const int col = j0 + c;
        if constexpr (kMode == kKvMask)
          return col < kv_end && mask_chunk[c] != 0;
        else
          return col < kv_end && (!causal || col <= q0 + r);
      });
    }
  }
  float* lse_row = lse == nullptr ? nullptr : lse + (static_cast<long long>(b) * H + h) * Sq + q0;
  t.store(o + b * o_sb + h * o_sh + q0 * o_ss, o_ss, nq, lse_row, -CUDART_INF_F);
}

// The mask arguments of one launch: causal and kv_valid (every mode), the
// K5 key mask, the K1 struct chunk geometry.
struct MaskArgs {
  int causal, kv_valid;
  const unsigned char* kv_mask;
  int chunk_tokens, tf_clean_len;
};

template <typename T, int BQ, int BK, int kMode>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
           int Sq, int Skv, int D, const long long* st, float scale, const MaskArgs& m,
           cudaStream_t stream) {
  const size_t smem = AttnTile<T, BQ, BK>::smem_bytes(D);
  cudaError_t err = fvt::set_smem(flash_fwd_kernel<T, BQ, BK, kMode>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, BQ, BK, kMode><<<grid, fvt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Skv, D, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, m.causal, m.kv_valid,
      m.kv_mask, m.chunk_tokens, m.tf_clean_len);
  return static_cast<int>(cudaGetLastError());
}

// The Hopper schedule's instance for a head of D.
template <int D, int kMode>
int launch_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                int Sq, int Skv, const long long* st, float scale, const MaskArgs& m,
                cudaStream_t stream) {
  namespace s9 = fvt::sm90;
  s9::FwdParams p;
  if (!s9::map_bshd(&p.q, q, B, Sq, H, D, st[0], st[1], st[2], s9::kFwdBQ) ||
      !s9::map_bshd(&p.k, k, B, Skv, H, D, st[3], st[4], st[5], s9::kFwdBK) ||
      !s9::map_bshd(&p.v, v, B, Skv, H, D, st[6], st[7], st[8], s9::kFwdBK))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_ss = st[11];
  p.kv_mask = m.kv_mask;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.n_qtiles = (Sq + s9::kFwdBQ - 1) / s9::kFwdBQ;
  p.scale_log2 = scale * s9::kLog2e;
  p.causal = m.causal;
  p.kv_valid = m.kv_valid;
  p.chunk_tokens = m.chunk_tokens;
  p.tf_clean_len = m.tf_clean_len;
  const size_t smem = s9::fwd_smem_bytes<D, kMode>(Skv);
  cudaError_t err = s9::set_smem(s9::flash_fwd_sm90<D, kMode>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.n_qtiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(H, B, p.n_qtiles);
  s9::flash_fwd_sm90<D, kMode><<<grid, s9::kFwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Whether (dtype, D) takes the Hopper schedule: bf16 with a head of 64 or
// 128. ops/flash_attention.py:flash_schedule states the same rule.
bool use_sm90(int dtype, int D) { return dtype == 1 && (D == 64 || D == 128); }

// Whether K1 at (dtype, D) takes the wide Hopper schedule: bf16 with a head
// of 384 (flash_schedule's "sm90_wide").
bool use_wide(int dtype, int D) { return dtype == 1 && D == s9w::kWideD; }

// Whether K1 at (dtype, D) takes the 3xTF32 wide schedule: fp32 with a head
// of 384 (flash_schedule's "sm90_wide_tf32").
bool use_wide_tf32(int dtype, int D) { return dtype == 0 && D == s9w::kWideD; }

// The wide schedule with `splits` key ranges; one split writes O and the
// LSE, more write the fp32 partials.
int wide(const void* q, const void* k, const void* v, void* o, void* lse, void* part,
         void* lse_part, int B, int H, int Sq, int Skv, const long long* st, float scale,
         int causal, int kv_valid, int splits, cudaStream_t stream) {
  constexpr int D = s9w::kWideD;
  if (Sq <= 0 || B <= 0 || H <= 0 || splits < 1 || splits > s9w::kWideMaxSplits ||
      (splits > 1 && (part == nullptr || lse_part == nullptr)) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  s9w::WideParams p;
  if (!s9w::map_bshd(&p.q, q, B, Sq, H, D, st[0], st[1], st[2], s9w::kWideBQ) ||
      !s9w::map_bshd(&p.k, k, B, Skv, H, D, st[3], st[4], st[5], s9w::kWideBK) ||
      !s9w::map_bshd(&p.v, v, B, Skv, H, D, st[6], st[7], st[8], s9w::kWideBK))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_ss = st[11];
  p.part = static_cast<float*>(part);
  p.lse_part = static_cast<float*>(lse_part);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.n_qtiles = (Sq + s9w::kWideBQ - 1) / s9w::kWideBQ;
  p.splits = splits;
  p.scale_log2 = scale * s9w::kLog2e;
  p.causal = causal;
  p.kv_valid = kv_valid;
  const size_t smem = s9w::wide_smem_bytes();
  cudaError_t err = s9w::set_smem(s9w::flash_fwd_wide_sm90, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.n_qtiles * splits, H, B);
  s9w::flash_fwd_wide_sm90<<<grid, s9w::kWideThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B,
             int H, int Sq, int Skv, int D, const long long* st, float scale, const MaskArgs& m,
             cudaStream_t s) {
  if (D % 16 != 0 || Sq <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // heads of 640 and 1024 are flash_fwd_cols.cu's (K1 alone): no schedule
  // of this source takes them
  if (D == 640 || D == 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (use_sm90(dtype, D)) {
    if (D == 64) return launch_sm90<64, kMode>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, m, s);
    return launch_sm90<128, kMode>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, m, s);
  }
  if (kMode == kPlain && use_wide(dtype, D))  // one split: no partials
    return wide(q, k, v, o, lse, nullptr, nullptr, B, H, Sq, Skv, st, scale, m.causal,
                m.kv_valid, 1, s);
  // the 3xTF32 schedule reads the pre-pass's split K and V^T: its own entry
  if (kMode == kPlain && use_wide_tf32(dtype, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (D <= 128)
      return launch<bf16, 64, 64, kMode>(q, k, v, o, lse, B, H, Sq, Skv, D, st, scale, m, s);
    return launch<bf16, 64, 32, kMode>(q, k, v, o, lse, B, H, Sq, Skv, D, st, scale, m, s);
  }
  if (dtype == 0)
    return launch<float, 32, 16, kMode>(q, k, v, o, lse, B, H, Sq, Skv, D, st, scale, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1's schedule at (dtype, D): 1 the Hopper one (flash_fwd_sm90.cuh), 2 the
// wide Hopper one (flash_fwd_wide_sm90.cuh), 3 the 3xTF32 wide one
// (flash_fwd_wide_tf32_sm90.cuh), 4 the column-sliced one of
// flash_fwd_cols.cu (heads of 640 and 1024), 0 attn_tile.cuh's.
extern "C" int fvt_flash_fwd_sm90(int dtype, int D) {
  if ((dtype == 0 || dtype == 1) && (D == 640 || D == 1024)) return 4;
  return use_sm90(dtype, D) ? 1 : (use_wide(dtype, D) ? 2 : (use_wide_tf32(dtype, D) ? 3 : 0));
}

namespace {

// A wide launch's key splits for B x H heads of Sq query rows over
// min(kv_valid, Skv) keys on `sms` SMs, bq rows a block and bk keys a chunk.
int splits_of(int B, int H, int Sq, int Skv, int kv_valid, int sms, int bq, int bk) {
  const int keys = kv_valid < Skv ? kv_valid : Skv;
  const long long blocks = static_cast<long long>(B) * H * ((Sq + bq - 1) / bq);
  return s9w::wide_splits(blocks, keys > 0 ? (keys + bk - 1) / bk : 0, sms);
}

}  // namespace

// The wide schedule's key splits.
extern "C" int fvt_flash_fwd_wide_splits(int B, int H, int Sq, int Skv, int kv_valid, int sms) {
  return splits_of(B, H, Sq, Skv, kv_valid, sms, s9w::kWideBQ, s9w::kWideBK);
}

// The wide schedule's dynamic shared memory a block (bytes).
extern "C" int fvt_flash_fwd_wide_smem() { return static_cast<int>(s9w::wide_smem_bytes()); }

// The 3xTF32 wide schedule's key splits (64 query rows a block) and its
// dynamic shared memory a block.
extern "C" int fvt_flash_fwd_wide_tf32_splits(int B, int H, int Sq, int Skv, int kv_valid,
                                              int sms) {
  return splits_of(B, H, Sq, Skv, kv_valid, sms, s9w::kTf32BQ, s9w::kTf32BK);
}
extern "C" int fvt_flash_fwd_wide_tf32_smem() {
  return static_cast<int>(s9w::wide_tf32_smem_bytes());
}

// The Hopper schedule's dynamic shared memory a block (bytes) for a head of
// D (64 or 128), mask mode `mode` (0 K1, 1 K5, 2 K1 struct) and Skv keys.
extern "C" int fvt_flash_fwd_sm90_smem(int D, int mode, int Skv) {
  namespace s9 = fvt::sm90;
  const bool d64 = D == 64;
  switch (mode) {
    case kKvMask:
      return static_cast<int>(d64 ? s9::fwd_smem_bytes<64, kKvMask>(Skv)
                                  : s9::fwd_smem_bytes<128, kKvMask>(Skv));
    case kStruct:
      return static_cast<int>(d64 ? s9::fwd_smem_bytes<64, kStruct>(Skv)
                                  : s9::fwd_smem_bytes<128, kStruct>(Skv));
    default:
      return static_cast<int>(d64 ? s9::fwd_smem_bytes<64, kPlain>(Skv)
                                  : s9::fwd_smem_bytes<128, kPlain>(Skv));
  }
}

// dtype: 0 = float32, 1 = bfloat16. D must be a multiple of 16; strides in
// elements (q, k, v, o each as batch, head, row); lse may be null.
extern "C" int fvt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int dtype, int B, int H, int Sq, int Skv, int D, long long q_sb,
                             long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss, float scale,
                             int causal, int kv_valid, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return dispatch<kPlain>(q, k, v, o, lse, dtype, B, H, Sq, Skv, D, st, scale,
                          MaskArgs{causal, kv_valid, nullptr, 0, 0},
                          static_cast<cudaStream_t>(stream));
}

// K5: as fvt_flash_fwd with no causal mask and every key in range, plus
// kv_mask [Skv] (one byte a key, 0 = masked), which must not be null; lse
// may be null, as in fvt_flash_fwd.
extern "C" int fvt_flash_fwd_kv_mask(const void* q, const void* k, const void* v, void* o,
                                     void* lse, const void* kv_mask, int dtype, int B, int H,
                                     int Sq, int Skv, int D, long long q_sb, long long q_sh,
                                     long long q_ss, long long k_sb, long long k_sh,
                                     long long k_ss, long long v_sb, long long v_sh,
                                     long long v_ss, long long o_sb, long long o_sh,
                                     long long o_ss, float scale, void* stream) {
  if (kv_mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return dispatch<kKvMask>(q, k, v, o, lse, dtype, B, H, Sq, Skv, D, st, scale,
                           MaskArgs{0, Skv, static_cast<const unsigned char*>(kv_mask), 0, 0},
                           static_cast<cudaStream_t>(stream));
}

// K1 struct: as fvt_flash_fwd with the chunk-causal mask (chunk_tokens > 0,
// tf_clean_len 0) or the teacher-forcing mask (both > 0) in place of causal;
// lse may be null.
extern "C" int fvt_flash_fwd_struct(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int dtype, int B, int H, int Sq, int Skv, int D,
                                    long long q_sb, long long q_sh, long long q_ss,
                                    long long k_sb, long long k_sh, long long k_ss,
                                    long long v_sb, long long v_sh, long long v_ss,
                                    long long o_sb, long long o_sh, long long o_ss, float scale,
                                    int kv_valid, int chunk_tokens, int tf_clean_len,
                                    void* stream) {
  if (chunk_tokens <= 0 || tf_clean_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return dispatch<kStruct>(q, k, v, o, lse, dtype, B, H, Sq, Skv, D, st, scale,
                           MaskArgs{0, kv_valid, nullptr, chunk_tokens, tf_clean_len},
                           static_cast<cudaStream_t>(stream));
}

// K1 at bf16 with a head of 384 on the wide schedule: as fvt_flash_fwd with
// `splits` key ranges (1..8). With one
// split it writes o and lse (which may be null); with more it writes the
// fp32 partials part [splits, B, H, Sq, 384] and lse_part [splits, B, H,
// Sq], which fvt_flash_fwd_combine merges into o and lse.
extern "C" int fvt_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                  void* lse, void* part, void* lse_part, int B, int H, int Sq,
                                  int Skv, long long q_sb, long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh, long long k_ss,
                                  long long v_sb, long long v_sh, long long v_ss,
                                  long long o_sb, long long o_sh, long long o_ss, float scale,
                                  int causal, int kv_valid, int splits, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return wide(q, k, v, o, lse, part, lse_part, B, H, Sq, Skv, st, scale, causal, kv_valid, splits,
              static_cast<cudaStream_t>(stream));
}

// The merge of a split wide launch: o (bf16 [B, Sq, H, 384], element
// strides o_sb, o_sh, o_ss; 8-byte aligned rows) and lse ([B, H, Sq] or
// null) from part and lse_part.
extern "C" int fvt_flash_fwd_combine(const void* part, const void* lse_part, void* o, void* lse,
                                     int splits, int B, int H, int Sq, long long o_sb,
                                     long long o_sh, long long o_ss, void* stream) {
  if (splits < 1 || B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long blocks = (rows + s9w::kCombineRows - 1) / s9w::kCombineRows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  s9w::flash_fwd_combine<bf16>
      <<<static_cast<unsigned>(blocks), s9w::kCombineRows * s9w::kWideD / 4, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(part), static_cast<const float*>(lse_part),
          static_cast<bf16*>(o), static_cast<float*>(lse), splits, H, Sq, rows, o_sb, o_sh, o_ss);
  return static_cast<int>(cudaGetLastError());
}

// The same merge into an fp32 o (16-byte aligned rows): the 3xTF32
// schedule's.
extern "C" int fvt_flash_fwd_combine_f32(const void* part, const void* lse_part, void* o,
                                         void* lse, int splits, int B, int H, int Sq,
                                         long long o_sb, long long o_sh, long long o_ss,
                                         void* stream) {
  if (splits < 1 || B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long blocks = (rows + s9w::kCombineRows - 1) / s9w::kCombineRows;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  s9w::flash_fwd_combine<float>
      <<<static_cast<unsigned>(blocks), s9w::kCombineRows * s9w::kWideD / 4, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(part), static_cast<const float*>(lse_part),
          static_cast<float*>(o), static_cast<float*>(lse), splits, H, Sq, rows, o_sb, o_sh, o_ss);
  return static_cast<int>(cudaGetLastError());
}

// The 3xTF32 schedule's pre-pass: k_hi, k_lo (fp32 [B, H, Skv_pad, 384])
// and vt_hi, vt_lo (fp32 [B, H, 384, Skv_pad], the keys of each group of 8
// in the order 0 2 4 6 1 3 5 7), zero past Skv, from fp32 [B, Skv, H, 384]
// views k and v (element strides as batch, head, row). Skv_pad is a
// multiple of 32 at least Skv.
extern "C" int fvt_flash_tf32_split(const void* k, const void* v, void* k_hi, void* k_lo,
                                    void* vt_hi, void* vt_lo, int B, int H, int Skv, int Skv_pad,
                                    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                    long long v_sh, long long v_ss, void* stream) {
  constexpr int T = s9w::kSplitTile;
  if (B <= 0 || H <= 0 || Skv < 0 || Skv_pad <= 0 || Skv_pad % T != 0 || Skv_pad < Skv ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Skv_pad / T, s9w::kWideD / T, B * H);
  s9w::flash_tf32_split<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(k_hi),
      static_cast<float*>(k_lo), static_cast<float*>(vt_hi), static_cast<float*>(vt_lo), H, Skv,
      Skv_pad, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss);
  return static_cast<int>(cudaGetLastError());
}

// K1 at fp32 with a head of 384 on the 3xTF32 wide schedule: q an fp32 [B,
// Sq, H, 384] view (element strides), k_hi .. vt_lo the pre-pass's output
// at Skv_pad keys, `splits` key ranges (1..8). With one split it writes o
// (fp32 [B, Sq, H, 384], 8-byte aligned rows) and lse (which may be null);
// with more it writes the partials part [splits, B, H, Sq, 384] and
// lse_part [splits, B, H, Sq], which fvt_flash_fwd_combine_f32 merges.
extern "C" int fvt_flash_fwd_wide_tf32(const void* q, const void* k_hi, const void* k_lo,
                                       const void* vt_hi, const void* vt_lo, void* o, void* lse,
                                       void* part, void* lse_part, int B, int H, int Sq, int Skv,
                                       int Skv_pad, long long q_sb, long long q_sh, long long q_ss,
                                       long long o_sb, long long o_sh, long long o_ss, float scale,
                                       int causal, int kv_valid, int splits, void* stream) {
  constexpr int D = s9w::kWideD;
  if (Sq <= 0 || B <= 0 || H <= 0 || splits < 1 || splits > s9w::kWideMaxSplits ||
      Skv_pad <= 0 || Skv_pad % s9w::kTf32BK != 0 || Skv_pad < Skv ||
      (splits > 1 && (part == nullptr || lse_part == nullptr)) ||
      (splits == 1 && o == nullptr) || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  s9w::Tf32Params p;
  const long long kh = static_cast<long long>(Skv_pad) * D;  // a head of k_hi / vt_hi
  if (!s9w::map_bshd_f32(&p.q, q, B, Sq, H, D, q_sb, q_sh, q_ss, s9w::kTf32BQ) ||
      !s9w::map_bshd_f32(&p.k_hi, k_hi, B, Skv_pad, H, D, H * kh, kh, D, s9w::kTf32BK) ||
      !s9w::map_bshd_f32(&p.k_lo, k_lo, B, Skv_pad, H, D, H * kh, kh, D, s9w::kTf32BK) ||
      !s9w::map_bshd_f32(&p.vt_hi, vt_hi, B, D, H, Skv_pad, H * kh, kh, Skv_pad, s9w::kTf32Half) ||
      !s9w::map_bshd_f32(&p.vt_lo, vt_lo, B, D, H, Skv_pad, H * kh, kh, Skv_pad, s9w::kTf32Half))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.part = static_cast<float*>(part);
  p.lse_part = static_cast<float*>(lse_part);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.n_qtiles = (Sq + s9w::kTf32BQ - 1) / s9w::kTf32BQ;
  p.splits = splits;
  p.scale_log2 = scale * s9w::kLog2e;
  p.causal = causal;
  p.kv_valid = kv_valid;
  const size_t smem = s9w::wide_tf32_smem_bytes();
  cudaError_t err = s9w::set_smem(s9w::flash_fwd_wide_tf32_sm90, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.n_qtiles * splits, H, B);
  s9w::flash_fwd_wide_tf32_sm90<<<grid, s9w::kTf32Threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Flash attention forward at the wide heads of the Wan2.2 VAE (sm_90a): K1
// at a head of 640 or 1024, bf16 and fp32, a library of its own.
//
// Replaces the Pallas kernel fastvideo_tpu/ops/flash_attention.py:_fwd_kernel
// (:93, reached through _flash_attention_fwd_bhsd, call :222) at those
// heads: the single-head mid-block attention of the Wan2.2 VAE
// (fastvideo_tpu/models/vaes/wan.py:WanAttentionBlock), 640 wide in the
// encoder (fp32) and 1024 in the decoder (bf16). The schedule, what bounds
// it and what its design does about that are in flash_fwd_cols_sm90.cuh: a
// cluster of CTAs a 64-row query tile, the head split over the cluster for
// both S and O, the partial scores summed once through distributed shared
// memory, TMA rings fed by a producer warpgroup, wgmma products (3xTF32 for
// fp32, after a pre-pass that splits K and V^T into TF32 heads and tails).
//
// Strides are in elements (batch, head, row) and let the caller pass
// [B, S, H, D] views (the VAE's q, k, v column views of one qkv tensor).
#include <cuda_runtime.h>

#include "flash_fwd_cols_sm90.cuh"

namespace {

namespace s9 = fvt::sm90;

bool cols_head(int D) { return D == 640 || D == 1024; }

// Keys of the fp32 pre-pass's output: Skv rounded up to whole chunks (at
// least one).
int keys_padded(int Skv) {
  const int chunks = (Skv + s9::kColsBK - 1) / s9::kColsBK;
  return (chunks < 1 ? 1 : chunks) * s9::kColsBK;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, s9::ColsParams& p, int B, int H,
                int Sq, int Skv, const long long* st, cudaStream_t stream) {
  const int skv = Skv < 1 ? 1 : Skv;  // a map needs a row; no chunk reads it
  if (!s9::map_bshd(&p.q, q, B, Sq, H, D, st[0], st[1], st[2], s9::kColsBQ) ||
      !s9::map_bshd(&p.k, k, B, skv, H, D, st[3], st[4], st[5], s9::kColsBK) ||
      !s9::map_bshd(&p.v, v, B, skv, H, D, st[6], st[7], st[8], s9::kColsBK))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      s9::cols_launch<s9::ColsShape<D, 1>>(s9::flash_fwd_cols_bf16<D>, p, B, H, Sq, stream));
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, float* split, s9::ColsParams& p,
               int B, int H, int Sq, int Skv, const long long* st, cudaStream_t stream) {
  const int pad = keys_padded(Skv);
  const long long n = static_cast<long long>(B) * H * pad * D;  // one of the four arrays
  float* k_hi = split;
  float* k_lo = split + n;
  float* vt_hi = split + 2 * n;
  float* vt_lo = split + 3 * n;
  dim3 grid(pad / 32, D / 32, B * H);
  s9::cols_tf32_split<D><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), k_hi, k_lo, vt_hi, vt_lo, H,
      Skv, pad, st[3], st[4], st[5], st[6], st[7], st[8]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kh = static_cast<long long>(pad) * D;  // a head of the split arrays
  constexpr int DC = s9::ColsShape<D, 0>::DC;
  if (!s9::cols_map_f32(&p.q, q, B, Sq, H, D, st[0], st[1], st[2], s9::kColsBQ) ||
      !s9::cols_map_f32(&p.k_hi, k_hi, B, pad, H, D, H * kh, kh, D, s9::kColsBK) ||
      !s9::cols_map_f32(&p.k_lo, k_lo, B, pad, H, D, H * kh, kh, D, s9::kColsBK) ||
      !s9::cols_map_f32(&p.vt_hi, vt_hi, B, D, H, pad, H * kh, kh, pad, DC) ||
      !s9::cols_map_f32(&p.vt_lo, vt_lo, B, D, H, pad, H * kh, kh, pad, DC))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      s9::cols_launch<s9::ColsShape<D, 0>>(s9::flash_fwd_cols_f32<D>, p, B, H, Sq, stream));
}

}  // namespace

// 1 when K1 at (dtype, D) runs this kernel: a head of 640 or 1024, bf16
// (dtype 1) or fp32 (dtype 0). ops/flash_attention.py:flash_schedule
// states the same rule ("cols").
extern "C" int fvt_flash_fwd_cols_route(int dtype, int D) {
  return (dtype == 0 || dtype == 1) && cols_head(D) ? 1 : 0;
}

// The dynamic shared memory a CTA (bytes) for dtype 0 (fp32) or 1 (bf16)
// at a head of D (0 for another head).
extern "C" int fvt_flash_fwd_cols_smem(int dtype, int D) {
  if (D == 640) return static_cast<int>(dtype == 1 ? s9::ColsShape<640, 1>::SMEM
                                                   : s9::ColsShape<640, 0>::SMEM);
  if (D == 1024) return static_cast<int>(dtype == 1 ? s9::ColsShape<1024, 1>::SMEM
                                                    : s9::ColsShape<1024, 0>::SMEM);
  return 0;
}

// K1 at a head of 640 or 1024: q, k, v, o [B, S, H, D] views (element
// strides batch, head, row; unit stride along the head; 16-byte aligned
// base and row strides), lse fp32 [B, H, Sq] or null. dtype 0 = fp32,
// 1 = bf16 (one dtype for q, k, v and o). fp32 takes `split`, an fp32
// scratch of 4 x B x H x Skv_pad x D values (Skv_pad: Skv rounded up to
// whole chunks of 32, at least one), which its pre-pass fills before the
// attention kernel runs; bf16 takes null.
extern "C" int fvt_flash_fwd_cols(const void* q, const void* k, const void* v, void* o,
                                  void* lse, void* split, int dtype, int B, int H, int Sq,
                                  int Skv, int D, long long q_sb, long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                                  long long o_ss, float scale, int causal, int kv_valid,
                                  void* stream) {
  if (!fvt_flash_fwd_cols_route(dtype, D) || B <= 0 || H <= 0 || Sq <= 0 || Skv < 0 ||
      B > 65535 || H > 65535 || static_cast<long long>(B) * H > 65535 ||
      (dtype == 0 && split == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  s9::ColsParams p{};
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.scale_log2 = scale * s9::kLog2e;
  p.causal = causal;
  p.kv_valid = kv_valid;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(split);
  if (dtype == 1)
    return D == 640 ? launch_bf16<640>(q, k, v, p, B, H, Sq, Skv, st, s)
                    : launch_bf16<1024>(q, k, v, p, B, H, Sq, Skv, st, s);
  return D == 640 ? launch_f32<640>(q, k, v, sp, p, B, H, Sq, Skv, st, s)
                  : launch_f32<1024>(q, k, v, sp, p, B, H, Sq, Skv, st, s);
}

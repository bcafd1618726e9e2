// Tiles of the attention backward, shared by the dense flash backward
// (flash_bwd.cu, K6) and the block-sparse backward (vsa_sparse_bwd.cu, K7
// bwd). Both replay the forward's probabilities from its log-sum-exp:
//
//   p  = exp(s * scale - lse)       where the key is live for the row, else 0
//   dP = dO V^T
//   dS = p * (dP - delta) * scale   with delta = rowsum(dO * O), from the caller
//   dQ = dS K        dK = dS^T Q        dV = p^T dO
//
// A block of 4 warps; bf16 operands through WMMA 16x16x16 tiles with fp32
// accumulation, the fp32 sums kept in shared memory, as in attn_tile.cuh.
//
// Where to round (the Pallas kernels' points, flash_attention.py:338, :384,
// :390 and vsa.py:754, :820, :827): p is rounded to dO's dtype before
// p^T dO, dS to the operand dtype before dS K and dS^T Q; s, dP, p and dS
// themselves are fp32, and dQ/dK/dV are written in the input dtype after
// fp32 accumulation.
//
// Rows with no valid key: the caller's `live` predicate is false for every
// key of such a row, and p is selected (not multiplied) before any use, so
// an LSE of -inf (K1's empty row) or of MASK_VALUE (K7 fwd's) never meets a
// valid key and the row's gradients are exactly 0.
#pragma once

#include "attn_tile.cuh"

namespace fvt {

// Copy `rows` rows (row r at src + r * row_stride) of D bf16 values into a
// tile with leading dimension ldt; rows in [rows, tile_rows) are zero.
// Block-wide, 16-byte loads (the caller guarantees 16-byte alignment).
__device__ __forceinline__ void load_bf16_rows(bf16* dst, int ldt, const bf16* src,
                                               long long row_stride, int rows, int tile_rows,
                                               int D) {
  constexpr int kVec = 8;
  const int vec_per_row = D / kVec;
  for (int i = threadIdx.x; i < tile_rows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ldt + c) = val;
  }
}

// out (16 x N per warp, fp32, leading dim ldo) = A (16 x D rows of this warp
// in `a`) times B^T, where B's N rows of D values sit in `b`: the products
// S = Q K^T and dP = dO V^T (and their transposes in dK/dV).
__device__ __forceinline__ void warp_abt(float* out, int ldo, const bf16* a, const bf16* b,
                                         int ldt, int N, int D) {
  using namespace nvcuda;
  for (int n = 0; n < N / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, ldt);
      wmma::load_matrix_sync(fb, b + n * 16 * ldt + kk * 16, ldt);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, ldo, wmma::mem_row_major);
  }
}

// acc (16 x D per warp, fp32, leading dim lda) += A (16 x K bf16, leading dim
// ldp) times B (K x D bf16, row-major, leading dim ldt): dQ += dS K,
// dV += p^T dO, dK += dS^T Q.
__device__ __forceinline__ void warp_acc_ab(float* acc, int lda, const bf16* a, int ldp,
                                            const bf16* b, int ldt, int K, int D) {
  using namespace nvcuda;
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, acc + n * 16, lda, wmma::mem_row_major);
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, ldp);
      wmma::load_matrix_sync(fb, b + kk * 16 * ldt + n * 16, ldt);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + n * 16, c, lda, wmma::mem_row_major);
  }
}

// Shared-memory layout of one backward block: two "own" row tiles that stay
// for the block's life (dQ: Q, dO; dK/dV: K, V), two streamed tiles (dQ: K,
// V chunks; dK/dV: Q, dO chunks), the fp32 score and dP tiles, the bf16 p
// and dS tiles, two fp32 accumulators (dQ uses one) and the streamed rows'
// LSE and delta (dQ: its own rows').
template <int BR, int BC>
struct BwdSmem {
  static_assert(BR == 16 * kWarps, "each warp owns 16 rows");
  static_assert(BC % 16 == 0, "BC must be a multiple of 16");
  static constexpr int kStats = BR > BC ? BR : BC;  // rows with an LSE and a delta
  int D, ldt, lds, ldp, ldo;
  bf16* own0;
  bf16* own1;
  bf16* str0;
  bf16* str1;
  float* s;
  float* dp;
  bf16* p;
  bf16* ds;
  float* acc0;
  float* acc1;
  float* lse;
  float* delta;

  __host__ __device__ static size_t bytes(int d, int n_acc) {
    const size_t ldt_ = d + 8, lds_ = BC + 4, ldp_ = BC + 8, ldo_ = d + 4;
    return round_up_128(BR * ldt_ * 2) * 2 + round_up_128(BC * ldt_ * 2) * 2 +
           round_up_128(BR * lds_ * 4) * 2 + round_up_128(BR * ldp_ * 2) * 2 +
           round_up_128(BR * ldo_ * 4) * n_acc + round_up_128(kStats * 4) * 2;
  }

  __device__ void carve(unsigned char* base, int d, int n_acc) {
    D = d;
    ldt = d + 8;
    lds = BC + 4;
    ldp = BC + 8;
    ldo = d + 4;
    unsigned char* ptr = base;
    auto take = [&](size_t n) {
      unsigned char* r = ptr;
      ptr += round_up_128(n);
      return r;
    };
    own0 = reinterpret_cast<bf16*>(take(BR * ldt * 2));
    own1 = reinterpret_cast<bf16*>(take(BR * ldt * 2));
    str0 = reinterpret_cast<bf16*>(take(BC * ldt * 2));
    str1 = reinterpret_cast<bf16*>(take(BC * ldt * 2));
    s = reinterpret_cast<float*>(take(BR * lds * 4));
    dp = reinterpret_cast<float*>(take(BR * lds * 4));
    p = reinterpret_cast<bf16*>(take(BR * ldp * 2));
    ds = reinterpret_cast<bf16*>(take(BR * ldp * 2));
    acc0 = reinterpret_cast<float*>(take(BR * ldo * 4));
    acc1 = n_acc > 1 ? reinterpret_cast<float*>(take(BR * ldo * 4)) : nullptr;
    lse = reinterpret_cast<float*>(take(kStats * 4));
    delta = reinterpret_cast<float*>(take(kStats * 4));
  }

  __device__ void zero_acc(int n_acc) {
    for (int i = threadIdx.x; i < BR * ldo; i += kThreads) {
      acc0[i] = 0.f;
      if (n_acc > 1) acc1[i] = 0.f;
    }
  }

  // Write this warp's rows (below `rows`) of an accumulator in bf16.
  __device__ void store(const float* acc, bf16* out, long long row_stride, int rows) const {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      if (r >= rows) continue;
      for (int d = lane; d < D; d += 32) out[r * row_stride + d] = __float2bfloat16(acc[r * ldo + d]);
    }
  }
};

// The elementwise middle of the backward, for this warp's 16 rows of the
// score tile s and dP tile dp (BC columns each). `live(r, c)` says whether
// p[r][c] is a probability the forward used; lse_of(r, c) and delta_of(r, c)
// give that probability's LSE and delta (dQ: of row r; dK/dV: of column c,
// the streamed query). Writes p (rounded to bf16, dO's dtype) when `want_p`,
// and dS (rounded to bf16, the operands' dtype).
template <int BC, class Live, class Lse, class Delta>
__device__ __forceinline__ void grad_scores(const float* s, const float* dp, int lds, bf16* p,
                                            bf16* ds, int ldp, float scale, bool want_p,
                                            Live live, Lse lse_of, Delta delta_of) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < 16 * BC; i += 32) {
    const int r = warp * 16 + i / BC;
    const int c = i % BC;
    // p is selected before it is used: a masked (or empty-row) entry never
    // evaluates exp(s - lse) into the sums
    const float pr = live(r, c) ? expf(s[r * lds + c] * scale - lse_of(r, c)) : 0.f;
    const float dsr = pr * (dp[r * lds + c] - delta_of(r, c)) * scale;
    if (want_p) p[r * ldp + c] = __float2bfloat16(pr);
    ds[r * ldp + c] = __float2bfloat16(dsr);
  }
  __syncwarp();
}

}  // namespace fvt

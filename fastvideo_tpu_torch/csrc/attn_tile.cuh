// One query tile of online-softmax attention, shared by the dense flash
// kernel (flash_fwd.cu) and the block-sparse kernels (vsa_sparse_fwd.cu,
// vsa_sparse_padded_fwd.cu).
//
// A block of 4 warps owns BQ query rows. Q, the current K/V chunk (BK key
// rows), the fp32 score tile S, the probability tile P and the fp32 output
// accumulator O all live in shared memory; each warp owns BQ/4 rows of S, P
// and O, so the softmax and the P@V update need only warp-level syncs. The
// running max m and sum l are fp32 per row.
//
// bf16 inputs use tensor-core WMMA tiles (16x16x16, fp32 accumulate) for
// Q@K^T and P@V with P rounded to bf16 before the product, as the Pallas
// kernels do (p.astype(v.dtype)). fp32 inputs run the same schedule with
// scalar FMA loops, so the fp32 result is not rounded through bf16.
//
// Masked scores are -inf and contribute exactly 0, so a row with no valid
// key keeps l == 0 and stores 0 (and an LSE of -inf).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <type_traits>

namespace fvt {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t round_up_128(size_t n) {
  return (n + 127) / 128 * 128;
}

template <typename T, int BQ, int BK>
struct AttnTile {
  static constexpr bool kWmma = std::is_same<T, bf16>::value;
  static constexpr int kRowsPerWarp = BQ / kWarps;
  static constexpr int kPadT = kWmma ? 8 : 4;  // keeps rows 16-byte aligned
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  static_assert(!kWmma || kRowsPerWarp == 16, "WMMA path needs 16 rows per warp");
  static_assert(BK % 16 == 0, "BK must be a multiple of 16");

  int D, ldt, ldo, lds, ldp;
  T* q;
  T* k;
  T* v;
  float* o;
  float* s;
  T* p;
  float* m;
  float* l;
  float* alpha;

  __host__ __device__ static size_t smem_bytes(int d) {
    const size_t ldt_ = d + kPadT, ldo_ = d + 4, lds_ = BK + 4, ldp_ = BK + kPadT;
    return round_up_128(BQ * ldt_ * sizeof(T)) + 2 * round_up_128(BK * ldt_ * sizeof(T)) +
           round_up_128(BQ * ldo_ * 4) + round_up_128(BQ * lds_ * 4) +
           round_up_128(BQ * ldp_ * sizeof(T)) + 3 * round_up_128(BQ * 4);
  }

  __device__ void carve(unsigned char* base, int d) {
    D = d;
    ldt = d + kPadT;
    ldo = d + 4;
    lds = BK + 4;
    ldp = BK + kPadT;
    unsigned char* ptr = base;
    auto take = [&](size_t bytes) {
      unsigned char* r = ptr;
      ptr += round_up_128(bytes);
      return r;
    };
    q = reinterpret_cast<T*>(take(BQ * ldt * sizeof(T)));
    k = reinterpret_cast<T*>(take(BK * ldt * sizeof(T)));
    v = reinterpret_cast<T*>(take(BK * ldt * sizeof(T)));
    o = reinterpret_cast<float*>(take(BQ * ldo * 4));
    s = reinterpret_cast<float*>(take(BQ * lds * 4));
    p = reinterpret_cast<T*>(take(BQ * ldp * sizeof(T)));
    m = reinterpret_cast<float*>(take(BQ * 4));
    l = reinterpret_cast<float*>(take(BQ * 4));
    alpha = reinterpret_cast<float*>(take(BQ * 4));
  }

  // Zero the accumulator and reset the row statistics (block-wide).
  __device__ void init() {
    for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) o[i] = 0.f;
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
    }
  }

  // Copy `rows` rows (row r at src + r * row_stride) into a tile of
  // `tile_rows` rows; rows past `rows` are zero. Block-wide, 16-byte loads:
  // the caller guarantees 16-byte alignment of src and of row_stride.
  __device__ void load_rows(T* dst, const T* src, long long row_stride, int rows,
                            int tile_rows) const {
    const int vec_per_row = D / kVec;
    for (int i = threadIdx.x; i < tile_rows * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row;
      const int c = (i - r * vec_per_row) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * ldt + c) = val;
    }
  }

  // S[rows of this warp] = Q K^T (unscaled, fp32).
  __device__ void scores() {
    const int warp = threadIdx.x / 32;
    if constexpr (kWmma) {
      using namespace nvcuda;
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, q + warp * 16 * ldt + kk * 16, ldt);
          wmma::load_matrix_sync(b, k + n * 16 * ldt + kk * 16, ldt);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(s + warp * 16 * lds + n * 16, acc, lds, wmma::mem_row_major);
      }
    } else {
      const int lane = threadIdx.x % 32;
      for (int i = lane; i < kRowsPerWarp * BK; i += 32) {
        const int r = warp * kRowsPerWarp + i / BK;
        const int c = i % BK;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc += to_float(q[r * ldt + d]) * to_float(k[c * ldt + d]);
        s[r * lds + c] = acc;
      }
    }
    __syncwarp();
  }

  // Online-softmax update of this warp's rows. valid(r, c) says whether
  // column c of the current chunk is a key that row r may attend.
  template <class Valid>
  __device__ void softmax_update(float scale, Valid valid) {
    constexpr int kCols = (BK + 31) / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float vals[kCols];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        float x = -CUDART_INF_F;
        if (c < BK && valid(r, c)) x = s[r * lds + c] * scale;
        vals[j] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_next = fmaxf(m_prev, mx);
      float a = 1.f;
      float sum = 0.f;
      if (m_next != -CUDART_INF_F) {
        a = expf(m_prev - m_next);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          vals[j] = expf(vals[j] - m_next);
          sum += vals[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) vals[j] = 0.f;
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        if (c < BK) {
          if constexpr (kWmma) {
            p[r * ldp + c] = from_float<T>(vals[j]);
          } else {
            s[r * lds + c] = vals[j];
          }
        }
      }
      if (lane == 0) {
        m[r] = m_next;
        l[r] = l[r] * a + sum;
        alpha[r] = a;
      }
    }
    __syncwarp();
  }

  // O[rows of this warp] = O * alpha + P V.
  __device__ void accumulate_pv() {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float a = alpha[r];
      for (int d = lane; d < D; d += 32) o[r * ldo + d] *= a;
    }
    __syncwarp();
    if constexpr (kWmma) {
      using namespace nvcuda;
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, o + warp * 16 * ldo + n * 16, ldo, wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, p + warp * 16 * ldp + kk * 16, ldp);
          wmma::load_matrix_sync(b, v + kk * 16 * ldt + n * 16, ldt);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(o + warp * 16 * ldo + n * 16, acc, ldo, wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        for (int d = lane; d < D; d += 32) {
          float acc = o[r * ldo + d];
          for (int c = 0; c < BK; ++c) acc += s[r * lds + c] * to_float(v[c * ldt + d]);
          o[r * ldo + d] = acc;
        }
      }
    }
    __syncwarp();
  }

  // out[r] = O[r] / l[r] for this warp's rows below `rows` (0 when l == 0);
  // lse[r] = m + log(l), `empty_lse` for a row with no valid key. lse may be
  // null.
  __device__ void store(T* out, long long row_stride, int rows, float* lse,
                        float empty_lse) const {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (r >= rows) continue;
      const float lr = l[r];
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
      for (int d = lane; d < D; d += 32) out[r * row_stride + d] = from_float<T>(o[r * ldo + d] * inv);
      if (lse != nullptr && lane == 0) lse[r] = lr == 0.f ? empty_lse : m[r] + logf(lr);
    }
  }
};

// Opt a kernel into the dynamic shared memory it needs (above 48 KB).
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fvt

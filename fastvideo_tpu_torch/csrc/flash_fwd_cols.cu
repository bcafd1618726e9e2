// Flash attention forward at the wide heads of the Wan2.2 VAE (sm_90a).
//
// Replaces the Pallas kernel fastvideo_tpu/ops/flash_attention.py:_fwd_kernel
// (:93, reached through _flash_attention_fwd_bhsd, call :222) at a head of
// 640 or 1024: the single-head mid-block attention of the Wan2.2 VAE
// (fastvideo_tpu/models/vaes/wan.py:WanAttentionBlock), 640 wide in the
// encoder (fp32) and 1024 in the decoder (bf16), over the tokens of one
// latent frame (3,520 at 704x1280). It computes what the other K1 forms
// compute: softmax(Q K^T * scale) V with fp32 scores and statistics, P
// rounded to the value type before P V, the output in the input type, the
// LSE in fp32, and 0 (LSE -inf) for a row with no valid key (keys at index
// >= kv_valid, and causal: key <= query).
//
// What bounds it: at 3,520 tokens and a head of 1024 the products are
// 4 Sq Skv D = 50.7 GFLOP a frame against 21.6 MB of unique input (about
// 2,300 FLOP a byte), so the tensor cores bound it. A block cannot hold a
// whole head: Q, K and V tiles of 64 rows at 1024 columns are 128 KB each
// in bf16, and 64 rows of O in fp32 are 256 KB, above the 227 KB a block
// may have. The design trades operations for memory:
//  - a block owns 64 query rows and kDC = 128 of O's columns (grid.x runs
//    over the D / 128 column slices, fastest, so the slices of one query
//    tile run together and share their Q and K reads in L2);
//  - for each chunk of 64 keys it builds S over the whole head from Q and K
//    pieces of 64 columns streamed through shared memory, then runs the
//    online softmax and adds P V for its own 128 columns alone.
// Each slice recomputes S, so a block does (D / 128 + 1) / 2 times the
// needed products: 4.5x at 1024, 3x at 640. Shared memory holds one piece
// of Q and K, the chunk's V slice and, for bf16, S, P and O (97 KB); the
// fp32 form keeps S and O in registers (86 KB). Loads are synchronous: a
// simple first kernel, its time beside its bound in PERF.md.
//
// bf16 runs the products on the tensor cores (WMMA 16x16x16, fp32 sums,
// one warp 16 query rows); fp32 runs them as fp32 FMAs, each thread a 4 x 8
// tile of S and a 4 x 16 tile of O in registers, Q and K transposed in
// shared memory so that each step reads them as float4 rows: no rounding
// through TF32, so the fp32 form agrees with the plain fp32 version to
// fp32 summation order.
//
// Strides are in elements (batch, head, row) and let the caller pass
// [B, S, H, D] views (the VAE's q, k, v column views of one qkv tensor).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include "attn_tile.cuh"

namespace {

using fvt::bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a chunk
constexpr int kDP = 64;        // head columns a piece of the S product
constexpr int kDC = 128;       // O columns a block

__host__ __device__ constexpr size_t up128(size_t n) { return (n + 127) / 128 * 128; }

// Leading dimensions (elements): rows stay 16-byte aligned, and WMMA's
// 16-row tiles 32-byte aligned.
constexpr int kLdQK16 = kDP + 8;  // bf16 Q / K pieces, row-major
constexpr int kLdV16 = kDC + 8;   // bf16 V slice
constexpr int kLdS = kBK + 4;     // fp32 S
constexpr int kLdP16 = kBK + 8;   // bf16 P
constexpr int kLdO = kDC + 4;     // fp32 O (bf16 form)
constexpr int kLdT32 = kBQ + 4;   // fp32 transposed Q / K pieces and P^T
constexpr int kLdV32 = kDC + 4;   // fp32 V slice

template <typename T>
__host__ __device__ constexpr size_t cols_smem_bytes();

template <>
__host__ __device__ constexpr size_t cols_smem_bytes<bf16>() {
  return up128(kBQ * kLdQK16 * 2) + up128(kBK * kLdQK16 * 2) + up128(kBK * kLdV16 * 2) +
         up128(kBQ * kLdS * 4) + up128(kBQ * kLdP16 * 2) + up128(kBQ * kLdO * 4) +
         3 * up128(kBQ * 4);
}

template <>
__host__ __device__ constexpr size_t cols_smem_bytes<float>() {
  return up128(kDP * kLdT32 * 4) + up128(kDP * kLdT32 * 4) + up128(kBK * kLdV32 * 4) +
         up128(kBK * kLdT32 * 4);
}

struct ColsParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Sq, Skv, D;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal, kv_valid;
};

// Copy rows [0, rows) of a 64-column bf16 piece (row r at src + r * stride)
// into a [tile_rows][ld] tile, zeros past `rows`; 16-byte loads.
__device__ __forceinline__ void load_piece16(bf16* dst, int ld, const bf16* src, long long stride,
                                             int rows, int tile_rows, int cols) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < tile_rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// bf16: S = Q K^T on WMMA, then the online softmax and O += P V through
// shared memory (attn_tile.cuh's step on a column slice).
__global__ void __launch_bounds__(kThreads)
    flash_fwd_cols_bf16(const ColsParams p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  auto take = [&](size_t bytes) {
    unsigned char* r = ptr;
    ptr += up128(bytes);
    return r;
  };
  bf16* qs = reinterpret_cast<bf16*>(take(kBQ * kLdQK16 * 2));
  bf16* ks = reinterpret_cast<bf16*>(take(kBK * kLdQK16 * 2));
  bf16* vs = reinterpret_cast<bf16*>(take(kBK * kLdV16 * 2));
  float* s = reinterpret_cast<float*>(take(kBQ * kLdS * 4));
  bf16* pm = reinterpret_cast<bf16*>(take(kBQ * kLdP16 * 2));
  float* o = reinterpret_cast<float*>(take(kBQ * kLdO * 4));
  float* m = reinterpret_cast<float*>(take(kBQ * 4));
  float* l = reinterpret_cast<float*>(take(kBQ * 4));
  float* alpha = reinterpret_cast<float*>(take(kBQ * 4));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kDC;
  const int q0 = blockIdx.y * kBQ;
  const int b = blockIdx.z / p.H;
  const int h = blockIdx.z - b * p.H;
  const int nq = min(kBQ, p.Sq - q0);
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh + col0;

  for (int i = threadIdx.x; i < kBQ * kLdO; i += kThreads) o[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  int kv_end = min(p.kv_valid, p.Skv);
  if (p.causal) kv_end = min(kv_end, q0 + nq);

  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    const int nk = min(kBK, kv_end - j0);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int d0 = 0; d0 < p.D; d0 += kDP) {
      __syncthreads();  // every warp is done with the last piece (and V)
      load_piece16(qs, kLdQK16, qp + d0, p.q_ss, nq, kBQ, kDP);
      load_piece16(ks, kLdQK16, kp + j0 * p.k_ss + d0, p.k_ss, nk, kBK, kDP);
      if (d0 == 0) load_piece16(vs, kLdV16, vp + j0 * p.v_ss, p.v_ss, nk, kBK, kDC);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + warp * 16 * kLdQK16 + kk * 16, kLdQK16);
#pragma unroll
        for (int n = 0; n < kBK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(bm, ks + n * 16 * kLdQK16 + kk * 16, kLdQK16);
          wmma::mma_sync(acc[n], a, bm, acc[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n)
      wmma::store_matrix_sync(s + warp * 16 * kLdS + n * 16, acc[n], kLdS, wmma::mem_row_major);
    __syncwarp();

    // online softmax of this warp's 16 rows; lane owns columns lane, lane+32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      float vals[2];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = lane + 32 * jj;
        const bool ok = c < nk && (!p.causal || j0 + c <= q0 + r);
        vals[jj] = ok ? s[r * kLdS + c] * p.scale : -CUDART_INF_F;
        mx = fmaxf(mx, vals[jj]);
      }
      mx = fvt::warp_max(mx);
      const float m_prev = m[r];
      const float m_next = fmaxf(m_prev, mx);
      float a = 1.f, sum = 0.f;
      if (m_next != -CUDART_INF_F) {
        a = expf(m_prev - m_next);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          vals[jj] = expf(vals[jj] - m_next);
          sum += vals[jj];
        }
      } else {
        vals[0] = vals[1] = 0.f;
      }
      sum = fvt::warp_sum(sum);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) pm[r * kLdP16 + lane + 32 * jj] = __float2bfloat16(vals[jj]);
      if (lane == 0) {
        m[r] = m_next;
        l[r] = l[r] * a + sum;
        alpha[r] = a;
      }
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float a = alpha[r];
      for (int c = lane; c < kDC; c += 32) o[r * kLdO + c] *= a;
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < kDC / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
      wmma::load_matrix_sync(oc, o + warp * 16 * kLdO + n * 16, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, pm + warp * 16 * kLdP16 + kk * 16, kLdP16);
        wmma::load_matrix_sync(bm, vs + kk * 16 * kLdV16 + n * 16, kLdV16);
        wmma::mma_sync(oc, a, bm, oc);
      }
      wmma::store_matrix_sync(o + warp * 16 * kLdO + n * 16, oc, kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  __syncthreads();
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss + col0;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (r >= nq) continue;
    const float lr = l[r];
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
    for (int c = lane; c < kDC; c += 32) op[r * p.o_ss + c] = __float2bfloat16(o[r * kLdO + c] * inv);
    if (p.lse != nullptr && blockIdx.x == 0 && lane == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + q0 + r] =
          lr == 0.f ? -CUDART_INF_F : m[r] + logf(lr);
  }
}

// Copy a [rows][64] fp32 piece (row r at src + r * stride) transposed into
// dst[c][r] (ld kLdT32), zeros past `rows`. A warp reads 32 rows' same 16
// bytes and writes 32 consecutive floats of each column.
__device__ __forceinline__ void load_piece32_t(float* dst, const float* src, long long stride,
                                               int rows) {
  for (int i = threadIdx.x; i < kBQ * (kDP / 4); i += kThreads) {
    const int r = i % kBQ;
    const int c = (i / kBQ) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = *reinterpret_cast<const float4*>(src + r * stride + c);
    dst[(c + 0) * kLdT32 + r] = val.x;
    dst[(c + 1) * kLdT32 + r] = val.y;
    dst[(c + 2) * kLdT32 + r] = val.z;
    dst[(c + 3) * kLdT32 + r] = val.w;
  }
}

// fp32: thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4 ty .. 4 ty + 3
// (a warp's 16 rows), S columns 4 tx + 32 j + e (j < 2, e < 4) and O columns
// 4 tx + 32 j + e (j < 4) of the block's slice. The 8 threads of a row are
// lanes of one warp, so the softmax reduces with three shuffles.
__global__ void __launch_bounds__(kThreads)
    flash_fwd_cols_f32(const ColsParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  auto take = [&](size_t bytes) {
    unsigned char* r = ptr;
    ptr += up128(bytes);
    return r;
  };
  float* qt = reinterpret_cast<float*>(take(kDP * kLdT32 * 4));
  float* kt = reinterpret_cast<float*>(take(kDP * kLdT32 * 4));
  float* vs = reinterpret_cast<float*>(take(kBK * kLdV32 * 4));
  float* pt = reinterpret_cast<float*>(take(kBK * kLdT32 * 4));

  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int col0 = blockIdx.x * kDC;
  const int q0 = blockIdx.y * kBQ;
  const int b = blockIdx.z / p.H;
  const int h = blockIdx.z - b * p.H;
  const int nq = min(kBQ, p.Sq - q0);
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh + col0;

  float oacc[4][16];
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -CUDART_INF_F;
    lrow[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) oacc[i][c] = 0.f;
  }
  int kv_end = min(p.kv_valid, p.Skv);
  if (p.causal) kv_end = min(kv_end, q0 + nq);

  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    const int nk = min(kBK, kv_end - j0);
    float sacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) sacc[i][c] = 0.f;
    for (int d0 = 0; d0 < p.D; d0 += kDP) {
      __syncthreads();
      load_piece32_t(qt, qp + d0, p.q_ss, nq);
      load_piece32_t(kt, kp + j0 * p.k_ss + d0, p.k_ss, nk);
      if (d0 == 0) {
        for (int i = threadIdx.x; i < kBK * (kDC / 4); i += kThreads) {
          const int r = i / (kDC / 4);
          const int c = (i - r * (kDC / 4)) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < nk) val = *reinterpret_cast<const float4*>(vp + (j0 + r) * p.v_ss + c);
          *reinterpret_cast<float4*>(vs + r * kLdV32 + c) = val;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kDP; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(qt + d * kLdT32 + 4 * ty);
        const float4 k0 = *reinterpret_cast<const float4*>(kt + d * kLdT32 + 4 * tx);
        const float4 k1 = *reinterpret_cast<const float4*>(kt + d * kLdT32 + 4 * tx + 32);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[i][c] = fmaf(av[i], kv[c], sacc[i][c]);
      }
    }

    // online softmax in registers: row 4 ty + i over the 8 threads of ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 4 * tx + 32 * (c / 4) + c % 4;
        const bool ok = col < nk && (!p.causal || j0 + col <= q0 + r);
        sacc[i][c] = ok ? sacc[i][c] * p.scale : -CUDART_INF_F;
        mx = fmaxf(mx, sacc[i][c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(mrow[i], mx);
      float a = 1.f, sum = 0.f;
      if (m_next != -CUDART_INF_F) {
        a = expf(mrow[i] - m_next);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          sacc[i][c] = expf(sacc[i][c] - m_next);
          sum += sacc[i][c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) sacc[i][c] = 0.f;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      mrow[i] = m_next;
      lrow[i] = lrow[i] * a + sum;
#pragma unroll
      for (int c = 0; c < 16; ++c) oacc[i][c] *= a;
    }
    // P^T [key][row] for this warp's rows (read back by the same warp)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 4 * tx + 32 * (c / 4) + c % 4;
      *reinterpret_cast<float4*>(pt + col * kLdT32 + 4 * ty) =
          make_float4(sacc[0][c], sacc[1][c], sacc[2][c], sacc[3][c]);
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pr = *reinterpret_cast<const float4*>(pt + c * kLdT32 + 4 * ty);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + c * kLdV32 + 4 * tx + 32 * j);
        const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[i][4 * j + e] = fmaf(pv[i], vj[e], oacc[i][4 * j + e]);
      }
    }
    __syncwarp();
  }

  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nq) continue;
    const float inv = lrow[i] == 0.f ? 0.f : 1.f / lrow[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(op + r * p.o_ss + 4 * tx + 32 * j) =
          make_float4(oacc[i][4 * j] * inv, oacc[i][4 * j + 1] * inv, oacc[i][4 * j + 2] * inv,
                      oacc[i][4 * j + 3] * inv);
    if (p.lse != nullptr && blockIdx.x == 0 && tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + q0 + r] =
          lrow[i] == 0.f ? -CUDART_INF_F : mrow[i] + logf(lrow[i]);
  }
}

bool cols_head(int D) { return D == 640 || D == 1024; }

}  // namespace

// 1 when K1 at (dtype, D) runs this kernel: a head of 640 or 1024, bf16
// (dtype 1) or fp32 (dtype 0). ops/flash_attention.py:flash_schedule
// states the same rule ("cols").
extern "C" int fvt_flash_fwd_cols_route(int dtype, int D) {
  return (dtype == 0 || dtype == 1) && cols_head(D) ? 1 : 0;
}

// The dynamic shared memory a block (bytes) for dtype 0 (fp32) or 1 (bf16).
extern "C" int fvt_flash_fwd_cols_smem(int dtype) {
  return static_cast<int>(dtype == 1 ? cols_smem_bytes<bf16>() : cols_smem_bytes<float>());
}

// K1 at a head of 640 or 1024: q, k, v, o [B, S, H, D] views (element
// strides batch, head, row; unit stride along the head; 16-byte aligned
// base and row strides), lse fp32 [B, H, Sq] or null. dtype 0 = fp32,
// 1 = bf16 (one dtype for q, k, v and o).
extern "C" int fvt_flash_fwd_cols(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int dtype, int B, int H, int Sq, int Skv, int D,
                                  long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                  long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                  long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                                  float scale, int causal, int kv_valid, void* stream) {
  if (!fvt_flash_fwd_cols_route(dtype, D) || B <= 0 || H <= 0 || Sq <= 0 || Skv < 0 ||
      static_cast<long long>(B) * H > 65535 || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ColsParams p{q, k, v, o, static_cast<float*>(lse), H, Sq, Skv, D,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
               scale, causal, kv_valid};
  dim3 grid(D / kDC, (Sq + kBQ - 1) / kBQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    constexpr size_t smem = cols_smem_bytes<bf16>();
    cudaError_t err = fvt::set_smem(flash_fwd_cols_bf16, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_cols_bf16<<<grid, kThreads, smem, s>>>(p);
  } else {
    constexpr size_t smem = cols_smem_bytes<float>();
    cudaError_t err = fvt::set_smem(flash_fwd_cols_f32, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_cols_f32<<<grid, kThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

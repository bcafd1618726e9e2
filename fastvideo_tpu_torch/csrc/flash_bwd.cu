// Flash attention backward for Hopper (sm_90a): K6.
//
// Replaces the Pallas kernels fastvideo_tpu/ops/flash_attention.py:
// _bwd_dq_kernel (:310, dQ) and _bwd_dkv_kernel (:355, dK, dV), reached
// through _flash_attention_bwd_bhsd (calls :432, :459), the custom VJP of
// flash_attention. From the forward's O and fp32 log-sum-exp (K1,
// flash_fwd.cu) and delta = rowsum(dO * O) (a plain reduction in the
// caller, as it is XLA in JAX), each entry replays p = exp(s * scale - lse)
// tile by tile and never writes a score matrix to device memory. Masks:
// keys at index >= kv_valid, and causal (key <= query); and in K6 struct's
// instances (fvt_flash_bwd_struct_dq / fvt_flash_bwd_struct_dkv), the
// causal Wan training forward's chunk-causal and teacher-forcing masks
// (chunk_tokens > 0, tf_clean_len; the Pallas kernels with those arguments,
// _mask_tile and _tile_reachable :39-90). struct_mask.cuh has the rule: dQ
// walks the key ranges its rows see, as K1 struct does, and dK/dV the
// query-row ranges that see its keys.
//
// Rows with no valid key (K1 stores their LSE as -inf) have every key
// masked, so p is 0 before the exponent is used and their gradients are
// exactly 0. Padded rows in JAX get an LSE of +inf; here bounds checks do
// that job: a query row past Sq and a key past Skv are never live.
//
// What bounds it: 2 * B * H * Sq * Skv_visible * D FLOP a product, five
// products (S and dP in both kernels, dQ; dK, dV) on tensor cores, against
// reads of q, k, v, dO and writes of dq, dk, dv: operations-bound at every
// main-path shape (the SFT cross-attention q/dO [1,32760,12,128] over k/v
// [1,512,12,128], 2.58e11 FLOP; the causal Wan's self-attention at 32,760
// and 65,520 tokens, 9.4e12 and 1.9e13 FLOP). Two schedules, chosen by
// shape alone (fvt_flash_bwd_sm90 says which; no fallback between them):
//  - a head of 64 or 128, every DiT launch: flash_bwd_sm90.cuh, wgmma with
//    the sums, p and dS in registers, TMA copies through a four-stage ring,
//    two warpgroups a block. The first schedule lost its time in WMMA
//    round trips of S, dP, p, dS and the fp32 sums through shared memory
//    and in synchronous loads. At the cross-attention's 512 keys the dK/dV
//    grid (4 key tiles x 12 heads) would leave most SMs idle, so the
//    caller splits the query rows over blocks (fvt_flash_bwd_dkv_split,
//    fp32 partial sums) and fvt_flash_bwd_dkv_reduce adds them in a fixed
//    order.
//  - other heads (16, 32 and 48: the tiny models): attn_bwd_tile.cuh's
//    schedule, WMMA 16x16x16 through shared memory, 64-row tiles.
//
// Strides are in elements (batch, head, row for each tensor), so the
// caller passes [B, S, H, D] views, and autograd's dO, as they are.
#include "attn_bwd_tile.cuh"
#include "flash_bwd_sm90.cuh"
#include "struct_mask.cuh"

namespace {

using fvt::bf16;
using fvt::BwdSmem;

constexpr int kBQ = 64;
constexpr int kBK = 64;

// One block: kBQ query rows of one (batch, head); loops the key chunks.
// kStruct: K6 struct's instance (chunk_tokens / tf_clean_len in place of
// causal), a kernel of its own so the profiler names it apart.
template <bool kStruct>
__global__ void __launch_bounds__(fvt::kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Sq, int Skv, int D, long long q_sb,
                        long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss, long long dq_sb,
                        long long dq_sh, long long dq_ss, float scale, int causal, int kv_valid,
                        int chunk_tokens, int tf_clean_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  // K6 struct: the key ranges [0, a) and [b, c) each row sees
  __shared__ int span[kStruct ? 3 * kBQ : 1];
  BwdSmem<kBQ, kBK> t;
  t.carve(smem, D, 1);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int warp = threadIdx.x / 32;
  const long long stat0 = (static_cast<long long>(b) * H + h) * Sq + q0;

  t.zero_acc(1);
  fvt::load_bf16_rows(t.own0, t.ldt, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, nq, kBQ, D);
  fvt::load_bf16_rows(t.own1, t.ldt, dout + b * o_sb + h * o_sh + q0 * o_ss, o_ss, nq, kBQ, D);
  for (int r = threadIdx.x; r < kBQ; r += fvt::kThreads) {
    t.lse[r] = r < nq ? lse[stat0 + r] : 0.f;
    t.delta[r] = r < nq ? delta[stat0 + r] : 0.f;
  }
  const bf16* kp = k + b * k_sb + h * k_sh;
  const bf16* vp = v + b * v_sb + h * v_sh;

  // one key chunk of nk keys from j0: S, dP, dS, then dQ += dS K
  auto step = [&](int j0, int nk, auto live) {
    fvt::load_bf16_rows(t.str0, t.ldt, kp + j0 * k_ss, k_ss, nk, kBK, D);
    fvt::load_bf16_rows(t.str1, t.ldt, vp + j0 * v_ss, v_ss, nk, kBK, D);
    __syncthreads();
    fvt::warp_abt(t.s + warp * 16 * t.lds, t.lds, t.own0 + warp * 16 * t.ldt, t.str0, t.ldt,
                  kBK, D);
    fvt::warp_abt(t.dp + warp * 16 * t.lds, t.lds, t.own1 + warp * 16 * t.ldt, t.str1, t.ldt,
                  kBK, D);
    __syncwarp();
    fvt::grad_scores<kBK>(
        t.s, t.dp, t.lds, nullptr, t.ds, t.ldp, scale, false, live,
        [&](int r, int) { return t.lse[r]; }, [&](int r, int) { return t.delta[r]; });
    fvt::warp_acc_ab(t.acc0 + warp * 16 * t.ldo, t.ldo, t.ds + warp * 16 * t.ldp, t.ldp, t.str0,
                     t.ldt, kBK, D);
  };

  // keys past kv_end are masked for every row of this tile
  int kv_end = min(kv_valid, Skv);
  if constexpr (kStruct) {
    int* sa = span;
    int* sb = span + kBQ;
    int* sc = span + 2 * kBQ;
    for (int r = threadIdx.x; r < kBQ; r += fvt::kThreads) {
      int a = 0, b0 = 0, c = 0;
      if (r < nq) fvt::struct_row_keys(q0 + r, chunk_tokens, tf_clean_len, kv_end, a, b0, c);
      sa[r] = a;
      sb[r] = b0;
      sc[r] = c;
    }
    __syncthreads();
    const fvt::Ranges keys = fvt::struct_tile_keys(sa, sb, sc, nq);
    for (int i = 0; i < keys.n; ++i) {
      for (int j0 = keys.lo[i]; j0 < keys.hi[i]; j0 += kBK) {
        const int nk = min(kBK, keys.hi[i] - j0);
        __syncthreads();  // every warp is done with the previous chunk
        step(j0, nk, [&](int r, int c) {
          const int col = j0 + c;
          return r < nq && c < nk && (col < sa[r] || (col >= sb[r] && col < sc[r]));
        });
      }
    }
  } else {
    if (causal) kv_end = min(kv_end, q0 + nq);
    for (int j0 = 0; j0 < kv_end; j0 += kBK) {
      const int nk = min(kBK, Skv - j0);
      __syncthreads();  // every warp is done with the previous chunk
      step(j0, nk, [&](int r, int c) {
        const int col = j0 + c;
        return r < nq && col < kv_end && (!causal || col <= q0 + r);
      });
    }
  }
  __syncwarp();
  t.store(t.acc0, dq + b * dq_sb + h * dq_sh + q0 * dq_ss, dq_ss, nq);
}

// One block: kBK keys of one (batch, head); loops the query chunks that can
// see them (all of them, or from the key's own row on under causal; under
// kStruct the row ranges of struct_mask.cuh).
template <bool kStruct>
__global__ void __launch_bounds__(fvt::kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Skv,
                         int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                         long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                         long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                         long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
                         long long dv_sh, long long dv_ss, float scale, int causal,
                         int kv_valid, int chunk_tokens, int tf_clean_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  // K6 struct: the row ranges [d, e) and [f, g) that see each key
  __shared__ int span[kStruct ? 4 * kBK : 1];
  BwdSmem<kBK, kBQ> t;
  t.carve(smem, D, 2);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int nk = min(kBK, Skv - k0);
  const int warp = threadIdx.x / 32;
  const int kv_end = min(kv_valid, Skv);
  const long long stat_bh = (static_cast<long long>(b) * H + h) * Sq;
  const bf16* qp = q + b * q_sb + h * q_sh;
  const bf16* op = dout + b * o_sb + h * o_sh;

  t.zero_acc(2);
  fvt::load_bf16_rows(t.own0, t.ldt, k + b * k_sb + h * k_sh + k0 * k_ss, k_ss, nk, kBK, D);
  fvt::load_bf16_rows(t.own1, t.ldt, v + b * v_sb + h * v_sh + k0 * v_ss, v_ss, nk, kBK, D);

  // one chunk of nq query rows from i0: S^T, dP^T, p and dS, then dV += p^T dO
  // and dK += dS^T Q
  auto step = [&](int i0, int nq, auto live) {
    fvt::load_bf16_rows(t.str0, t.ldt, qp + i0 * q_ss, q_ss, nq, kBQ, D);
    fvt::load_bf16_rows(t.str1, t.ldt, op + i0 * o_ss, o_ss, nq, kBQ, D);
    for (int c = threadIdx.x; c < kBQ; c += fvt::kThreads) {
      t.lse[c] = c < nq ? lse[stat_bh + i0 + c] : 0.f;
      t.delta[c] = c < nq ? delta[stat_bh + i0 + c] : 0.f;
    }
    __syncthreads();
    // rows of s are keys, columns query rows: s = K Q^T, dp = V dO^T
    fvt::warp_abt(t.s + warp * 16 * t.lds, t.lds, t.own0 + warp * 16 * t.ldt, t.str0, t.ldt,
                  kBQ, D);
    fvt::warp_abt(t.dp + warp * 16 * t.lds, t.lds, t.own1 + warp * 16 * t.ldt, t.str1, t.ldt,
                  kBQ, D);
    __syncwarp();
    fvt::grad_scores<kBQ>(
        t.s, t.dp, t.lds, t.p, t.ds, t.ldp, scale, true, live,
        [&](int, int c) { return t.lse[c]; }, [&](int, int c) { return t.delta[c]; });
    // dV += p^T dO, dK += dS^T Q (p and dS are stored key-major already)
    fvt::warp_acc_ab(t.acc1 + warp * 16 * t.ldo, t.ldo, t.p + warp * 16 * t.ldp, t.ldp, t.str1,
                     t.ldt, kBQ, D);
    fvt::warp_acc_ab(t.acc0 + warp * 16 * t.ldo, t.ldo, t.ds + warp * 16 * t.ldp, t.ldp, t.str0,
                     t.ldt, kBQ, D);
  };

  if constexpr (kStruct) {
    int* sd = span;
    int* se = span + kBK;
    int* sf = span + 2 * kBK;
    int* sg = span + 3 * kBK;
    for (int r = threadIdx.x; r < kBK; r += fvt::kThreads) {
      int d = 0, e = 0, f = 0, g = 0;
      if (r < nk)
        fvt::struct_key_rows(k0 + r, chunk_tokens, tf_clean_len, Sq, kv_end, d, e, f, g);
      sd[r] = d;
      se[r] = e;
      sf[r] = f;
      sg[r] = g;
    }
    __syncthreads();
    const fvt::Ranges rows = fvt::struct_tile_rows(sd, se, sf, sg, nk, k0, tf_clean_len);
    for (int i = 0; i < rows.n; ++i) {
      for (int i0 = rows.lo[i]; i0 < rows.hi[i]; i0 += kBQ) {
        const int nq = min(kBQ, rows.hi[i] - i0);
        __syncthreads();  // every warp is done with the previous chunk
        step(i0, nq, [&](int r, int c) {
          const int row = i0 + c;
          return c < nq && ((row >= sd[r] && row < se[r]) || (row >= sf[r] && row < sg[r]));
        });
      }
    }
  } else {
    // a tile wholly past kv_valid gets zero gradients (k0 is block-uniform)
    const int i_start = causal ? (k0 / kBQ) * kBQ : 0;
    for (int i0 = i_start; k0 < kv_end && i0 < Sq; i0 += kBQ) {
      const int nq = min(kBQ, Sq - i0);
      __syncthreads();  // every warp is done with the previous chunk
      step(i0, nq, [&](int r, int c) {
        const int key = k0 + r;
        return c < nq && key < kv_end && (!causal || key <= i0 + c);
      });
    }
  }
  __syncwarp();
  t.store(t.acc0, dk + b * dk_sb + h * dk_sh + k0 * dk_ss, dk_ss, nk);
  t.store(t.acc1, dv + b * dv_sb + h * dv_sh + k0 * dv_ss, dv_ss, nk);
}

bool bad_shape(int B, int H, int Sq, int Skv, int D) {
  return D % 16 != 0 || D > 128 || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0;
}

// Whether a head of D takes the Hopper schedule (the backward is bf16 only).
// ops/flash_attention.py:flash_schedule states the same rule.
bool use_sm90(int D) { return D == 64 || D == 128; }

fvt::sm90::BwdMasks masks(int Sq, int Skv, float scale, int causal, int kv_valid,
                          int chunk_tokens, int tf_clean_len) {
  return fvt::sm90::BwdMasks{Sq,           Skv,   causal, kv_valid, chunk_tokens,
                             tf_clean_len, scale, scale * fvt::sm90::kLog2e};
}

template <int D, bool kStruct>
int launch_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int H, int Sq, int Skv,
                   const long long* st, const fvt::sm90::BwdMasks& m, cudaStream_t stream) {
  namespace s9 = fvt::sm90;
  s9::DqParams p;
  if (!s9::map_bshd(&p.q, q, B, Sq, H, D, st[0], st[1], st[2], s9::kBwdOwn) ||
      !s9::map_bshd(&p.dout, dout, B, Sq, H, D, st[9], st[10], st[11], s9::kBwdOwn) ||
      !s9::map_bshd(&p.k, k, B, Skv, H, D, st[3], st[4], st[5], s9::kBwdStep) ||
      !s9::map_bshd(&p.v, v, B, Skv, H, D, st[6], st[7], st[8], s9::kBwdStep))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dq_sb = st[12];
  p.dq_sh = st[13];
  p.dq_ss = st[14];
  p.H = H;
  p.n_tiles = (Sq + s9::kBwdOwn - 1) / s9::kBwdOwn;
  p.m = m;
  if (p.n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = s9::dq_smem_bytes<D, kStruct>();
  cudaError_t err = s9::set_smem(s9::flash_bwd_dq_sm90<D, kStruct>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::flash_bwd_dq_sm90<D, kStruct><<<dim3(H, B, p.n_tiles), s9::kBwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV over `splits` ranges of query rows: splits == 1 writes dk and dv
// (bf16); splits > 1 writes fp32 partial sums to part_k / part_v
// [splits, B, H, Skv, D] for fvt_flash_bwd_dkv_reduce.
template <int D, bool kStruct>
int launch_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, void* part_k,
                    void* part_v, int splits, int B, int H, int Sq, int Skv,
                    const long long* st, const fvt::sm90::BwdMasks& m, cudaStream_t stream) {
  namespace s9 = fvt::sm90;
  s9::DkvParams p;
  const long long n_stats = static_cast<long long>(B) * H * Sq;
  if (!s9::map_bshd(&p.k, k, B, Skv, H, D, st[3], st[4], st[5], s9::kBwdOwn) ||
      !s9::map_bshd(&p.v, v, B, Skv, H, D, st[6], st[7], st[8], s9::kBwdOwn) ||
      !s9::map_bshd(&p.q, q, B, Sq, H, D, st[0], st[1], st[2], s9::kBwdStep) ||
      !s9::map_bshd(&p.dout, dout, B, Sq, H, D, st[9], st[10], st[11], s9::kBwdStep) ||
      !s9::map_f32(&p.lse, lse, n_stats, s9::kStatBox) ||
      !s9::map_f32(&p.delta, delta, n_stats, s9::kStatBox))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  if (splits == 1) {
    p.dk_sb = st[12];
    p.dk_sh = st[13];
    p.dk_ss = st[14];
    p.dv_sb = st[15];
    p.dv_sh = st[16];
    p.dv_ss = st[17];
  }
  p.part_k = static_cast<float*>(part_k);
  p.part_v = static_cast<float*>(part_v);
  p.B = B;
  p.H = H;
  p.n_tiles = (Skv + s9::kBwdOwn - 1) / s9::kBwdOwn;
  p.splits = splits;
  const int steps = (Sq + s9::kBwdStep - 1) / s9::kBwdStep;
  p.split_rows = (steps + splits - 1) / splits * s9::kBwdStep;
  p.m = m;
  if (static_cast<long long>(p.n_tiles) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = s9::dkv_smem_bytes<D, kStruct>();
  cudaError_t err = s9::set_smem(s9::flash_bwd_dkv_sm90<D, kStruct>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s9::flash_bwd_dkv_sm90<D, kStruct>
      <<<dim3(H, B, p.n_tiles * splits), s9::kBwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStruct>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int Sq, int Skv, int D,
              const long long* st, float scale, int causal, int kv_valid, int chunk_tokens,
              int tf_clean_len, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (use_sm90(D)) {
    const auto m = masks(Sq, Skv, scale, causal, kv_valid, chunk_tokens, tf_clean_len);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 64)
      return launch_dq_sm90<64, kStruct>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st, m, s);
    return launch_dq_sm90<128, kStruct>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st, m, s);
  }
  const size_t smem = BwdSmem<kBQ, kBK>::bytes(D, 1);
  cudaError_t err = fvt::set_smem(flash_bwd_dq_kernel<kStruct>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<kStruct><<<grid, fvt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Sq, Skv, D, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14], scale, causal, kv_valid, chunk_tokens, tf_clean_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStruct>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int Sq, int Skv, int D,
               const long long* st, float scale, int causal, int kv_valid, int chunk_tokens,
               int tf_clean_len, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (use_sm90(D)) {
    const auto m = masks(Sq, Skv, scale, causal, kv_valid, chunk_tokens, tf_clean_len);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 64)
      return launch_dkv_sm90<64, kStruct>(q, k, v, dout, lse, delta, dk, dv, nullptr, nullptr, 1,
                                          B, H, Sq, Skv, st, m, s);
    return launch_dkv_sm90<128, kStruct>(q, k, v, dout, lse, delta, dk, dv, nullptr, nullptr, 1,
                                         B, H, Sq, Skv, st, m, s);
  }
  const size_t smem = BwdSmem<kBK, kBQ>::bytes(D, 2);
  cudaError_t err = fvt::set_smem(flash_bwd_dkv_kernel<kStruct>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Skv + kBK - 1) / kBK, H, B);
  flash_bwd_dkv_kernel<kStruct><<<grid, fvt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq,
      Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14], st[15], st[16], st[17], scale, causal, kv_valid,
      chunk_tokens, tf_clean_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a head of D runs the Hopper schedule (flash_bwd_sm90.cuh), 0 when
// it runs attn_bwd_tile.cuh's.
extern "C" int fvt_flash_bwd_sm90(int D) { return use_sm90(D) ? 1 : 0; }

// The Hopper schedule's dynamic shared memory a block (bytes): kind 0 dQ,
// 1 dK/dV; a head of D (64 or 128); struct 1 for K6 struct's instances.
extern "C" int fvt_flash_bwd_sm90_smem(int kind, int D, int is_struct) {
  namespace s9 = fvt::sm90;
  const bool d64 = D == 64;
  size_t n;
  if (kind == 0)
    n = is_struct ? (d64 ? s9::dq_smem_bytes<64, true>() : s9::dq_smem_bytes<128, true>())
                  : (d64 ? s9::dq_smem_bytes<64, false>() : s9::dq_smem_bytes<128, false>());
  else
    n = is_struct ? (d64 ? s9::dkv_smem_bytes<64, true>() : s9::dkv_smem_bytes<128, true>())
                  : (d64 ? s9::dkv_smem_bytes<64, false>() : s9::dkv_smem_bytes<128, false>());
  return static_cast<int>(n);
}

// bfloat16 only, D a multiple of 16 up to 128. lse and delta are fp32
// [B, H, Sq] contiguous; strides in elements (batch, head, row) for q, k, v,
// dO and dq.
extern "C" int fvt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int H,
                                int Sq, int Skv, int D, long long q_sb, long long q_sh,
                                long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                                long long o_sh, long long o_ss, long long dq_sb, long long dq_sh,
                                long long dq_ss, float scale, int causal, int kv_valid,
                                void* stream) {
  const long long st[15] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                            v_ss, o_sb, o_sh, o_ss, dq_sb, dq_sh, dq_ss};
  return launch_dq<false>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D, st, scale, causal,
                          kv_valid, 0, 0, stream);
}

// As fvt_flash_bwd_dq, writing dk and dv (strides batch, head, row each).
extern "C" int fvt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B,
                                 int H, int Sq, int Skv, int D, long long q_sb, long long q_sh,
                                 long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                 long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                                 long long o_sh, long long o_ss, long long dk_sb,
                                 long long dk_sh, long long dk_ss, long long dv_sb,
                                 long long dv_sh, long long dv_ss, float scale, int causal,
                                 int kv_valid, void* stream) {
  const long long st[18] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            o_sb, o_sh, o_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  return launch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, D, st, scale,
                           causal, kv_valid, 0, 0, stream);
}

// K6 struct: as fvt_flash_bwd_dq with the chunk-causal (chunk_tokens > 0,
// tf_clean_len 0) or teacher-forcing (both > 0) mask in place of causal.
extern "C" int fvt_flash_bwd_struct_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int B, int H, int Sq, int Skv, int D,
                                       long long q_sb, long long q_sh, long long q_ss,
                                       long long k_sb, long long k_sh, long long k_ss,
                                       long long v_sb, long long v_sh, long long v_ss,
                                       long long o_sb, long long o_sh, long long o_ss,
                                       long long dq_sb, long long dq_sh, long long dq_ss,
                                       float scale, int kv_valid, int chunk_tokens,
                                       int tf_clean_len, void* stream) {
  if (chunk_tokens <= 0 || tf_clean_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                            v_ss, o_sb, o_sh, o_ss, dq_sb, dq_sh, dq_ss};
  return launch_dq<true>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D, st, scale, 0,
                         kv_valid, chunk_tokens, tf_clean_len, stream);
}

// K6 struct: as fvt_flash_bwd_dkv with the mask of fvt_flash_bwd_struct_dq.
extern "C" int fvt_flash_bwd_struct_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int H, int Sq, int Skv, int D,
                                        long long q_sb, long long q_sh, long long q_ss,
                                        long long k_sb, long long k_sh, long long k_ss,
                                        long long v_sb, long long v_sh, long long v_ss,
                                        long long o_sb, long long o_sh, long long o_ss,
                                        long long dk_sb, long long dk_sh, long long dk_ss,
                                        long long dv_sb, long long dv_sh, long long dv_ss,
                                        float scale, int kv_valid, int chunk_tokens,
                                        int tf_clean_len, void* stream) {
  if (chunk_tokens <= 0 || tf_clean_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[18] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            o_sb, o_sh, o_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  return launch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, D, st, scale, 0,
                          kv_valid, chunk_tokens, tf_clean_len, stream);
}

// K6 / K6 struct dK/dV (chunk_tokens > 0 names the struct mask, as in
// fvt_flash_bwd_struct_dkv) with the query rows cut into `splits` ranges
// over the grid: fp32 partial sums into part_k and part_v [splits, B, H,
// Skv, D] (contiguous), for fvt_flash_bwd_dkv_reduce. Hopper schedule only
// (D 64 or 128); strides as fvt_flash_bwd_dkv's first 12.
extern "C" int fvt_flash_bwd_dkv_split(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* part_k, void* part_v, int B, int H, int Sq, int Skv,
                                       int D, long long q_sb, long long q_sh, long long q_ss,
                                       long long k_sb, long long k_sh, long long k_ss,
                                       long long v_sb, long long v_sh, long long v_ss,
                                       long long o_sb, long long o_sh, long long o_ss,
                                       float scale, int causal, int kv_valid, int chunk_tokens,
                                       int tf_clean_len, int splits, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D) || !use_sm90(D) || splits < 1 || tf_clean_len < 0 ||
      part_k == nullptr || part_v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[18] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            o_sb, o_sh, o_ss, 0,    0,    0,    0,    0,    0};
  const auto m = masks(Sq, Skv, scale, chunk_tokens > 0 ? 0 : causal, kv_valid, chunk_tokens,
                       tf_clean_len);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk_tokens > 0) {
    if (D == 64)
      return launch_dkv_sm90<64, true>(q, k, v, dout, lse, delta, nullptr, nullptr, part_k,
                                       part_v, splits, B, H, Sq, Skv, st, m, s);
    return launch_dkv_sm90<128, true>(q, k, v, dout, lse, delta, nullptr, nullptr, part_k,
                                      part_v, splits, B, H, Sq, Skv, st, m, s);
  }
  if (D == 64)
    return launch_dkv_sm90<64, false>(q, k, v, dout, lse, delta, nullptr, nullptr, part_k,
                                      part_v, splits, B, H, Sq, Skv, st, m, s);
  return launch_dkv_sm90<128, false>(q, k, v, dout, lse, delta, nullptr, nullptr, part_k,
                                     part_v, splits, B, H, Sq, Skv, st, m, s);
}

// dk, dv (bf16 [B, Skv, H, D] views, strides batch, head, row) = the sum of
// fvt_flash_bwd_dkv_split's `splits` partial sums, added in split order.
extern "C" int fvt_flash_bwd_dkv_reduce(const void* part_k, const void* part_v, void* dk,
                                        void* dv, int splits, int B, int H, int Skv, int D,
                                        long long dk_sb, long long dk_sh, long long dk_ss,
                                        long long dv_sb, long long dv_sh, long long dv_ss,
                                        void* stream) {
  if (splits < 1 || B <= 0 || H <= 0 || Skv <= 0 || D % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = static_cast<long long>(B) * H * Skv * D / 4;
  const int threads = 256;
  const long long blocks = (groups + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  fvt::sm90::flash_bwd_dkv_reduce<<<static_cast<unsigned>(blocks), threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_k), static_cast<const float*>(part_v),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), splits, B, H, Skv, D, dk_sb, dk_sh, dk_ss,
      dv_sb, dv_sh, dv_ss);
  return static_cast<int>(cudaGetLastError());
}

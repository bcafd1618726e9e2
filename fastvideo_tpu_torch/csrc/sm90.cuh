// Hopper (sm_90a) building blocks of the dense flash attention kernels
// (flash_fwd_sm90.cuh, flash_bwd_sm90.cuh) and of the sparse ones built on
// them (vsa_sparse_bwd_sm90.cuh, dyn_sparse_fwd_sm90.cuh): warpgroup
// products (wgmma) with fp32 sums in registers, tensor-memory copies (TMA)
// that complete to mbarriers, the host-side tensor maps over [B, S, H, D]
// views and over tile-major [B, H, nT, E, D] views, and the walks: a range
// walk (Walk) for the dense kernels, a list walk (TileList, Cursor) for the
// sparse ones.
//
// Layout: every bf16 tile in shared memory is held as column blocks of 64
// values (128 bytes) a row, as TMA writes a box of {64, rows} with the
// 128-byte swizzle; a tile with a head of 128 is two such blocks, one after
// the other. Each block starts 1024-byte aligned, so the swizzle (16-byte
// chunk c of row r stored at chunk c ^ (r % 8)) is the one the wgmma
// descriptors assume.
//  - K-major operand (the reduction runs along the 64-value rows: Q, K, dO
//    and V as the B of S = Q K^T and dP = dO V^T): 8-row groups 1024 bytes
//    apart (SBO); a 16-value step along K moves the start 32 bytes, and the
//    fifth step starts the next column block.
//  - MN-major operand (the reduction runs down the rows: V in O += P V, K in
//    dQ += dS K, dO and Q in dV += P^T dO and dK += dS^T Q): 8-row groups
//    1024 bytes apart (SBO), the second column block LBO bytes on (a
//    block's size); a 16-row step along K moves the start 2048 bytes.
//
// Fragments: a warpgroup's accumulator of a 64 x N product holds, in thread
// t (warp w = t / 32 of the warpgroup, lane l), element i at row
// 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l % 4) + (i & 1).
// For 16-bit operands that is also the register A fragment of the next
// product: columns 16 kk .. 16 kk + 15 of an accumulator, rounded to bf16
// and paired, are the A operand of step kk (a_r = (d[8 kk + 2 r],
// d[8 kk + 2 r + 1])), so P and dS never leave registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace fvt {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroup = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA data to come.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bar_wait with acquire at cluster scope: for data that other blocks of the
// cluster stored into this block's shared memory (st_async_v4).
__device__ __forceinline__ void bar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// -- clusters ------------------------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every block of the cluster arrives, then waits for all of
// them (what each wrote before, barrier initialisations included, is
// visible to the whole cluster after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The shared::cluster address of `p` (in this block's shared memory) in the
// block of rank `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// 16 bytes stored at `addr` in another block's shared memory (shared::cluster
// addresses from mapa), completing their bytes to that block's mbarrier
// `bar`, which expects them (bar_expect).
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// -- TMA ---------------------------------------------------------------------

// A box of a 4-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A box of a 5-D tensor map (map_tiles) into shared memory.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// K-major operand: rows [row0, row0 + 64 or N) of a tile of `rows` rows,
// reduction step kk (16 values).
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows, int row0, int kk) {
  const char* p = reinterpret_cast<const char*>(tile) + (kk / 4) * rows * 128 + row0 * 128 +
                  (kk % 4) * 32;
  return desc(p, 16, 1024);
}

// MN-major operand: reduction step kk (rows 16 kk .. 16 kk + 15) of a tile
// of `rows` rows, all of its columns.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows, int kk) {
  return desc(reinterpret_cast<const char*>(tile) + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous product owns across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns 16 kk .. 16 kk + 15 of an fp32 accumulator as the bf16 A fragment
// of reduction step kk.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// D[64 x 64] = A B (acc 0) or D += A B (acc 1), A and B in shared memory,
// both K-major with the 128-byte swizzle.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A B, A a 64 x 16 bf16 fragment in registers, B in shared
// memory, MN-major (transposed) with the 128-byte swizzle.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 128] = A B (acc 0) or D += A B (acc 1), A and B in shared memory,
// both K-major with the 128-byte swizzle.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 128] (+)= A B, A a 64 x 16 bf16 fragment in registers, B in shared
// memory, MN-major (transposed) with the 128-byte swizzle.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64)
    mma_ss_n64(d, da, db, acc);
  else
    mma_ss_n128(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (N == 64)
    mma_rs_n64(d, a, db, acc);
  else
    mma_rs_n128(d, a, db, acc);
}

// Four 8 x 8 matrices of 16-bit values from shared memory (each lane gives
// one row address); a 32-bit value moves as a pair of halves, so four
// matrices of 8 rows x 4 fp32 are a TF32 A fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// fp32 rounded to TF32, to nearest with ties away from zero (low 13 bits
// cleared).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Row and column of accumulator element i in this thread (warpgroup-relative).
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x % kWarpgroup;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// The sum over the 4 threads that hold one accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// -- walking a tile's other side ----------------------------------------------

// Up to three disjoint ranges [lo, hi) of keys (or query rows), walked in
// steps of `step` from each range's start; step i is rows [start, start +
// step), of which those below `end` are in the range.
struct Walk {
  int lo[3], hi[3], n = 0, steps = 0;

  __device__ __forceinline__ void add(int a, int b, int step) {
    if (a >= b) return;
    lo[n] = a;
    hi[n] = b;
    ++n;
    steps += (b - a + step - 1) / step;
  }

  __device__ __forceinline__ void at(int i, int step, int& start, int& end) const {
    for (int r = 0; r < n; ++r) {
      const int k = (hi[r] - lo[r] + step - 1) / step;
      if (i < k) {
        start = lo[r] + i * step;
        end = hi[r];
        return;
      }
      i -= k;
    }
    start = end = 0;
  }
};

// -- host ----------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a bf16 [B, S, H, D] view (element strides sb, sh, ss; unit
// stride along D) whose box is {64, rows}: one 64-column block of `rows`
// rows of one (batch, head), 128-byte swizzled. Rows past S read as zero.
inline bool map_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                     long long sb, long long sh, long long ss, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  // a dimension of size 1 is never stepped: give it a packed stride, since a
  // view may carry any stride there
  const long long packed[3] = {D, static_cast<long long>(D) * S,
                               static_cast<long long>(D) * S * H};
  const long long given[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(2 * (dims[i + 1] == 1 ? packed[i] : given[i]));
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rows of a tile a list walk (TileList) takes at a time.
constexpr int kUnit = 64;

// A map over a bf16 tile-major [B, H, nT, E, D] view (element strides sb,
// sh of batch and head, ss of a row, so tile t starts t E ss on; unit
// stride along D) whose box is {64, kUnit}: one 64-column block of kUnit
// rows of one tile, 128-byte swizzled. Rows past a tile's E read as zero,
// not as the next tile's rows.
inline bool map_tiles(CUtensorMap* map, const void* base, int B, int H, int nT, int E, int D,
                      long long sb, long long sh, long long ss) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(E),
                              static_cast<cuuint64_t>(nT), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long packed[4] = {D, static_cast<long long>(D) * E,
                               static_cast<long long>(D) * E * nT,
                               static_cast<long long>(D) * E * nT * H};
  const long long given[4] = {ss, ss * E, sh, sb};
  cuuint64_t strides[4];
  for (int i = 0; i < 4; ++i)
    strides[i] = static_cast<cuuint64_t>(2 * (dims[i + 1] == 1 ? packed[i] : given[i]));
  const cuuint32_t box[5] = {64, kUnit, 1, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over n fp32 values whose box is `count` consecutive ones (past n:
// zero).
inline bool map_f32(CUtensorMap* map, const void* base, long long n, int count) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {16};  // unused at rank 1
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(count)};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into the dynamic shared memory it needs (above 48 KB).
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__host__ __device__ constexpr size_t round_1k(size_t n) { return (n + 1023) / 1024 * 1024; }

// The shared memory a kernel carves from its dynamic allocation, 1024-byte
// aligned (the allocation carries 1024 bytes of slack for it).
struct Carve {
  unsigned char* p;
  __device__ explicit Carve(unsigned char* base)
      : p(base + ((1024 - (smem_u32(base) & 1023)) & 1023)) {}
  template <typename T>
  __device__ T* take(size_t count) {
    T* out = reinterpret_cast<T*>(p);
    p += (count * sizeof(T) + 1023) / 1024 * 1024;
    return out;
  }
};

// The copy ring of a block of kWarps consumer warps (two warpgroups by
// default): NS stages of streamed tiles, stage s's copies completing to
// full[s] and its readers (every warp) to empty[s], and the block's own
// tiles completing to `own`. Thread 0 issues every copy.
template <int NS, int kWarps = 2 * kWarpgroup / 32>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own;

  __host__ __device__ static constexpr size_t bytes() { return round_1k((2 * NS + 1) * 8); }

  // Carves and initialises the barriers; a __syncthreads() must follow
  // before any thread uses them.
  __device__ explicit Ring(Carve& carve) {
    full = carve.take<uint64_t>(2 * NS + 1);
    empty = full + NS;
    own = full + 2 * NS;
    if (threadIdx.x == 0) {
      for (int s = 0; s < NS; ++s) {
        bar_init(&full[s], 1);
        bar_init(&empty[s], kWarps);  // one arrival a warp
      }
      bar_init(own, 1);
      bar_fence_init();
    }
  }

  // Wait for chunk i's copies.
  __device__ void wait(int i) const { bar_wait(&full[i % NS], (i / NS) & 1); }

  // This warp is done reading chunk i's stage; thread 0 refills it with
  // chunk i + NS (issue(i + NS)) once every warp is.
  template <class Issue>
  __device__ void release(int i, int n_steps, Issue& issue) const {
    if (threadIdx.x % 32 == 0) bar_arrive(&empty[i % NS]);
    if (threadIdx.x == 0 && i + NS < n_steps) {
      bar_wait(&empty[i % NS], (i / NS) & 1);
      issue(i + NS);
    }
    __syncwarp();
  }

  // This warp is done reading chunk i's stage; a producer warp of its own
  // refills it.
  __device__ void arrive(int i) const {
    if (threadIdx.x % 32 == 0) bar_arrive(&empty[i % NS]);
    __syncwarp();
  }
};

// -- walking a list of tiles (the sparse kernels) -----------------------------

// A block's list of tiles in shared memory: per entry its tile id, its
// valid rows (0 for a -1 slot) and, where the walk is shared by several
// query tiles, the bit set of those that keep it. Entry j is walked in
// units of kUnit rows: unit c is rows [c kUnit, c kUnit + kUnit) of tile
// id[j], of which the first valid[j] - c kUnit (at most kUnit) are valid.
struct TileList {
  int* id;
  int* valid;
  int* bits;  // or null
  int* total;  // units of the whole walk
  int n = 0;

  __host__ __device__ static constexpr size_t bytes(int cap, bool with_bits) {
    return round_1k(((with_bits ? 3 : 2) * static_cast<size_t>(cap) + 1) * 4);
  }

  __device__ TileList(Carve& carve, int cap, bool with_bits) {
    total = carve.take<int>((with_bits ? 3 : 2) * static_cast<size_t>(cap) + 1);
    id = total + 1;
    valid = id + cap;
    bits = with_bits ? valid + cap : nullptr;
  }

  // Every thread of the block: copy entries [0, count) of `ids` (and
  // `bits_g`; null: every entry is kept by the group's one tile), a tile's
  // valid rows min(sizes[tile], E) (E where `sizes` is null), and sum the
  // walk's units. Holds two __syncthreads().
  __device__ void build(const int* ids, const int* bits_g, int count, const int* sizes, int E) {
    n = count;
    if (threadIdx.x == 0) *total = 0;
    __syncthreads();
    int units = 0;
    for (int t = threadIdx.x; t < count; t += blockDim.x) {
      const int tile = __ldg(ids + t);
      const int v = tile < 0 ? 0 : (sizes == nullptr ? E : max(0, min(__ldg(sizes + tile), E)));
      id[t] = tile;
      valid[t] = v;
      if (bits != nullptr) bits[t] = bits_g == nullptr ? 1 : __ldg(bits_g + t);
      units += (v + kUnit - 1) / kUnit;
    }
    if (units > 0) atomicAdd(total, units);
    __syncthreads();
  }
};

// A position in a TileList's walk, advanced one unit at a time; each
// walker (the thread that issues the copies, each consumer thread) keeps
// its own, so issuing a unit never waits on the consumers.
struct Cursor {
  int j = 0, c = 0;

  __device__ void start(const TileList& l) {
    j = 0;
    c = 0;
    skip(l);
  }
  __device__ void skip(const TileList& l) {
    while (j < l.n && l.valid[j] == 0) ++j;
  }
  __device__ void next(const TileList& l) {
    if (++c * kUnit >= l.valid[j]) {
      c = 0;
      ++j;
      skip(l);
    }
  }
  __device__ int tile(const TileList& l) const { return l.id[j]; }
  __device__ int rows(const TileList& l) const { return min(l.valid[j] - c * kUnit, kUnit); }
  __device__ int row0() const { return c * kUnit; }
};

}  // namespace sm90
}  // namespace fvt

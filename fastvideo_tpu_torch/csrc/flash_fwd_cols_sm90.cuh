// The flash attention forward at the wide heads of the Wan2.2 VAE on Hopper
// (sm_90a): K1 at a head of 640 or 1024, bf16 and fp32. flash_fwd_cols.cu
// launches it. It replaces the Pallas kernel
// fastvideo_tpu/ops/flash_attention.py:_fwd_kernel (:93, reached through
// _flash_attention_fwd_bhsd, call :222) as the Wan2.2 VAE calls it
// (fastvideo_tpu/models/vaes/wan.py:WanAttentionBlock, :285, :306-307): one
// head over the tokens of a latent frame (3,520 at 704x1280), 1024 wide in
// the decoder (bf16) and 640 in the encoder (fp32), q, k and v column views
// of one qkv tensor. It computes what the other K1 forms compute:
// softmax(Q K^T * scale) V with fp32 scores and statistics, P rounded to the
// value type before P V (bf16; the fp32 form keeps P in fp32), the output
// in the input type, the LSE in fp32, and 0 (LSE -inf) for a row with no
// valid key (keys at index >= kv_valid, and causal: key <= query).
//
// What bounds it: 4 D FLOP a (query, key) pair on the tensor cores (5.07e10
// a frame at 1024), about 2,300 FLOP a byte of unique input. A 64-row query
// tile cannot live on one SM at these heads: 64 rows of O in fp32 are the
// whole register file at 1024 (256 KB), and a 64-row Q tile is 128 KB of
// bf16. So the head is split over a cluster of CTAs on neighbouring SMs,
// and S is built once:
//  - a cluster of C CTAs owns a 64-row query tile; CTA r owns head columns
//    [r D / C, (r + 1) D / C) for both the S contraction and O, and its two
//    consumer warpgroups a half of those each (DW columns): bf16 C = 2 (DW
//    256 at 1024, 160 at 640), fp32 C = 4 (DW 128 / 80; fp32 tiles are
//    twice as large, and at C = 2 the 1024 form's Q half alone is 128 KB);
//  - for each chunk of kColsBK = 32 keys each warpgroup computes a partial S
//    over its DW columns (wgmma, fp32 sums); the 2C partials are summed in
//    one fixed order, the two warpgroups of a CTA through shared memory,
//    then the C CTA sums through distributed shared memory (st.async into
//    every other CTA's slot, completing to its mbarrier): a balanced tree,
//    ((p0 + p1) + (p2 + p3)) [+ ((p4 + p5) + (p6 + p7))], which every
//    warpgroup of the cluster evaluates to the same bits (fp32 addition
//    commutes), so all of them hold the same S, row max, row sum and P;
//  - each warpgroup then runs the online softmax and adds P V for its own
//    DW columns of O, which stay in registers (128 a thread at most).
// The products are the needed 4 B Sq Skv D (once each); the exchange is 8
// KB a CTA and peer a chunk. Loads: a producer warpgroup (one thread of it
// issues, setmaxnreg gives its registers to the consumers) keeps the CTA's
// Q columns resident and streams its K and V columns chunk by chunk through
// a ring of TMA stages completing to mbarriers; no load in the main loop is
// synchronous. A chunk's S is issued while the previous chunk's P V runs.
//
// What holds it (PERF.md; scripts/torch_cols_exchange_cost.py cuts each
// part out in turn): the exchange (about a quarter of the time), the S
// products on 32-key tiles (N = 32: they re-read Q from shared memory at
// every k-step) and the waits for K and V, each a comparable share, with
// the cluster's CTAs in step once a chunk. Four other schedules were timed
// and none was faster: S of the next chunk issued before the exchange
// (ptxas serialized the wgmma, C7515), P V of the previous chunk overlapping
// the exchange, one exchange every 64 keys (a step needs 128 KB of K and V,
// more than the ring holds), and two query tiles a cluster sharing K and V
// by TMA multicast (1.6x slower: four CTAs in step).
//
// bf16: S on wgmma m64n32k16 with Q and K from shared memory (K-major), P
// as register A fragments of O += P V (wgmma m64nDWk16, V MN-major; each
// warpgroup's V columns start a 64-column box of their own, so at 640 a
// warpgroup's 160 columns are three boxes, 32 columns of the last unused).
// fp32: 3xTF32 (hi hi + hi lo + lo hi, cvt.rna heads and tails) as in
// flash_fwd_wide_tf32_sm90.cuh: a pre-pass (cols_tf32_split) writes K's
// TF32 heads and tails and V^T's (keys 0 2 4 6 1 3 5 7 in each 8, so P's
// accumulator fragment is its A fragment of P V), Q's fragments come from
// shared memory by ldmatrix and are split in registers, and a chunk streams
// as four units (K hi, K lo, V^T lo, V^T hi).
#pragma once

#include "sm90.cuh"

namespace fvt {
namespace sm90 {

constexpr int kColsBQ = 64;  // query rows a cluster
constexpr int kColsBK = 32;  // keys a chunk
constexpr int kColsThreads = 3 * kWarpgroup;  // two consumer warpgroups, a producer
constexpr int kColsMaxStages = 4;
constexpr size_t kColsSmemMax = 232448;  // a block's dynamic shared memory
// one warpgroup's S (64 x kColsBK fp32) in an exchange slot: float4 [4][128],
// thread t's values 4 g .. 4 g + 3 at [g][t]
constexpr int kColsSlotF4 = 4 * kWarpgroup;
constexpr uint32_t kColsSlot = kColsSlotF4 * 16;

// The schedule's sizes for a head of D: Bf16 1 (bf16) or 0 (fp32).
template <int D, int Bf16>
struct ColsShape {
  static constexpr int C = Bf16 ? 2 : 4;  // CTAs a cluster
  static constexpr int DC = D / C;        // head columns a CTA
  static constexpr int DW = DC / 2;       // head columns a consumer warpgroup
  static constexpr int ESZ = Bf16 ? 2 : 4;
  static constexpr int BOX = 128 / ESZ;   // columns a 128-byte TMA box
  static constexpr int NQB = DC / BOX;    // Q's and K's boxes a CTA
  static constexpr int NVB = (DW + 63) / 64;  // bf16: V's boxes a warpgroup
  static constexpr int KSTEP = Bf16 ? 16 : 8;
  static constexpr int KS = DW / KSTEP;   // a warpgroup's k-steps of S
  static constexpr size_t Q_BYTES = static_cast<size_t>(kColsBQ) * DC * ESZ;
  static constexpr size_t UNIT =
      Bf16 ? (NQB > 2 * NVB ? NQB : 2 * NVB) * kColsBK * 128 : static_cast<size_t>(kColsBK) * DC * 4;
  // alignment slack, Q, the local exchange (2 buffers x 2 warpgroups), the
  // cluster exchange (2 buffers x C - 1 peers), the ring's and the
  // exchange's barriers
  static constexpr size_t FIXED = 1024 + round_1k(Q_BYTES) + 4 * kColsSlot +
                                  2 * (C - 1) * kColsSlot + 2048;
  static constexpr int NS_FIT = static_cast<int>((kColsSmemMax - FIXED) / UNIT);
  static constexpr int NS = NS_FIT < kColsMaxStages ? NS_FIT : kColsMaxStages;
  static constexpr size_t SMEM = FIXED + NS * UNIT;
  static_assert(DC % BOX == 0 && DW % KSTEP == 0 && NS >= 2, "a head of 640 or 1024");
  static_assert(UNIT % 1024 == 0 && SMEM <= kColsSmemMax, "the ring fits");
};

struct ColsParams {
  CUtensorMap q;             // bf16 box {64, 64}; fp32 box {32, 64}
  CUtensorMap k, v;          // bf16: [B, S, H, D] views, box {64, 32}
  CUtensorMap k_hi, k_lo;    // fp32: [B, H, Skv_pad, D], box {32, 32}
  CUtensorMap vt_hi, vt_lo;  // fp32: [B, H, D, Skv_pad], box {32, D / 4}
  void* o;                   // [B, Sq, H, D] (strided), input type
  float* lse;                // [B, H, Sq] or null
  long long o_sb, o_sh, o_ss;
  int H, Sq, Skv;
  float scale_log2;  // scale * log2(e)
  int causal, kv_valid;
};

// D[64 x 32] (+)= A B, bf16, A and B in shared memory, both K-major with
// the 128-byte swizzle.
__device__ __forceinline__ void cols_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 256] (+)= A B, bf16, A a 64 x 16 fragment in registers, B in
// shared memory, MN-major with the 128-byte swizzle (64-column blocks LBO
// bytes apart).
__device__ __forceinline__ void cols_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 160] (+)= A B, bf16, A a 64 x 16 fragment in registers, B in
// shared memory, MN-major with the 128-byte swizzle (64-column blocks LBO
// bytes apart).
__device__ __forceinline__ void cols_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 128] (+)= A B in TF32, A a 64 x 8 fragment in registers, B in
// shared memory, K-major with the 128-byte swizzle.
__device__ __forceinline__ void cols_tf32_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// D[64 x 80] (+)= A B in TF32, A a 64 x 8 fragment in registers, B in
// shared memory, K-major with the 128-byte swizzle.
__device__ __forceinline__ void cols_tf32_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 32] (+)= A B in TF32, as cols_tf32_n128.
__device__ __forceinline__ void cols_tf32_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void cols_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWarpgroup) : "memory");
}

// S of this warpgroup's chunk (its partial over DW columns, 16 values a
// thread) becomes the cluster's S: the two warpgroups' partials summed
// through the local slots of buffer i % 2, this CTA's sum stored by
// st.async into its slot in every other CTA (each warpgroup stores half of
// it: groups 2 wg, 2 wg + 1), then the C CTA sums added as a balanced tree
// in rank order. Every warpgroup of the cluster ends with the same bits.
// Buffer reuse needs no other barrier: a CTA writes buffer i % 2 again at
// chunk i + 2 only after waiting for chunk i + 1's sums, which every other
// CTA sends after reading chunk i's.
template <int C>
__device__ __forceinline__ void cols_sum_s(float (&s)[16], float4* lslot, float4* rslot,
                                           uint64_t* xbar, int i, int wg, int rank) {
  const int t = threadIdx.x % kWarpgroup;
  const int buf = i & 1;
  float4* mine = lslot + (2 * buf + wg) * kColsSlotF4;
  const float4* other = lslot + (2 * buf + 1 - wg) * kColsSlotF4;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    mine[g * kWarpgroup + t] = make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
  cols_consumers_sync();
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 x = other[g * kWarpgroup + t];
    s[4 * g] += x.x;
    s[4 * g + 1] += x.y;
    s[4 * g + 2] += x.z;
    s[4 * g + 3] += x.w;
  }
  // this CTA's sum into its slot C - 1 - d of the CTA d ranks on (slot j of
  // a CTA holds the sum of the CTA j + 1 ranks on)
  if (wg == 0 && t == 0) bar_expect(&xbar[buf], (C - 1) * kColsSlot);
#pragma unroll
  for (int d = 1; d < C; ++d) {
    const int peer = (rank + d) % C;
    const uint32_t dst = mapa(rslot + (buf * (C - 1) + C - 1 - d) * kColsSlotF4, peer);
    const uint32_t bar = mapa(&xbar[buf], peer);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if ((g >> 1) == wg)
        st_async_v4(dst + (g * kWarpgroup + t) * 16,
                    make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]), bar);
  }
  bar_wait_cluster(&xbar[buf], (i >> 1) & 1);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float4 v[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (r == rank)
        v[r] = make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
      else
        v[r] = rslot[(buf * (C - 1) + (r - rank - 1 + C) % C) * kColsSlotF4 + g * kWarpgroup + t];
    }
    float4 a = make_float4(v[0].x + v[1].x, v[0].y + v[1].y, v[0].z + v[1].z, v[0].w + v[1].w);
    if constexpr (C == 4) {
      const float4 c = make_float4(v[2].x + v[3].x, v[2].y + v[3].y, v[2].z + v[3].z,
                                   v[2].w + v[3].w);
      a = make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
    }
    s[4 * g] = a.x;
    s[4 * g + 1] = a.y;
    s[4 * g + 2] = a.z;
    s[4 * g + 3] = a.w;
  }
}

// The chunk's masks and online softmax on the S fragment (keys j0 ..; keys
// at or past lim[r] are masked for the thread's row r), in log2 units of
// the scaled scores, as flash_fwd_wide_sm90.cuh: S becomes P (unrounded),
// and alpha[r] is the factor that rescales row r's O.
__device__ __forceinline__ void cols_softmax(float (&s)[16], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const int (&lim)[2], int j0,
                                             float scale_log2) {
  if (j0 + kColsBK > min(lim[0], lim[1])) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (j0 + frag_col(e) >= lim[(e >> 1) & 1]) s[e] = -CUDART_INF_F;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int e = 0; e < 16; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_next = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    m_use[r] = m_next == -CUDART_INF_F ? 0.f : m_next;
    alpha[r] = exp2f(m[r] - m_use[r]);  // 0 while the row has seen no key
    m[r] = m_next;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int r = (e >> 1) & 1;
    s[e] = exp2f(fmaf(s[e], scale_log2, -m_use[r]));
    sum[r] += s[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// The epilogue: O / l into this warpgroup's DW columns of the output (rows
// below Sq), and the LSE = m ln 2 + ln l (-inf for a row with no key) from
// one warpgroup of the cluster.
template <int N, typename T>
__device__ __forceinline__ void cols_store(const float (&o)[N], float (&l)[2], const float (&m)[2],
                                           const int (&rows)[2], const ColsParams& p, int b, int h,
                                           int col0, bool lse_writer) {
  float inv[2], row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    row_lse[r] = l[r] == 0.f ? -CUDART_INF_F : m[r] * kLn2 + logf(l[r]);
  }
  T* out = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + col0;
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const int r = (e >> 1) & 1;
    if (rows[r] >= p.Sq) continue;
    T* at = out + rows[r] * p.o_ss + frag_col(e);
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[e] * inv[r], o[e + 1] * inv[r]);
    else
      *reinterpret_cast<float2*>(at) = make_float2(o[e] * inv[r], o[e + 1] * inv[r]);
  }
  if (p.lse != nullptr && lse_writer && threadIdx.x % 4 == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < p.Sq) lse[rows[r]] = row_lse[r];
  }
}

// What a cluster's CTA works on: its query tile, the chunks it walks, the
// thread's rows and key limits.
struct ColsTile {
  int rank, b, h, q0, wg, n_steps, rows[2], lim[2];

  __device__ ColsTile(const ColsParams& p, int C) {
    rank = cluster_rank();
    q0 = (blockIdx.x / C) * kColsBQ;
    h = blockIdx.y;
    b = blockIdx.z;
    wg = threadIdx.x / kWarpgroup;
    const int kv_end = min(p.kv_valid, p.Skv);
    const int kv_hi = p.causal ? min(kv_end, q0 + kColsBQ) : kv_end;
    n_steps = kv_hi > 0 ? (kv_hi + kColsBK - 1) / kColsBK : 0;
    rows[0] = q0 + frag_row(0);
    rows[1] = rows[0] + 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) lim[r] = p.causal ? min(kv_end, rows[r] + 1) : kv_end;
  }
};

// A CTA's shared memory, carved in the order ColsShape counts it, with its
// barriers initialised (a cluster_sync must follow before any thread of the
// cluster uses them).
template <class S>
struct ColsSmem {
  unsigned char* q;
  unsigned char* tiles;
  float4* lslot;  // [2 buffers][2 warpgroups] slots
  float4* rslot;  // [2 buffers][C - 1 peers] slots
  uint64_t* xbar;  // the cluster exchange's, a buffer each
  Ring<S::NS, 2 * kWarpgroup / 32> ring;

  __device__ static uint64_t* exchange_bars(Carve& carve) {
    uint64_t* x = carve.take<uint64_t>(2);
    if (threadIdx.x == 0) {
      bar_init(&x[0], 1);
      bar_init(&x[1], 1);
    }
    return x;
  }

  __device__ explicit ColsSmem(Carve& carve)
      : q(carve.take<unsigned char>(S::Q_BYTES)),
        tiles(carve.take<unsigned char>(S::NS * S::UNIT)),
        lslot(carve.take<float4>(4 * kColsSlotF4)),
        rslot(carve.take<float4>(2 * (S::C - 1) * kColsSlotF4)),
        xbar(exchange_bars(carve)),
        ring(carve) {}

  __device__ unsigned char* stage(int u) const { return tiles + (u % S::NS) * S::UNIT; }
};

template <int N>
__device__ __forceinline__ void cols_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                        int acc) {
  if constexpr (N == 256)
    cols_rs_n256(d, a, db, acc);
  else
    cols_rs_n160(d, a, db, acc);
}

template <int N>
__device__ __forceinline__ void cols_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  if constexpr (N == 128)
    cols_tf32_n128(d, a, db, acc);
  else
    cols_tf32_n80(d, a, db, acc);
}

// bf16: the producer warpgroup's thread 256 keeps the CTA's Q columns
// (NQB boxes of 64 rows) and, for chunk i, unit 2 i (K's columns, NQB
// boxes of kColsBK keys) and unit 2 i + 1 (each warpgroup's V columns,
// NVB boxes from its first column) in flight; the consumers run S, the
// exchange, the softmax and P V.
template <int D>
__global__ void __launch_bounds__(kColsThreads, 1)
    flash_fwd_cols_bf16(const __grid_constant__ ColsParams p) {
  using S = ColsShape<D, 1>;
  constexpr int BK = kColsBK, NS = S::NS, DW = S::DW, KS = S::KS, NVB = S::NVB;
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  const ColsSmem<S> sm(carve);
  const ColsTile tile(p, S::C);
  cluster_sync();

  if (tile.wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * kWarpgroup && tile.n_steps > 0) {
      const int c0 = tile.rank * S::DC;
      bar_expect(sm.ring.own, S::Q_BYTES);
      for (int nb = 0; nb < S::NQB; ++nb)
        tma_load_4d(sm.q + nb * kColsBQ * 128, &p.q, sm.ring.own, c0 + nb * 64, tile.q0, tile.h,
                    tile.b);
      for (int u = 0; u < 2 * tile.n_steps; ++u) {
        if (u >= NS) bar_wait(&sm.ring.empty[u % NS], (u / NS - 1) & 1);
        unsigned char* dst = sm.stage(u);
        uint64_t* bar = &sm.ring.full[u % NS];
        const int j0 = (u / 2) * BK;
        if (u % 2 == 0) {
          bar_expect(bar, S::NQB * BK * 128);
          for (int nb = 0; nb < S::NQB; ++nb)
            tma_load_4d(dst + nb * BK * 128, &p.k, bar, c0 + nb * 64, j0, tile.h, tile.b);
        } else {
          bar_expect(bar, 2 * NVB * BK * 128);
          for (int w = 0; w < 2; ++w)
            for (int nb = 0; nb < NVB; ++nb)
              tma_load_4d(dst + (w * NVB + nb) * BK * 128, &p.v, bar, c0 + w * DW + nb * 64, j0,
                          tile.h, tile.b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = tile.wg;
  const bf16* sq = reinterpret_cast<const bf16*>(sm.q);
  float o[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float s[16];
  uint32_t pf[BK / 16][4];

  if (tile.n_steps > 0) bar_wait(sm.ring.own, 0);
  for (int i = 0; i < tile.n_steps; ++i) {
    const int u = 2 * i;
    const bf16* ks = reinterpret_cast<const bf16*>(sm.stage(u));
    // this warpgroup's partial S over its DW columns
    sm.ring.wait(u);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int kx = wg * KS + kk;
      cols_ss_n32(s, desc_k(sq, kColsBQ, 0, kx), desc_k(ks, BK, 0, kx), kk > 0);
    }
    mma_commit();
    if (i > 0) {  // the previous chunk's P V is done: its V stage is free
      mma_wait<1>();
      fence_regs(o);
      sm.ring.arrive(u - 1);
    }
    mma_wait<0>();
    fence_regs(s);
    sm.ring.arrive(u);

    cols_sum_s<S::C>(s, sm.lslot, sm.rslot, sm.xbar, i, wg, tile.rank);
    float alpha[2];
    cols_softmax(s, m, l, alpha, tile.lim, i * BK, p.scale_log2);
#pragma unroll
    for (int e = 0; e < DW / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    to_a_frags(s, pf);

    // O[:, this warpgroup's DW columns] += P V: its NVB 64-column V boxes,
    // MN-major, a 16-key step 2048 bytes on
    sm.ring.wait(u + 1);
    const unsigned char* vs = sm.stage(u + 1) + wg * NVB * BK * 128;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      cols_rs<DW>(o, pf[kk], desc(vs + kk * 2048, BK * 128, 1024), 1);
    mma_commit();
  }
  // every product is done on every path before the epilogue reads the sums
  mma_wait<0>();
  fence_regs(o);
  if (tile.n_steps > 0) sm.ring.arrive(2 * tile.n_steps - 1);
  cols_store<DW / 2, bf16>(o, l, m, tile.rows, p, tile.b, tile.h, tile.rank * S::DC + wg * DW,
                           tile.rank == 0 && wg == 0);
}

// G of Q's TF32 k-steps k0 .. k0 + G - 1 (8 columns each) of the CTA's
// columns as A fragments, split into heads and (with_lo) tails. q_row is
// the shared address of this lane's ldmatrix row of Q's first box (its
// 16-byte chunk c stored at c ^ lrow7).
template <int G>
__device__ __forceinline__ void cols_q_frags(uint32_t (&hi)[G][4], uint32_t (&lo)[G][4],
                                             uint32_t q_row, int lrow7, int k0, bool with_lo) {
  const int half = (threadIdx.x % 32) / 16;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int ks = k0 + g;
    const int chunk = 2 * (ks % 4) + half;
    ldsm_x4(hi[g], q_row + (ks / 4) * (kColsBQ * 128) + ((chunk ^ lrow7) << 4));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = __uint_as_float(hi[g][r]);
      const uint32_t h = tf32_rna(a);
      if (with_lo) lo[g][r] = tf32_rna(a - __uint_as_float(h));
      hi[g][r] = h;
    }
  }
}

// One fragment buffer's products of S, one commit group: against K's heads
// (hi_pass: lo hi, then hi hi) or K's tails (hi lo). The chunk's first
// product overwrites S.
template <int G>
__device__ __forceinline__ void cols_s_tf32(float (&s)[16], const uint32_t (&hi)[G][4],
                                            const uint32_t (&lo)[G][4], bool hi_pass, bool first,
                                            const unsigned char* kt, int k0) {
  mma_fence();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int ks = k0 + g;
    const uint64_t db = desc(kt + (ks / 4) * (kColsBK * 128) + (ks % 4) * 32, 16, 1024);
    if (hi_pass) {
      cols_tf32_n32(s, lo[g], db, (first && g == 0) ? 0 : 1);
      cols_tf32_n32(s, hi[g], db, 1);
    } else {
      cols_tf32_n32(s, hi[g], db, 1);
    }
  }
  mma_commit();
}

// fp32 (3xTF32): the producer keeps the CTA's Q columns (NQB boxes of 32
// columns and 64 rows) and, for chunk i, units 4 i .. 4 i + 3 (K's heads,
// K's tails, V^T's tails, V^T's heads over the CTA's columns, from the
// pre-pass) in flight.
template <int D>
__global__ void __launch_bounds__(kColsThreads, 1)
    flash_fwd_cols_f32(const __grid_constant__ ColsParams p) {
  using S = ColsShape<D, 0>;
  constexpr int BK = kColsBK, NS = S::NS, DW = S::DW, KS = S::KS;
  constexpr int G = 2, NB = KS / G;  // k-steps a fragment buffer, buffers a pass
  static_assert(KS % G == 0, "whole fragment buffers");
  extern __shared__ unsigned char smem_raw[];
  Carve carve(smem_raw);
  const ColsSmem<S> sm(carve);
  const ColsTile tile(p, S::C);
  cluster_sync();

  if (tile.wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * kWarpgroup && tile.n_steps > 0) {
      const int c0 = tile.rank * S::DC;
      bar_expect(sm.ring.own, S::Q_BYTES);
      for (int nb = 0; nb < S::NQB; ++nb)
        tma_load_4d(sm.q + nb * kColsBQ * 128, &p.q, sm.ring.own, c0 + nb * 32, tile.q0, tile.h,
                    tile.b);
      for (int u = 0; u < 4 * tile.n_steps; ++u) {
        if (u >= NS) bar_wait(&sm.ring.empty[u % NS], (u / NS - 1) & 1);
        unsigned char* dst = sm.stage(u);
        uint64_t* bar = &sm.ring.full[u % NS];
        const int j0 = (u / 4) * BK;
        const int kind = u % 4;
        bar_expect(bar, S::UNIT);
        if (kind < 2) {
          const CUtensorMap* map = kind == 0 ? &p.k_hi : &p.k_lo;
          for (int nb = 0; nb < S::NQB; ++nb)
            tma_load_4d(dst + nb * BK * 128, map, bar, c0 + nb * 32, j0, tile.h, tile.b);
        } else {
          tma_load_4d(dst, kind == 2 ? &p.vt_lo : &p.vt_hi, bar, j0, c0, tile.h, tile.b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = tile.wg;
  // this lane's ldmatrix row of Q (as flash_fwd_wide_tf32_sm90.cuh)
  const int lane = threadIdx.x % 32;
  const int lrow = 16 * ((threadIdx.x % kWarpgroup) / 32) + 8 * ((lane / 8) & 1) + lane % 8;
  const uint32_t q_row = smem_u32(sm.q) + lrow * 128;
  const int k_base = wg * KS;  // this warpgroup's first k-step

  float o[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float s[16];
  uint32_t fh0[G][4], fl0[G][4], fh1[G][4], fl1[G][4];

  if (tile.n_steps > 0) bar_wait(sm.ring.own, 0);
  for (int i = 0; i < tile.n_steps; ++i) {
    const int u = 4 * i;
    // this warpgroup's partial S: two fragment buffers alternate, so a
    // buffer's fragments load while the one before it multiplies
    sm.ring.wait(u);
    cols_q_frags<G>(fh0, fl0, q_row, lrow % 8, k_base, true);
#pragma unroll
    for (int bb = 0; bb < 2 * NB; ++bb) {
      if (bb == NB) sm.ring.wait(u + 1);
      const unsigned char* kt = sm.stage(bb < NB ? u : u + 1);
      const int k0 = k_base + (bb % NB) * G;
      if (bb % 2 == 0)
        cols_s_tf32<G>(s, fh0, fl0, bb < NB, bb == 0, kt, k0);
      else
        cols_s_tf32<G>(s, fh1, fl1, bb < NB, bb == 0, kt, k0);
      if (bb + 1 < 2 * NB) {
        mma_wait<1>();  // buffer bb - 1's products are done: it is free
        if (bb == NB) sm.ring.arrive(u);  // every product on K's heads is done
        const int nb = bb + 1;
        if (nb % 2 == 0)
          cols_q_frags<G>(fh0, fl0, q_row, lrow % 8, k_base + (nb % NB) * G, nb < NB);
        else
          cols_q_frags<G>(fh1, fl1, q_row, lrow % 8, k_base + (nb % NB) * G, nb < NB);
      }
    }
    mma_wait<0>();
    fence_regs(s);
    sm.ring.arrive(u + 1);

    cols_sum_s<S::C>(s, sm.lslot, sm.rslot, sm.xbar, i, wg, tile.rank);
    float alpha[2];
    cols_softmax(s, m, l, alpha, tile.lim, i * BK, p.scale_log2);
#pragma unroll
    for (int e = 0; e < DW / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // P's A fragments: k-step kk holds keys 8 kk + 2t (column t) and 8 kk +
    // 2t + 1 (column t + 4), V^T's stored order
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[4 * kk + ((r & 1) << 1) + (r >> 1)];
        ph[kk][r] = tf32_rna(a);
        pl[kk][r] = tf32_rna(a - __uint_as_float(ph[kk][r]));
      }

    // O[:, this warpgroup's DW columns] += P V: V^T's rows DW wg on, a
    // k-step 32 bytes on
    const unsigned char* v_lo = sm.stage(u + 2) + wg * DW * 128;
    const unsigned char* v_hi = sm.stage(u + 3) + wg * DW * 128;
    sm.ring.wait(u + 2);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      cols_tf32<DW>(o, ph[kk], desc(v_lo + kk * 32, 16, 1024), 1);
    mma_commit();
    sm.ring.wait(u + 3);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t db = desc(v_hi + kk * 32, 16, 1024);
      cols_tf32<DW>(o, pl[kk], db, 1);
      cols_tf32<DW>(o, ph[kk], db, 1);
    }
    mma_commit();
    mma_wait<1>();
    sm.ring.arrive(u + 2);
    mma_wait<0>();
    fence_regs(o);
    sm.ring.arrive(u + 3);
  }
  cols_store<DW / 2, float>(o, l, m, tile.rows, p, tile.b, tile.h, tile.rank * S::DC + wg * DW,
                            tile.rank == 0 && wg == 0);
}

// The fp32 form's pre-pass: K's TF32 heads and tails [B, H, Skv_pad, D]
// and V^T's [B, H, D, Skv_pad] (keys of each group of 8 in the order 0 2 4
// 6 1 3 5 7), zero past Skv, from the strided [B, Skv, H, D] views; the
// kernel of flash_fwd_wide_tf32_sm90.cuh's flash_tf32_split at a head of
// D. A block turns a 32 x 32 tile (keys x columns), V's through shared
// memory. Bound by bytes: k and v read once, four fp32 arrays written once.
template <int D>
__global__ void __launch_bounds__(256)
    cols_tf32_split(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ k_hi, float* __restrict__ k_lo,
                    float* __restrict__ vt_hi, float* __restrict__ vt_lo, int H, int Skv,
                    int Skv_pad, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                    long long v_sh, long long v_ss) {
  constexpr int T = 32;
  __shared__ float tile[T][T + 1];
  const int j0 = blockIdx.x * T, d0 = blockIdx.y * T;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int x = threadIdx.x % T;
  for (int r = threadIdx.x / T; r < T; r += 256 / T) {
    const int key = j0 + r;
    float kv = 0.f, vv = 0.f;
    if (key < Skv) {
      kv = __ldg(k + b * k_sb + h * k_sh + key * k_ss + d0 + x);
      vv = __ldg(v + b * v_sb + h * v_sh + key * v_ss + d0 + x);
    }
    const long long at = (static_cast<long long>(bh) * Skv_pad + key) * D + d0 + x;
    const uint32_t hb = tf32_rna(kv);
    k_hi[at] = __uint_as_float(hb);
    k_lo[at] = __uint_as_float(tf32_rna(kv - __uint_as_float(hb)));
    tile[r][x] = vv;
  }
  __syncthreads();
  // position x of a group of 8 holds key 2x (x < 4) or 2x - 7
  const int src = (x & ~7) | ((x & 7) < 4 ? 2 * (x & 7) : 2 * (x & 7) - 7);
  for (int r = threadIdx.x / T; r < T; r += 256 / T) {
    const float vv = tile[src][r];
    const long long at = (static_cast<long long>(bh) * D + d0 + r) * Skv_pad + j0 + x;
    const uint32_t hb = tf32_rna(vv);
    vt_hi[at] = __uint_as_float(hb);
    vt_lo[at] = __uint_as_float(tf32_rna(vv - __uint_as_float(hb)));
  }
}

// -- host ----------------------------------------------------------------------

// A map over an fp32 [B, S, H, D] view (element strides sb, sh, ss; unit
// stride along D) whose box is {32, rows}: 32 columns (128 bytes) of `rows`
// rows of one (batch, head), 128-byte swizzled. Rows past S read as zero.
inline bool cols_map_f32(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                         long long sb, long long sh, long long ss, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const long long packed[3] = {D, static_cast<long long>(D) * S,
                               static_cast<long long>(D) * S * H};
  const long long given[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(4 * (dims[i + 1] == 1 ? packed[i] : given[i]));
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A cluster launch of `kernel` over the query tiles: grid (tiles x C, H,
// B), C CTAs a cluster along x; cudaGetLastError after it, so a refused
// launch (cluster, shared memory) is an error.
template <class S>
inline cudaError_t cols_launch(void (*kernel)(ColsParams), const ColsParams& p, int B, int H,
                               int Sq, cudaStream_t stream) {
  cudaError_t err = set_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((Sq + kColsBQ - 1) / kColsBQ * S::C), H, B);
  cfg.blockDim = dim3(kColsThreads);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<ColsParams*>(&p)};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace fvt

// The structural masks of the causal Wan's training forward, shared by the
// flash forward (flash_fwd.cu, K1 struct) and backward (flash_bwd.cu, K6
// struct). They replace the Pallas kernels' _mask_tile and _tile_reachable
// (fastvideo_tpu/ops/flash_attention.py:39-90) for chunk_tokens > 0.
//
// With ct = chunk_tokens and s = tf_clean_len, key c is visible to query r
// when c < kv_valid and:
//   chunk-causal (s = 0):      c / ct <= r / ct
//   teacher forcing (s > 0), the sequence [clean | noisy] of 2s rows:
//     clean query (r < s):     c < s and c / ct <= r / ct
//     noisy query:             its own noisy chunk, c >= s and
//                              (c - s) / ct == (r - s) / ct, or the clean
//                              keys of strictly earlier chunks, c < s and
//                              c / ct < (r - s) / ct
// So the keys a row sees are at most two ranges, [0, a) and [b, c), and the
// rows that see a key at most two ranges, [d, e) and [f, g). A tile loops
// the union of its rows' (or keys') ranges, not JAX's upper bound, and
// checks every element against its own row's (or key's) ranges, since a
// chunk border (4,680 tokens at 480x832) or the clean/noisy border falls
// inside a 64-row tile.
#pragma once

#include <climits>

namespace fvt {

// Keys visible to query row r: [0, a) and [b, c) (empty when b >= c),
// cut at kv_end.
__device__ __forceinline__ void struct_row_keys(int r, int ct, int s, int kv_end, int& a,
                                                int& b, int& c) {
  b = c = 0;
  if (s <= 0) {
    a = min((r / ct + 1) * ct, kv_end);
  } else if (r < s) {
    a = min(min((r / ct + 1) * ct, s), kv_end);
  } else {
    const int cq = (r - s) / ct;
    a = min(min(cq * ct, s), kv_end);
    b = min(s + cq * ct, kv_end);
    c = min(s + (cq + 1) * ct, kv_end);
  }
}

// Query rows (of Sq) that see key j: [d, e) and [f, g); all empty for a
// key at or past kv_end.
__device__ __forceinline__ void struct_key_rows(int j, int ct, int s, int Sq, int kv_end,
                                                int& d, int& e, int& f, int& g) {
  d = e = f = g = 0;
  if (j >= kv_end) return;
  if (s <= 0) {
    d = min(j / ct * ct, Sq);
    e = Sq;
  } else if (j < s) {
    d = min(j / ct * ct, Sq);
    e = min(s, Sq);
    f = min(s + (j / ct + 1) * ct, Sq);
    g = Sq;
  } else {
    const int cn = (j - s) / ct;
    f = min(s + cn * ct, Sq);
    g = min(s + (cn + 1) * ct, Sq);
  }
}

// Disjoint ascending ranges [lo[i], hi[i]) for i < n, built by adding
// ranges in ascending order of their starts; a range that overlaps or
// touches the last one merges into it, so no index is visited twice.
struct Ranges {
  int lo[3], hi[3];
  int n = 0;

  __device__ __forceinline__ void add(int a, int b) {
    if (a >= b) return;
    if (n > 0 && a <= hi[n - 1]) {
      hi[n - 1] = max(hi[n - 1], b);
      return;
    }
    lo[n] = a;
    hi[n] = b;
    ++n;
  }
};

// The keys some of a query tile's `rows` rows see, from their per-row
// ranges sa/sb/sc (shared memory): [0, max a) and the union of the [b, c)
// ranges (the own noisy chunks of consecutive rows: contiguous). Every row's
// a is at most s and every b at least s, so the two are in order.
__device__ __forceinline__ Ranges struct_tile_keys(const int* sa, const int* sb, const int* sc,
                                                   int rows) {
  int ua = 0, ub = INT_MAX, uc = 0;
  for (int r = 0; r < rows; ++r) {
    ua = max(ua, sa[r]);
    if (sb[r] < sc[r]) {
      ub = min(ub, sb[r]);
      uc = max(uc, sc[r]);
    }
  }
  Ranges out;
  out.add(0, ua);
  out.add(ub, uc);
  return out;
}

// The query rows that see some of a key tile's `keys` keys (key r is
// k0 + r), from their per-key ranges: the union of the [d, e) ranges
// (clean rows, all below s), then the [f, g) ranges of the tile's clean keys
// (noisy rows of later chunks, each up to Sq) and of its noisy keys (their
// own noisy chunks, consecutive), each contiguous; the last two may be
// apart in a tile that holds both kinds of key.
__device__ __forceinline__ Ranges struct_tile_rows(const int* sd, const int* se,
                                                   const int* sf, const int* sg, int keys,
                                                   int k0, int s) {
  int d = INT_MAX, e = 0, fc = INT_MAX, gc = 0, fn = INT_MAX, gn = 0;
  for (int r = 0; r < keys; ++r) {
    if (sd[r] < se[r]) {
      d = min(d, sd[r]);
      e = max(e, se[r]);
    }
    if (sf[r] < sg[r]) {
      if (k0 + r < s) {
        fc = min(fc, sf[r]);
        gc = max(gc, sg[r]);
      } else {
        fn = min(fn, sf[r]);
        gn = max(gn, sg[r]);
      }
    }
  }
  Ranges out;
  out.add(d, e);
  if (fc <= fn) {
    out.add(fc, gc);
    out.add(fn, gn);
  } else {
    out.add(fn, gn);
    out.add(fc, gc);
  }
  return out;
}

}  // namespace fvt

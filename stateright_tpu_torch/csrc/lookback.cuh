// One-pass prefix scan across CTAs by decoupled look-back, shared by
// bucket_plan.cu and cand_prep.cu.
//
// The scanned value is a (segment-start flag, segment count, total) triple
// with a segmented operator; a plain count is the triple {0, 0, count}.
// A kernel that uses it:
//  - takes its tile id from an atomic ticket (scratch word 0), not from
//    `blockIdx`, so every tile a CTA waits on has started and is resident;
//  - scans inside the tile with `block_scan` (warp shuffles, then shared
//    memory across the tile's warps);
//  - lets one warp call `look_back`: the tile publishes (status, value) as
//    one 64-bit word with release/acquire ordering, first its aggregate,
//    then its inclusive prefix, and reads 32 predecessors at once, one per
//    lane, combined with shuffles;
//  - lets the last CTA to finish (a second ticket) read the last tile's
//    prefix and zero the scratch for the next launch, so a step needs no
//    memset.  Zeroing must wait (a barrier) until that read is done.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Tile state word: [63:62] status, [61] segment-start flag,
// [60:31] segment count, [30:0] total.  Counts stay below 2^30 (the
// wrappers refuse wider batches).
constexpr unsigned long long kAggregate = 1ULL << 62;
constexpr unsigned long long kPrefix = 2ULL << 62;

struct Scan {
  unsigned flag, seg, tot;
};

// `a` precedes `b`: a segment start in `b` cuts off `a`'s segment count.
__device__ __forceinline__ Scan combine(Scan a, Scan b) {
  return {a.flag | b.flag, b.flag ? b.seg : a.seg + b.seg, a.tot + b.tot};
}

__device__ __forceinline__ unsigned long long pack(Scan s) {
  return ((unsigned long long)s.flag << 61) |
         ((unsigned long long)s.seg << 31) | (unsigned long long)s.tot;
}

__device__ __forceinline__ Scan unpack(unsigned long long w) {
  return {(unsigned)(w >> 61) & 1u, (unsigned)(w >> 31) & 0x3FFFFFFFu,
          (unsigned)w & 0x7FFFFFFFu};
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ Scan shfl_up(Scan s, int d) {
  return {__shfl_up_sync(kFull, s.flag, d), __shfl_up_sync(kFull, s.seg, d),
          __shfl_up_sync(kFull, s.tot, d)};
}

__device__ __forceinline__ Scan shfl_down(Scan s, int d) {
  return {__shfl_down_sync(kFull, s.flag, d),
          __shfl_down_sync(kFull, s.seg, d), __shfl_down_sync(kFull, s.tot, d)};
}

__device__ __forceinline__ Scan shfl_from(Scan s, int src) {
  return {__shfl_sync(kFull, s.flag, src), __shfl_sync(kFull, s.seg, src),
          __shfl_sync(kFull, s.tot, src)};
}

// Inclusive scan of `x` over the tile; every thread of the CTA calls it.
// Afterwards `s_warp[kWarps - 1]` holds the tile's aggregate.
template <int kWarps>
__device__ __forceinline__ Scan block_scan(Scan x, Scan* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Scan y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Scan w = lane < kWarps ? s_warp[lane] : Scan{0u, 0u, 0u};
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Scan y = shfl_up(w, d);
      if (lane >= d) w = combine(y, w);
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  return warp > 0 ? combine(s_warp[warp - 1], x) : x;
}

// Publishes tile `tile`'s aggregate `agg`, looks back for its exclusive
// prefix, publishes its inclusive prefix and returns the exclusive one
// (the same in every lane).  All 32 lanes of one warp call it.
__device__ __forceinline__ Scan look_back(unsigned long long* state, int tile,
                                          Scan agg) {
  const int lane = threadIdx.x & 31;
  Scan excl = {0u, 0u, 0u};
  if (tile == 0) {
    if (lane == 0) st_release(&state[0], kPrefix | pack(agg));
    return excl;
  }
  if (lane == 0) st_release(&state[tile], kAggregate | pack(agg));
  for (int top = tile - 1;; top -= 32) {
    // lane l waits for tile top - l; before tile 0 is an empty prefix
    const int p = top - lane;
    unsigned long long w = kPrefix;
    if (p >= 0) {
      while (((w = ld_acquire(&state[p])) >> 62) == 0) {
      }
    }
    const unsigned prefixes = __ballot_sync(kFull, (w >> 62) == 2);
    // the nearest prefix ends the window; older lanes are left out
    const int lim = prefixes ? __ffs(prefixes) - 1 : 31;
    Scan x = unpack(w);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // higher lanes are older tiles
      const Scan y = shfl_down(x, d);
      if (lane + d <= lim) x = combine(y, x);
    }
    excl = combine(shfl_from(x, 0), excl);
    if (prefixes) break;
  }
  if (lane == 0) st_release(&state[tile], kPrefix | pack(combine(excl, agg)));
  return excl;
}

// The inclusive prefix of tile `tile`, once it is published.
__device__ __forceinline__ Scan wait_prefix(const unsigned long long* state,
                                            int tile) {
  unsigned long long w;
  while (((w = ld_acquire(&state[tile])) >> 62) != 2) {
  }
  return unpack(w);
}

}  // namespace

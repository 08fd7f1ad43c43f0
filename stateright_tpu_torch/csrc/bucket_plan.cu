// Kernel bucket_plan — the visited-set insert's probe and plan, one pass.
//
// Replaces: the membership/occupancy `while_loop`, the first-occurrence
// dedup, the segmented-cumsum ranks, the overflow flags, the novel-first
// `argsort` compaction and the `sel` remap of `bucket_insert`
// (stateright_tpu/ops/buckets.py:202-344, all but the write).  In the port
// it stands where kernel C (`bucket_probe`), the ~40 PyTorch calls of
// `plan_writes` and the two `sel` gathers stood.  For sorted lane i (in
// bucket-key order):
//   first   = fp[i] != fp[i-1]
//   present = any(line == fp[i]), base = count(line != EMPTY) over the
//             bucket's 16-slot line (slots fill densely and never free)
//   novel   = valid & first & !present
//   rank    = novel lanes before i in i's run of equal buckets
//   pos     = novel lanes before i in the whole batch (table order)
// and a novel lane writes tgt = bucket*16 + base + rank, its fp, payload
// and original index (`cidx[order[i]]`) at `pos`.  A novel lane whose
// slot reaches 16 raises `overflow`; then, or on `cand_overflow`,
// `n_new` is 0 and the commit kernel writes nothing.
//
// Two entries, one kernel template:
//  - fused (`srt_bucket_plan_fused`, the engines' step): the inputs are
//    `cand_prep`'s unsorted fingerprints and payloads, the sorted keys
//    `skey` and the permutation `order` from one `torch.sort`.  Lane i
//    reads fp[order[i]] and payload[order[i]] itself and derives its
//    bucket from skey[i] as the high `bits` bits of skey ^ 2^63, so the
//    sort's tail (two gathers, a shift and an add, each an operation with
//    its own array) is gone from the step.  The first-occurrence test
//    compares fingerprints, not keys: `bucket_key` maps two fingerprints
//    to one key where a mix equals EMPTY.  A window (`win`, two device
//    words lo, hi; the mesh engine's table pieces) plans sorted lanes
//    [lo, hi) as lanes 0.. of a piece with buckets rebased by `boff`;
//  - pre-gathered (`srt_bucket_plan`): sorted fingerprints, payloads and
//    buckets built by the caller (the sharded engine's per-shard sorts).
//
// Bound on an H100: neither bytes nor operations.  At the engine's shapes
// (tens of thousands of lanes) the bytes take about a microsecond, so the
// kernel's time is latency: dependent reads (key, order, fingerprint,
// line) and the look-back chain across tiles.  The design:
//  - one CTA per 256 sorted lanes, a lane a thread.  Tiles of 512 and
//    1,024 lanes (two or four lanes a thread, so a quarter of the chain)
//    measured slower on the card in every cell: a thread's rounds of line
//    loads come one after another, and that latency outweighs the shorter
//    chain (PERF.md §6);
//  - after the sort the EMPTY lanes are a contiguous tail (EMPTY's key is
//    the largest), and a dead lane reads no order entry, fingerprint or
//    line; a warp with no live lane skips the probe (a warp vote, no
//    block barrier).  A tile with no novel lane needs no prefix: it
//    publishes its aggregate and does not look back (`publish_aggregate`),
//    so the dead tail and the all-duplicate tiles leave the chain;
//  - sixteen lanes of a half-warp read one candidate's 128-byte line as
//    one coalesced load (a slot each), and `__ballot_sync`/`__popc` give
//    `present` and `base`; a half-warp issues its sixteen candidates'
//    loads before the first ballot, and before the fused form's
//    fingerprint gather, which needs the permutation but not the line;
//  - the lane before comes by a shuffle; lane 0 of a warp reads it, and
//    in the fused form gathers its fingerprint only when the two keys are
//    equal (equal fingerprints have equal keys);
//  - both prefix counts are one scan of (segment-start flag, segment
//    count, total) triples (`lookback.cuh`): warp shuffles inside a warp,
//    shared memory across the tile's warps, and decoupled look-back
//    across tiles in the same pass, tile ids from an atomic ticket.  Runs
//    of equal buckets or equal fingerprints may span any number of tiles;
//    the segmented operator carries them;
//  - a tile that looked back adds its novel count to a total word (one
//    atomic), and the last CTA to finish (a second ticket) reads it, so
//    it walks back over no tile; it writes `n_new` and `overflow` and
//    zeroes the kernel's scratch for the next launch, so a step needs no
//    memset.
// The JAX `.mxu(probe=True)` knob (`bucket_insert(probe_dot=True)`,
// stateright_tpu/ops/mxu.py:118) recasts this probe as one product of the
// candidate x slot comparison tile with a block-diagonal ones matrix.  The
// port has no such form: one half-warp line load and two
// `__ballot_sync`/`__popc` per lane already give `present` and `base`, and
// a tensor-core product would add a conversion of the tile and an `mma`
// for the same two numbers.
//
// Generation order (symmetry runs; `generation_order=True` of
// `bucket_insert`, stateright_tpu/ops/buckets.py:282-297 and :341-343).
// The novel lanes are compacted in candidate order, not sorted order: a
// novel lane's position is the count of novel lanes j with
// order[j] < order[i], its rank in the order `cand_prep` compacted the
// candidates in.  Slots and `n_new` do not change.  No scan over sorted
// lanes gives that rank, so the mode is two launches:
//  - the plan above, where each novel lane writes (tgt, fp, payload) to
//    position order[i] of a staging area of three CB-wide int64 arrays
//    instead of to the outputs.  `order` is a permutation, so no two lanes
//    meet; a staged slot of -1 means "no novel lane here".  The plan also
//    keeps the highest staged position + 1 (a warp max, then one
//    `atomicMax` a warp) in a scratch word;
//  - `bucket_compact`: one CTA per 256 staging positions below that word
//    (the CTAs past it stop at once: with `cand_prep`'s map, records sit
//    only below min(n_valid, CB)) reads the staged slots, scans the
//    live flags (the same look-back scan, a plain count {0, 0, live}) and
//    writes each live record at its count, with sel = cidx[p] (or p),
//    then puts the -1 back.  Its last CTA zeroes the scratch again, so
//    neither launch needs a memset.
// Bound: the same bytes as the table-order plan (the staging area is
// internal), plus a launch.
#include <cuda_runtime.h>
#include <cstdint>

#include "lookback.cuh"

namespace {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFULL;
constexpr unsigned long long kSign = 1ULL << 63;
constexpr long long kEmptyKey = (long long)(kEmpty ^ kSign);  // largest key
constexpr int kSlots = 16;
constexpr int kTile = 256;  // sorted lanes per CTA = threads per CTA
constexpr int kWarps = kTile / 32;

// Scratch words: tile ticket, done ticket, overflow, the highest staged
// position + 1 (generation order), the novel lanes' total, then one state
// per tile.
constexpr int kTileTicket = 0, kDoneTicket = 1, kOverflow = 2, kStageHi = 3,
              kTotal = 4, kStates = 5;

// The plan's inputs.  Fused: `fp`/`pl` are unsorted (read through
// `order`), `skey` the sorted keys, `bucket` null; `win` null or the
// window [win[0], win[1]) of sorted lanes.  Pre-gathered: `fp`/`pl` and
// `bucket` are sorted, `skey` and `win` null.
struct PlanIn {
  const unsigned long long* fp;
  const long long* pl;
  const long long* skey;
  const long long* bucket;
  const long long* order;
  const long long* cidx;  // null: no compaction
  const long long* win;
  int bits;
  long long boff;
};

struct Lane {
  unsigned long long fp;  // EMPTY until gathered, and on a dead lane
  long long k, b, o;      // (fused) sorted key, bucket, (fused) order[s]
  bool live;
};

// Lane i's sort position: in the fused form its sorted key and order
// entry (dead past the window, past m, or at EMPTY's key; the bucket from
// the key), else its sorted fingerprint and bucket (read for a dead lane
// too: the lane after it compares buckets with it, as the plain version
// does).  The fused form's fingerprint comes later, from `gather_fp`.
template <bool kFused>
__device__ __forceinline__ Lane read_key(const PlanIn& in, long long i,
                                         long long m, long long lo,
                                         long long hi) {
  Lane x = {kEmpty, kEmptyKey, 0, -1, false};
  if (i >= m) return x;
  if (kFused) {
    const long long s = lo + i;
    if (s < hi) {
      x.k = in.skey[s];
      x.o = in.order[s];
      x.live = x.k != kEmptyKey;
      const unsigned long long u = (unsigned long long)x.k ^ kSign;
      x.b = (in.bits ? (long long)(u >> (64 - in.bits)) : 0LL) - in.boff;
    }
  } else {
    x.fp = in.fp[i];
    x.b = in.bucket[i];
    x.live = x.fp != kEmpty;
  }
  return x;
}

template <bool kFused>
__device__ __forceinline__ void gather_fp(const PlanIn& in, Lane& x) {
  if (kFused && x.live) x.fp = in.fp[x.o];
}

template <bool kFused>
__global__ void __launch_bounds__(kTile) bucket_plan_kernel(
    const unsigned long long* __restrict__ tfp, PlanIn in,
    const bool* __restrict__ cand_overflow, long long* __restrict__ tgt,
    long long* __restrict__ cfp, long long* __restrict__ cpl,
    long long* __restrict__ sel, long long* __restrict__ n_new,
    bool* __restrict__ overflow, unsigned long long* __restrict__ scratch,
    long long* __restrict__ stage,  // null: table order
    long long m, int ntiles) {
  __shared__ Scan s_warp[kWarps];
  __shared__ Scan s_prefix;
  __shared__ int s_tile, s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* state = scratch + kStates;

  if (t == 0) s_tile = (int)atomicAdd(&scratch[kTileTicket], 1ULL);
  __syncthreads();
  const int tile = s_tile;
  const long long i = (long long)tile * kTile + t;
  long long lo = 0, hi = m;
  if (kFused && in.win != nullptr) {
    lo = in.win[0];
    hi = in.win[1];
  }

  // -- the lane's key; a warp with no live lane skips the probe ------------
  Lane x = read_key<kFused>(in, i, m, lo, hi);
  const bool valid = x.live;
  bool present = false;
  int base = 0;
  if (__any_sync(kFull, valid)) {
    // the line loads go out before the fingerprint's gather (a line needs
    // only its bucket), so the two overlap; a dead lane's line is not read
    const int half = lane & 16;  // first lane of this half-warp
    const int slot_lane = lane & 15;
    unsigned long long v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const long long bk = __shfl_sync(kFull, x.b, half | k);
      const int lk = __shfl_sync(kFull, (int)valid, half | k);
      v[k] = lk ? __ldg(tfp + bk * kSlots + slot_lane) : kEmpty;
    }
    gather_fp<kFused>(in, x);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const unsigned long long f = __shfl_sync(kFull, x.fp, half | k);
      const unsigned hit = (__ballot_sync(kFull, v[k] == f) >> half) & 0xFFFFu;
      const unsigned used =
          (__ballot_sync(kFull, v[k] != kEmpty) >> half) & 0xFFFFu;
      if (slot_lane == k) {
        present = valid && hit != 0u;
        base = valid ? __popc(used) : 0;
      }
    }
  }

  // -- dedup and segment starts against the lane before (a shuffle; lane 0
  // of a warp reads it, and gathers its fingerprint only when the two
  // keys are equal, since equal fingerprints have equal keys) -------------
  Lane p = x;
  p.fp = __shfl_up_sync(kFull, x.fp, 1);
  p.b = __shfl_up_sync(kFull, x.b, 1);
  if (lane == 0 && valid && i > 0) {
    p = read_key<kFused>(in, i - 1, m, lo, hi);
    if (p.k == x.k) gather_fp<kFused>(in, p);
  }
  bool novel = false, bstart = false;
  if (valid) {
    novel = !present && (i == 0 || p.fp != x.fp);
    bstart = i == 0 || p.b != x.b;
  }
  const Scan sc = {bstart ? 1u : 0u, novel ? 1u : 0u, novel ? 1u : 0u};

  // -- scan inside the tile, then across tiles: a tile with no novel lane
  // needs no prefix, so it publishes its aggregate and does not look back
  const Scan incl = block_scan<kWarps>(sc, s_warp);
  const Scan agg = s_warp[kWarps - 1];
  if (agg.tot == 0u) {
    if (t == 0) publish_aggregate(state, tile, agg);
  } else {
    if (warp == 0) {
      const Scan excl = look_back(state, tile, agg);
      if (lane == 0) {
        s_prefix = excl;
        // the batch's total, for the last CTA: no walk back over the
        // tiles that did not look back
        atomicAdd(&scratch[kTotal], (unsigned long long)agg.tot);
      }
    }
    __syncthreads();
  }

  // -- write the novel lanes at their table-order positions, or stage
  // them at their candidate positions -------------------------------------
  bool ovf = false;
  unsigned stage_hi = 0u;
  if (novel) {
    const Scan g = combine(s_prefix, incl);
    const int slot = base + (int)g.seg - 1;
    ovf = slot >= kSlots;
    const long long o = kFused ? x.o : in.order[i];
    const long long pl = kFused ? in.pl[o] : in.pl[i];
    if (stage != nullptr) {
      stage[o] = x.b * kSlots + slot;
      stage[m + o] = (long long)x.fp;
      stage[2 * m + o] = pl;
      stage_hi = (unsigned)o + 1u;
    } else {
      const long long pos = (long long)g.tot - 1;
      tgt[pos] = x.b * kSlots + slot;
      cfp[pos] = (long long)x.fp;
      cpl[pos] = pl;
      sel[pos] = in.cidx != nullptr ? in.cidx[o] : o;
    }
  }
  const int tile_ovf = __syncthreads_or(ovf);
  if (stage != nullptr) {
    const unsigned w_hi = __reduce_max_sync(kFull, stage_hi);
    if (lane == 0 && w_hi > 0u) {
      atomicMax(&scratch[kStageHi], (unsigned long long)w_hi);
    }
  }

  // -- the last CTA to finish publishes n_new and resets the scratch -------
  if (t == 0) {
    if (tile_ovf) atomicOr(&scratch[kOverflow], 1ULL);
    __threadfence();
    s_last = atomicAdd(&scratch[kDoneTicket], 1ULL) ==
             (unsigned long long)(ntiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (t == 0) {
    const bool any_ovf = ld_acquire(&scratch[kOverflow]) != 0ULL;
    const long long total = (long long)ld_acquire(&scratch[kTotal]);
    *overflow = any_ovf;
    *n_new = (any_ovf || *cand_overflow) ? 0LL : total;
    scratch[kTileTicket] = 0ULL;
    scratch[kDoneTicket] = 0ULL;
    scratch[kOverflow] = 0ULL;
    scratch[kTotal] = 0ULL;
  }
  for (int k = t; k < ntiles; k += kTile) state[k] = 0ULL;
}

// Generation order's second launch: compact the staged records in
// candidate order (see the note at the top).
__global__ void __launch_bounds__(kTile) bucket_compact_kernel(
    long long* __restrict__ stage, const long long* __restrict__ cidx,
    long long* __restrict__ tgt, long long* __restrict__ cfp,
    long long* __restrict__ cpl, long long* __restrict__ sel,
    unsigned long long* __restrict__ scratch, long long m, int ntiles) {
  __shared__ Scan s_warp[kWarps];
  __shared__ Scan s_prefix;
  __shared__ int s_tile, s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* state = scratch + kStates;

  if (t == 0) s_tile = (int)atomicAdd(&scratch[kTileTicket], 1ULL);
  __syncthreads();
  const int tile = s_tile;
  const long long p = (long long)tile * kTile + t;
  // no record sits at or past the plan's highest staged position + 1
  const long long hi = min(m, (long long)scratch[kStageHi]);

  if ((long long)tile * kTile < hi) {
    const long long staged = p < hi ? stage[p] : -1LL;
    const bool live = staged >= 0;
    const Scan incl = block_scan<kWarps>(Scan{0u, 0u, live ? 1u : 0u}, s_warp);
    const Scan agg = s_warp[kWarps - 1];
    if (agg.tot == 0u) {
      if (t == 0) publish_aggregate(state, tile, agg);
    } else {
      if (warp == 0) {
        const Scan excl = look_back(state, tile, agg);
        if (lane == 0) s_prefix = excl;
      }
      __syncthreads();
    }
    if (live) {
      const long long pos = (long long)combine(s_prefix, incl).tot - 1;
      tgt[pos] = staged;
      cfp[pos] = stage[m + p];
      cpl[pos] = stage[2 * m + p];
      sel[pos] = cidx != nullptr ? cidx[p] : p;
      stage[p] = -1LL;  // the area is all -1 again for the next launch
    }
  }

  // -- the last CTA to finish resets the scratch ---------------------------
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(&scratch[kDoneTicket], 1ULL) ==
             (unsigned long long)(ntiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (t == 0) {
    scratch[kTileTicket] = 0ULL;
    scratch[kDoneTicket] = 0ULL;
    scratch[kStageHi] = 0ULL;
  }
  for (int k = t; k < ntiles; k += kTile) state[k] = 0ULL;
}

template <bool kFused>
int launch(const void* tfp, const PlanIn& in, const void* cand_overflow,
           void* tgt, void* cfp, void* cpl, void* sel, void* n_new,
           void* overflow, void* scratch, void* stage, int64_t m,
           void* stream) {
  const long long ntiles = (m + kTile - 1) / kTile;
  bucket_plan_kernel<kFused><<<(unsigned)ntiles, kTile, 0,
                               (cudaStream_t)stream>>>(
      (const unsigned long long*)tfp, in, (const bool*)cand_overflow,
      (long long*)tgt, (long long*)cfp, (long long*)cpl, (long long*)sel,
      (long long*)n_new, (bool*)overflow, (unsigned long long*)scratch,
      (long long*)stage, (long long)m, (int)ntiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stage == nullptr) return (int)err;
  bucket_compact_kernel<<<(unsigned)ntiles, kTile, 0,
                          (cudaStream_t)stream>>>(
      (long long*)stage, in.cidx, (long long*)tgt, (long long*)cfp,
      (long long*)cpl, (long long*)sel, (unsigned long long*)scratch,
      (long long)m, (int)ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The pre-gathered entry: sorted fingerprints, payloads and buckets.
extern "C" int srt_bucket_plan(const void* tfp, const void* sfp,
                               const void* spl, const void* bucket,
                               const void* order, const void* cidx,
                               const void* cand_overflow, void* tgt, void* cfp,
                               void* cpl, void* sel, void* n_new,
                               void* overflow, void* scratch, void* stage,
                               int64_t m, void* stream) {
  const PlanIn in = {(const unsigned long long*)sfp, (const long long*)spl,
                     nullptr, (const long long*)bucket,
                     (const long long*)order, (const long long*)cidx,
                     nullptr, 0, 0};
  return launch<false>(tfp, in, cand_overflow, tgt, cfp, cpl, sel, n_new,
                       overflow, scratch, stage, m, stream);
}

// The fused entry: `cand_prep`'s unsorted fingerprints and payloads, the
// sorted keys and the permutation; `win` (nullable) a window of sorted
// lanes, `boff` the buckets' rebase.
extern "C" int srt_bucket_plan_fused(const void* tfp, const void* fp,
                                     const void* payload, const void* skey,
                                     const void* order, const void* cidx,
                                     const void* cand_overflow, void* tgt,
                                     void* cfp, void* cpl, void* sel,
                                     void* n_new, void* overflow,
                                     void* scratch, void* stage,
                                     const void* win, int bits, int64_t boff,
                                     int64_t m, void* stream) {
  const PlanIn in = {(const unsigned long long*)fp, (const long long*)payload,
                     (const long long*)skey, nullptr,
                     (const long long*)order, (const long long*)cidx,
                     (const long long*)win, bits, (long long)boff};
  return launch<true>(tfp, in, cand_overflow, tgt, cfp, cpl, sel, n_new,
                      overflow, scratch, stage, m, stream);
}

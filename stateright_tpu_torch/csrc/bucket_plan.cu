// Kernel bucket_plan — the visited-set insert's probe and plan, one pass.
//
// Replaces: the membership/occupancy `while_loop`, the first-occurrence
// dedup, the segmented-cumsum ranks, the overflow flags, the novel-first
// `argsort` compaction and the `sel` remap of `bucket_insert`
// (stateright_tpu/ops/buckets.py:202-344, all but the write).  In the port
// it stands where kernel C (`bucket_probe`), the ~40 PyTorch calls of
// `plan_writes` and the two `sel` gathers stood.  Input: candidates sorted
// by bucket key (`sort_candidates`).  For sorted lane i:
//   first   = sfp[i] != sfp[i-1]
//   present = any(line == sfp[i]), base = count(line != EMPTY) over the
//             bucket's 16-slot line (slots fill densely and never free)
//   novel   = valid & first & !present
//   rank    = novel lanes before i in i's run of equal buckets
//   pos     = novel lanes before i in the whole batch (table order)
// and a novel lane writes tgt = bucket*16 + base + rank, its fp, payload
// and original index (`cidx[order[i]]`) at `pos`.  A novel lane whose
// slot reaches 16 raises `overflow`; then, or on `cand_overflow`,
// `n_new` is 0 and the commit kernel writes nothing.
//
// Bound on an H100: neither bytes nor operations.  At the engine's shapes
// (tens of thousands of lanes) the bytes take well under a microsecond, so
// what the step pays for is launches: the composed PyTorch version is
// about fifty calls, each at host-issue cost.  The design is one launch:
//  - one CTA per 256 sorted lanes; sixteen lanes of a half-warp read one
//    candidate's 128-byte line as one coalesced load (a slot each), and
//    `__ballot_sync`/`__popc` give `present` and `base`; a half-warp
//    issues its sixteen candidates' loads before the first ballot;
//  - both prefix counts are one scan of (segment-start flag, segment
//    count, total) triples (`lookback.cuh`): warp shuffles inside a warp,
//    shared memory across the tile's warps, and decoupled look-back across
//    tiles in the same pass.  Tile ids come from an atomic ticket, not from
//    `blockIdx`, so every tile a CTA waits on has started and is resident.
//    A tile publishes (status, flag, count, total) as one 64-bit word with
//    release/acquire ordering: first its aggregate, then its inclusive
//    prefix; the look-back reads 32 predecessors at once, one per lane of
//    a warp, and combines them with shuffles.  Runs of equal buckets or
//    equal fingerprints may span any number of tiles; the segmented
//    operator carries them;
//  - the last CTA to finish (a second ticket) writes `n_new` and
//    `overflow` and zeroes the kernel's scratch for the next launch, so a
//    step needs no memset.
// Lanes with an EMPTY fingerprint (a contiguous tail of the sorted order)
// read no bucket index; their line loads all go to bucket 0's line, so
// the sixteen loads of a half-warp carry no branch, and the results are
// masked.
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
//    meet; a staged slot of -1 means "no novel lane here";
//  - `bucket_compact`: one CTA per 256 staging positions reads the staged
//    slots, scans the live flags (the same look-back scan, a plain count
//    {0, 0, live}) and writes each live record at its count, with
//    sel = cidx[p] (or p), then puts the -1 back.  Its last CTA zeroes
//    the scratch again, so neither launch needs a memset.
// Bound: the same bytes as the table-order plan (the staging area is
// internal), plus a launch; at the engine's shapes both are well under a
// microsecond, so the mode costs one more launch a step.
#include <cuda_runtime.h>
#include <cstdint>

#include "lookback.cuh"

namespace {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFULL;
constexpr int kSlots = 16;
constexpr int kTile = 256;  // sorted lanes per CTA = threads per CTA
constexpr int kWarps = kTile / 32;

// Scratch words: tile ticket, done ticket, overflow, then one state per tile.
constexpr int kTileTicket = 0, kDoneTicket = 1, kOverflow = 2, kStates = 3;

__global__ void __launch_bounds__(kTile) bucket_plan_kernel(
    const unsigned long long* __restrict__ tfp,
    const unsigned long long* __restrict__ sfp,
    const long long* __restrict__ spl, const long long* __restrict__ bucket,
    const long long* __restrict__ order,
    const long long* __restrict__ cidx,  // null: no compaction
    const bool* __restrict__ cand_overflow, long long* __restrict__ tgt,
    long long* __restrict__ cfp, long long* __restrict__ cpl,
    long long* __restrict__ sel, long long* __restrict__ n_new,
    bool* __restrict__ overflow, unsigned long long* __restrict__ scratch,
    long long* __restrict__ stage,  // null: table order
    long long m, int ntiles) {
  __shared__ int s_tile;
  __shared__ int s_last;
  __shared__ Scan s_warp[kWarps];
  __shared__ Scan s_prefix;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* state = scratch + kStates;

  if (t == 0) s_tile = (int)atomicAdd(&scratch[kTileTicket], 1ULL);
  __syncthreads();
  const int tile = s_tile;
  const long long i = (long long)tile * kTile + t;

  // -- probe: a half-warp reads each of its 16 candidates' lines ----------
  const unsigned long long fp = i < m ? sfp[i] : kEmpty;
  const bool valid = fp != kEmpty;
  const long long b = valid ? bucket[i] : 0;
  const int half = lane & 16;  // first lane of this half-warp
  const int slot_lane = lane & 15;
  // unconditional loads (an EMPTY lane reads bucket 0's line, and its
  // result is masked below), so all sixteen are in flight at once
  unsigned long long v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long bk = __shfl_sync(kFull, b, half | k);
    v[k] = __ldg(tfp + bk * kSlots + slot_lane);
  }
  bool present = false;
  int base = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const unsigned long long f = __shfl_sync(kFull, fp, half | k);
    const unsigned hit = (__ballot_sync(kFull, v[k] == f) >> half) & 0xFFFFu;
    const unsigned used = (__ballot_sync(kFull, v[k] != kEmpty) >> half) & 0xFFFFu;
    if (slot_lane == k) {
      present = valid && hit != 0u;
      base = valid ? __popc(used) : 0;
    }
  }

  // -- plan: dedup, novelty, segment starts --------------------------------
  bool novel = false, bstart = false;
  if (valid) {
    novel = !present && (i == 0 || sfp[i - 1] != fp);
    bstart = i == 0 || bucket[i - 1] != b;
  }
  Scan x = {bstart ? 1u : 0u, novel ? 1u : 0u, novel ? 1u : 0u};

  // -- scan inside the tile, then across tiles ------------------------------
  const Scan incl = block_scan<kWarps>(x, s_warp);
  if (warp == 0) {
    const Scan excl = look_back(state, tile, s_warp[kWarps - 1]);
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();
  const Scan g = combine(s_prefix, incl);

  // -- write the novel lanes at their table-order positions, or stage
  // them at their candidate positions ---------------------------------------
  bool ovf = false;
  if (novel) {
    const int slot = base + (int)g.seg - 1;
    ovf = slot >= kSlots;
    const long long o = order[i];
    if (stage != nullptr) {
      stage[o] = b * kSlots + slot;
      stage[m + o] = (long long)fp;
      stage[2 * m + o] = spl[i];
    } else {
      const long long pos = (long long)g.tot - 1;
      tgt[pos] = b * kSlots + slot;
      cfp[pos] = (long long)fp;
      cpl[pos] = spl[i];
      sel[pos] = cidx != nullptr ? cidx[o] : o;
    }
  }
  const int tile_ovf = __syncthreads_or(ovf);

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
    const Scan total = unpack(ld_acquire(&state[ntiles - 1]));
    *overflow = any_ovf;
    *n_new = (any_ovf || *cand_overflow) ? 0LL : (long long)total.tot;
    scratch[kTileTicket] = 0ULL;
    scratch[kDoneTicket] = 0ULL;
    scratch[kOverflow] = 0ULL;
  }
  __syncthreads();  // thread 0 has read the last tile's state
  for (int k = t; k < ntiles; k += kTile) state[k] = 0ULL;
}

// Generation order's second launch: compact the staged records in
// candidate order (see the note at the top).
__global__ void __launch_bounds__(kTile) bucket_compact_kernel(
    long long* __restrict__ stage, const long long* __restrict__ cidx,
    long long* __restrict__ tgt, long long* __restrict__ cfp,
    long long* __restrict__ cpl, long long* __restrict__ sel,
    unsigned long long* __restrict__ scratch, long long m, int ntiles) {
  __shared__ int s_tile;
  __shared__ int s_last;
  __shared__ Scan s_warp[kWarps];
  __shared__ Scan s_prefix;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* state = scratch + kStates;

  if (t == 0) s_tile = (int)atomicAdd(&scratch[kTileTicket], 1ULL);
  __syncthreads();
  const int tile = s_tile;
  const long long p = (long long)tile * kTile + t;

  const long long staged = p < m ? stage[p] : -1LL;
  const bool live = staged >= 0;
  const Scan x = {0u, 0u, live ? 1u : 0u};
  const Scan incl = block_scan<kWarps>(x, s_warp);
  if (warp == 0) {
    const Scan excl = look_back(state, tile, s_warp[kWarps - 1]);
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();
  const Scan g = combine(s_prefix, incl);
  if (live) {
    const long long pos = (long long)g.tot - 1;
    tgt[pos] = staged;
    cfp[pos] = stage[m + p];
    cpl[pos] = stage[2 * m + p];
    sel[pos] = cidx != nullptr ? cidx[p] : p;
    stage[p] = -1LL;  // the area is all -1 again for the next launch
  }

  // -- the last CTA to finish resets the scratch ---------------------------
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
  }
  for (int k = t; k < ntiles; k += kTile) state[k] = 0ULL;
}

}  // namespace

extern "C" int srt_bucket_plan(const void* tfp, const void* sfp,
                               const void* spl, const void* bucket,
                               const void* order, const void* cidx,
                               const void* cand_overflow, void* tgt, void* cfp,
                               void* cpl, void* sel, void* n_new,
                               void* overflow, void* scratch, void* stage,
                               int64_t m, void* stream) {
  const long long ntiles = (m + kTile - 1) / kTile;
  bucket_plan_kernel<<<(unsigned)ntiles, kTile, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)tfp, (const unsigned long long*)sfp,
      (const long long*)spl, (const long long*)bucket,
      (const long long*)order, (const long long*)cidx,
      (const bool*)cand_overflow, (long long*)tgt, (long long*)cfp,
      (long long*)cpl, (long long*)sel, (long long*)n_new, (bool*)overflow,
      (unsigned long long*)scratch, (long long*)stage, (long long)m,
      (int)ntiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stage == nullptr) return (int)err;
  bucket_compact_kernel<<<(unsigned)ntiles, kTile, 0, (cudaStream_t)stream>>>(
      (long long*)stage, (const long long*)cidx, (long long*)tgt,
      (long long*)cfp, (long long*)cpl, (long long*)sel,
      (unsigned long long*)scratch, (long long)m, (int)ntiles);
  return (int)cudaGetLastError();
}

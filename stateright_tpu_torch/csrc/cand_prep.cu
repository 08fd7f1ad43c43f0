// Kernel cand_prep — the insert's candidate preparation, one pass.
//
// Replaces: the successor fingerprint with the engine's valid mask
// (`jnp.where(valid, row_hash(krows), EMPTY)`,
// stateright_tpu/parallel/wavefront.py:491, `row_hash` at
// stateright_tpu/ops/hashing.py:105), the parents' broadcast
// (wavefront.py:513), and `bucket_insert`'s budget compaction and sort key
// (stateright_tpu/ops/buckets.py:181-194 and `bucket_key`, :59-70).  In
// the port it stands where kernel B (`row_hash.cu`, which now serves only
// the init path), the `expand().reshape()` of the parents, the compaction
// of `sort_candidates` (cumsum, `searchsorted`, gathers) and `bucket_key`'s
// elementwise calls stood.  With M = B*A candidate lanes and the budget
// CB <= M, the valid lanes move in lane order to output lanes
// [0, min(n_valid, CB)), and output lane j of a valid lane i gets
//   fp      = the fold of `splitmix.cuh` over row i
//   payload = pfps[i / arity]   (the parent's fingerprint)
//   cidx    = i
//   key     = bucket_key(fp) ^ 2^63 (signed order = unsigned key order)
// In the namespace mode of a sweep (`ptags` not null), a valid lane's
// fingerprint is namespaced before it is keyed or written, as the JAX sweep
// step's `ns_hash(row_hash(succ), ...)` (stateright_tpu/sweep/engine.py:
// 234-238, stateright_tpu/ops/hashing.py:86): with t = ptags[i / arity],
//   key = ((mix64(fp) ^ ns_xor[t]) & ~low) | (ns_low[t] & low)
//   fp  = unmix64(key), 0 and EMPTY remapped to GAMMA
// with low = 2^bits - 1, and the lane's sort key is bucket_key of that
// namespaced fp (it differs from `key` after the remap).  The kernel
// computes mix64(fp) for the key anyway, so the mode costs a few register
// operations, one 4-byte tag and two table words per valid lane; with
// null tables the launch is the plain one.
// Output lanes [n_valid, CB) take what the JAX compaction gives them:
// fp EMPTY, key EMPTY ^ 2^63, cidx M-1, payload pfps[(M-1) / arity].
// The last CTA writes n_valid and cand_overflow = n_valid > CB.
//
// Bound on an H100: neither bytes nor operations.  At the engine's shapes
// (M 75,776, CB 32,768 for 2pc-7) the bytes take about 0.4 us; what the
// kernel's own time is made of is latency: dependent reads, the look-back
// chain across tiles, and at wide rows the row reads themselves.  The
// design:
//  - a CTA takes 1,024 input lanes (256 threads, four lanes each, lane
//    q = r * 256 + t of the tile in round r), so the look-back chain has
//    a quarter of the tiles (512 lanes measured the same on the card,
//    256 slower: PERF.md §6).  Ballots give each valid lane its rank among
//    the tile's valid lanes; one warp scans the 32 (round, warp) counts;
//    the rank is the lane's output slot in the tile, and each valid lane
//    writes its lane index to that slot of a shared list;
//  - the rows are then read in slot order, not lane order: thread t folds
//    slot t, t + 256, ..., so the outputs of consecutive threads go to
//    consecutive output lanes (coalesced writes).  For W > 1 the listed
//    rows are first staged in shared memory with coalesced `cp.async`
//    copies (`cp_async.cuh`, row_hash.cu's loader: thread t copies words
//    t, t + 256, ... of the listed rows, so a warp reads 256 consecutive
//    bytes of a row wherever rows are 8 * W bytes long; the words of
//    invalid rows are never read), at an odd stride (W | 1 words) so the
//    fold's 64-bit reads hit distinct banks.  The staging area is 40 KiB;
//    a tile whose valid rows do not fit is staged in batches of as many
//    rows as fit, and a row wider than the area (W > 5,119) is folded
//    from global memory.  W = 1 reads its one word directly, which is
//    coalesced already;
//  - the tile publishes its count at once, issues its first batch's
//    copies, and only then looks back (one warp), so the chain's latency
//    overlaps the row reads.  A tile with no valid lane does not look
//    back (its aggregate is all it publishes): later tiles look back
//    through it;
//  - dead output lanes belong to no input tile, so ceil(CB / 1024) more
//    CTAs cover them.  Their tile ids come from the same ticket after all
//    input tiles, so every input tile has started when one of their warps
//    reads the chain's total (`prefix_through` over the last input tile);
//    each then fills its lanes past n_valid.  Taking them off the chain
//    (the first tickets, every output lane filled before the input tiles
//    write theirs over it) measured 1-9 % slower: PERF.md §6;
//  - the last CTA to finish (a second ticket, over all CTAs) writes the
//    two scalars and zeroes the scratch, so a step needs no memset.
#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"
#include "lookback.cuh"
#include "splitmix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;  // input (or output) lanes per CTA
constexpr int kWarps = kThreads / 32;
static_assert(kRounds * kWarps <= 32, "one warp scans the tile's counts");
constexpr int kAreaWords = 5120;  // the staging area: 40 KiB
constexpr unsigned long long kSign = 1ULL << 63;

// Scratch words: tile ticket, done ticket, then one state per input tile
// (ops/cand_prep.py's PREP_SCRATCH counts the first two).
constexpr int kTileTicket = 0, kDoneTicket = 1, kStates = 2;

// `bucket_key` of a valid fingerprint (never EMPTY): mix64, with the one
// mix that equals EMPTY moved to EMPTY - 1 (same bucket).
__device__ __forceinline__ unsigned long long bucket_key(unsigned long long fp) {
  const unsigned long long k = mix64(fp);
  return k == kEmpty ? kEmpty - 1ULL : k;
}

__global__ void __launch_bounds__(kThreads) cand_prep_kernel(
    const unsigned long long* __restrict__ rows,
    const unsigned char* __restrict__ valid,
    const long long* __restrict__ pfps, long long* __restrict__ fp_out,
    long long* __restrict__ pl_out, long long* __restrict__ cidx_out,
    long long* __restrict__ key_out, long long* __restrict__ n_valid,
    bool* __restrict__ cand_overflow, unsigned long long* __restrict__ scratch,
    const int* __restrict__ ptags, const unsigned long long* __restrict__ ns_low,
    const unsigned long long* __restrict__ ns_xor, int bits, long long m,
    long long cb, int width, int arity, int stride, int batch_rows,
    int in_tiles, int all_tiles) {
  extern __shared__ unsigned long long area[];  // staged rows (W > 1)
  __shared__ int s_src[kTile];  // the tile's valid lanes, in lane order
  __shared__ int s_off[32];     // valid lanes before each (round, warp)
  __shared__ int s_tile, s_last, s_total;
  __shared__ long long s_before;  // valid lanes before this tile / in all
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* state = scratch + kStates;

  if (t == 0) s_tile = (int)atomicAdd(&scratch[kTileTicket], 1ULL);
  __syncthreads();
  const int tile = s_tile;  // the same in the whole CTA

  if (tile < in_tiles) {
    // -- an input tile: rank the valid lanes, publish the count ----------
    const long long base = (long long)tile * kTile;
    const unsigned lt = (1u << lane) - 1u;
    int rank[kRounds];
    unsigned mine = 0u;  // bit r: lane r * 256 + t is valid
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long i = base + r * kThreads + t;
      const bool v = i < m && valid[i] != 0;
      const unsigned b = __ballot_sync(kFull, v);
      if (lane == 0) s_off[r * kWarps + warp] = __popc(b);
      rank[r] = __popc(b & lt);
      mine |= (v ? 1u : 0u) << r;
    }
    __syncthreads();
    if (warp == 0) {
      const int c = lane < kRounds * kWarps ? s_off[lane] : 0;
      int x = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (lane < kRounds * kWarps) s_off[lane] = x - c;
      const int total = __shfl_sync(kFull, x, 31);
      if (lane == 0) {
        s_total = total;
        // published at once; a tile with valid lanes publishes its
        // prefix after its look-back, below
        publish_aggregate(state, tile, Scan{0u, 0u, (unsigned)total});
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (mine >> r & 1u) {
        s_src[s_off[r * kWarps + warp] + rank[r]] = (int)(base + r * kThreads + t);
      }
    }
    __syncthreads();
    const int total = s_total;
    if (total > 0) {
      // -- fold the listed rows in batches, slot s by thread s % 256 -----
      const bool staged = batch_rows > 0;
      const int per_batch = staged ? batch_rows : kTile;
      for (int b0 = 0; b0 < total; b0 += per_batch) {
        const int n = min(per_batch, total - b0);
        if (staged) {
          // word k = r * width + w of the batch, walked with stride 256
          // and (r, w) kept incrementally (no division in the loop)
          const int dr = kThreads / width, dw = kThreads - dr * width;
          int r = t / width, w = t - r * width;
          for (int k = t; k < n * width; k += kThreads) {
            cp_async8(area + r * stride + w,
                      rows + (long long)s_src[b0 + r] * width + w);
            r += dr;
            w += dw;
            if (w >= width) {
              w -= width;
              ++r;
            }
          }
        }
        if (b0 == 0 && warp == 0) {
          // the look-back, while the first batch's copies are in flight
          if (tile == 0) {
            if (lane == 0) s_before = 0;
          } else {
            const Scan excl = prefix_through(state, tile - 1);
            if (lane == 0) {
              const Scan agg = {0u, 0u, (unsigned)total};
              st_release(&state[tile], kPrefix | pack(combine(excl, agg)));
              s_before = excl.tot;
            }
          }
        }
        if (staged) cp_async_wait_all();
        __syncthreads();
        for (int s = b0 + t; s < b0 + n; s += kThreads) {
          const long long i = s_src[s];
          unsigned long long fp = staged
              ? row_fingerprint(area + (s - b0) * stride, width)
              : row_fingerprint(rows + i * width, width);
          if (ptags != nullptr) {
            const int tag = ptags[i / arity];
            const unsigned long long low = (1ULL << bits) - 1ULL;
            const unsigned long long nkey =
                ((mix64(fp) ^ ns_xor[tag]) & ~low) | (ns_low[tag] & low);
            const unsigned long long h = unmix64(nkey);
            fp = (h == 0ULL || h == kEmpty) ? kGamma : h;
          }
          const long long pos = s_before + s;
          if (pos < cb) {
            fp_out[pos] = (long long)fp;
            pl_out[pos] = pfps[i / arity];
            cidx_out[pos] = i;
            key_out[pos] = (long long)(bucket_key(fp) ^ kSign);
          }
        }
        __syncthreads();  // the area is free for the next batch
      }
    }
  } else {
    // -- a fill tile: the dead output lanes past n_valid ------------------
    if (warp == 0) {
      const Scan chain = prefix_through(state, in_tiles - 1);
      if (lane == 0) s_before = chain.tot;
    }
    __syncthreads();
    const long long nv = s_before;
    const long long pl = pfps[(m - 1) / arity];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long j = (long long)(tile - in_tiles) * kTile + r * kThreads + t;
      if (j < cb && j >= nv) {
        fp_out[j] = (long long)kEmpty;
        pl_out[j] = pl;
        cidx_out[j] = m - 1;
        key_out[j] = (long long)(kEmpty ^ kSign);
      }
    }
  }

  // -- the last CTA to finish writes the scalars and resets the scratch ---
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(&scratch[kDoneTicket], 1ULL) ==
             (unsigned long long)(all_tiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (warp == 0) {
    const long long total = (long long)prefix_through(state, in_tiles - 1).tot;
    if (lane == 0) {
      *n_valid = total;
      *cand_overflow = total > cb;
      scratch[kTileTicket] = 0ULL;
      scratch[kDoneTicket] = 0ULL;
    }
  }
  __syncthreads();  // warp 0 has read the input tiles' states
  for (int k = t; k < in_tiles; k += kThreads) state[k] = 0ULL;
}

}  // namespace

extern "C" int srt_cand_prep(const void* rows, const void* valid,
                             const void* pfps, void* fp, void* payload,
                             void* cidx, void* key, void* n_valid,
                             void* cand_overflow, void* scratch,
                             const void* ptags, const void* ns_low,
                             const void* ns_xor, int bits, int64_t m,
                             int64_t cb, int width, int arity, void* stream) {
  const long long in_tiles = (m + kTile - 1) / kTile;
  const long long all_tiles = in_tiles + (cb + kTile - 1) / kTile;
  // rows are staged when W > 1 and one row fits the area; else folded
  // from global memory (batch_rows 0, no dynamic shared memory)
  const int stride = width | 1;
  const int batch_rows = (width > 1 && stride <= kAreaWords)
                             ? kAreaWords / stride : 0;
  const size_t smem = batch_rows > 0 ? (size_t)kAreaWords * 8 : 0;
  cand_prep_kernel<<<(unsigned)all_tiles, kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const unsigned long long*)rows, (const unsigned char*)valid,
      (const long long*)pfps, (long long*)fp, (long long*)payload,
      (long long*)cidx, (long long*)key, (long long*)n_valid,
      (bool*)cand_overflow, (unsigned long long*)scratch, (const int*)ptags,
      (const unsigned long long*)ns_low, (const unsigned long long*)ns_xor,
      bits, (long long)m, (long long)cb, width, arity, stride, batch_rows,
      (int)in_tiles, (int)all_tiles);
  return (int)cudaGetLastError();
}

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
// (M 75,776, CB 32,768 for 2pc-7) the bytes take about 0.4 us, so what the
// step pays for is launches: the composed PyTorch version is some thirty
// calls, each with its intermediate array in device memory.  The design is
// one launch:
//  - one CTA per 256 input lanes; a thread reads its valid byte and, for
//    a valid lane, its row, and keeps fingerprint and key in registers;
//  - the output position is the count of valid lanes before i: one scan
//    of {0, 0, valid} inside the tile and decoupled look-back across
//    tiles (`lookback.cuh`, the scan of bucket_plan.cu), with tile ids
//    from an atomic ticket;
//  - dead output lanes belong to no input tile, so ceil(CB / 256) more
//    CTAs cover them.  Their tile ids come from the same ticket after all
//    input tiles, so the last input tile has started when they wait for
//    its inclusive count (n_valid); each then fills its lanes past it;
//  - the last CTA to finish (a second ticket, over all CTAs) writes the
//    two scalars and zeroes the scratch, so a step needs no memset.
#include <cuda_runtime.h>
#include <cstdint>

#include "lookback.cuh"
#include "splitmix.cuh"

namespace {

constexpr int kTile = 256;  // input lanes (or output lanes) per CTA
constexpr int kWarps = kTile / 32;
constexpr unsigned long long kSign = 1ULL << 63;

// Scratch words: tile ticket, done ticket, then one state per input tile.
constexpr int kTileTicket = 0, kDoneTicket = 1, kStates = 2;

// `bucket_key` of a valid fingerprint (never EMPTY): mix64, with the one
// mix that equals EMPTY moved to EMPTY - 1 (same bucket).
__device__ __forceinline__ unsigned long long bucket_key(unsigned long long fp) {
  const unsigned long long k = mix64(fp);
  return k == kEmpty ? kEmpty - 1ULL : k;
}

__global__ void __launch_bounds__(kTile) cand_prep_kernel(
    const unsigned long long* __restrict__ rows,
    const unsigned char* __restrict__ valid,
    const long long* __restrict__ pfps, long long* __restrict__ fp_out,
    long long* __restrict__ pl_out, long long* __restrict__ cidx_out,
    long long* __restrict__ key_out, long long* __restrict__ n_valid,
    bool* __restrict__ cand_overflow, unsigned long long* __restrict__ scratch,
    const int* __restrict__ ptags, const unsigned long long* __restrict__ ns_low,
    const unsigned long long* __restrict__ ns_xor, int bits, long long m,
    long long cb, int width, int arity, int in_tiles, int all_tiles) {
  __shared__ int s_tile;
  __shared__ int s_last;
  __shared__ Scan s_warp[kWarps];
  __shared__ unsigned s_before;  // valid lanes before this tile / in all
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* state = scratch + kStates;

  if (t == 0) s_tile = (int)atomicAdd(&scratch[kTileTicket], 1ULL);
  __syncthreads();
  const int tile = s_tile;  // the same in the whole CTA

  if (tile < in_tiles) {
    // -- an input tile: hash, count, then write the valid lanes ----------
    const long long i = (long long)tile * kTile + t;
    const bool v = i < m && valid[i] != 0;
    unsigned long long fp = kEmpty;
    if (v) fp = row_fingerprint(rows + i * (long long)width, width);
    if (v && ptags != nullptr) {
      const int tag = ptags[i / arity];
      const unsigned long long low = (1ULL << bits) - 1ULL;
      const unsigned long long nkey =
          ((mix64(fp) ^ ns_xor[tag]) & ~low) | (ns_low[tag] & low);
      const unsigned long long h = unmix64(nkey);
      fp = (h == 0ULL || h == kEmpty) ? kGamma : h;
    }
    const Scan incl = block_scan<kWarps>(Scan{0u, 0u, v ? 1u : 0u}, s_warp);
    if (warp == 0) {
      const Scan excl = look_back(state, tile, s_warp[kWarps - 1]);
      if (lane == 0) s_before = excl.tot;
    }
    __syncthreads();
    const long long pos = (long long)s_before + incl.tot - 1;
    if (v && pos < cb) {
      fp_out[pos] = (long long)fp;
      pl_out[pos] = pfps[i / arity];
      cidx_out[pos] = i;
      key_out[pos] = (long long)(bucket_key(fp) ^ kSign);
    }
  } else {
    // -- a fill tile: the dead output lanes past n_valid ------------------
    if (t == 0) s_before = wait_prefix(state, in_tiles - 1).tot;
    __syncthreads();
    const long long j = (long long)(tile - in_tiles) * kTile + t;
    if (j < cb && j >= (long long)s_before) {
      fp_out[j] = (long long)kEmpty;
      pl_out[j] = pfps[(m - 1) / arity];
      cidx_out[j] = m - 1;
      key_out[j] = (long long)(kEmpty ^ kSign);
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
  if (t == 0) {
    const long long total = (long long)unpack(ld_acquire(&state[in_tiles - 1])).tot;
    *n_valid = total;
    *cand_overflow = total > cb;
    scratch[kTileTicket] = 0ULL;
    scratch[kDoneTicket] = 0ULL;
  }
  __syncthreads();  // thread 0 has read the last input tile's state
  for (int k = t; k < in_tiles; k += kTile) state[k] = 0ULL;
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
  cand_prep_kernel<<<(unsigned)all_tiles, kTile, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)rows, (const unsigned char*)valid,
      (const long long*)pfps, (long long*)fp, (long long*)payload,
      (long long*)cidx, (long long*)key, (long long*)n_valid,
      (bool*)cand_overflow, (unsigned long long*)scratch, (const int*)ptags,
      (const unsigned long long*)ns_low, (const unsigned long long*)ns_xor,
      bits, (long long)m, (long long)cb, width, arity, (int)in_tiles,
      (int)all_tiles);
  return (int)cudaGetLastError();
}

// Kernel insert_commit — the visited-set insert's write and the queue append.
//
// Replaces: the Pallas kernel `_insert_kernel` driven by
// `pallas_scatter_insert` (stateright_tpu/ops/pallas_insert.py:85, wrapper
// :297), and the queue append of the engine step (`append_novel`,
// stateright_tpu/parallel/wavefront.py:369).  In the port it stands where
// kernel A (`insert_write`) and the engine's append (four gathers by `sel`
// and four `index_put_` into the queue) stood.
//
// Contract, for each j < *n_new (n_new, tail and the plan stay on the
// device, so the host never learns the count):
//  - table half, the Pallas kernel's: tfp[tgt[j]] = cfp[j] and
//    tpl[tgt[j]] = cpl[j].  The slots are distinct (bucket * 16 +
//    occupancy + rank, from bucket_plan), so no two threads touch one
//    slot: no atomics, no sort, and write order cannot matter;
//  - queue half (skipped when `qrows` is null): row tail + j gets the
//    candidate row sel[j], its fingerprint cfp[j], and its parent's ebits
//    and depth + 1, read at parent sel[j] / arity, so the engine makes no
//    per-candidate copies of the parents' lanes.
//  - tag column of a sweep (skipped when `qtag` is null): row tail + j also
//    gets its parent's instance tag, qtag[r] = ptag[sel[j] / arity] (the
//    JAX sweep step's `q_tag` update, stateright_tpu/sweep/engine.py:
//    250-252).
// Lanes at or past *n_new write nothing.  The source rows `crows` are the
// step's candidates (or the spill tier's pending rows), never the queue.
//
// The window mode (the mesh engine, stateright_tpu_torch/parallel/mesh.py;
// `srt_insert_commit_window`) is a null-table launch of the queue half for
// one piece of a queue held in row pieces: the piece holds global rows
// [qlo, qhi), and lane j writes row tail + j only when it falls there, at
// the piece's row tail + j - qlo.  The engine launches it once per piece,
// on that piece's device, with the merged novel lanes of the whole step,
// so the rows [tail, tail + n_new) may cross a piece boundary and no host
// learns n_new.  The lanes a piece takes are one contiguous range, so the
// window mode is the plain launch over the lanes [qlo - tail, qhi - tail)
// clipped to [0, n_new), with no table half and no tag column: a template
// instance of its own.
//
// Bound on an H100: memory traffic, and at the engine's shapes the launch
// itself.  A live lane reads 32 bytes of plan, 8*W of row and 8 of parent
// lanes, and writes 16 table bytes at a random slot (two 32-byte sectors)
// and 8*W + 16 queue bytes at consecutive rows.  The TPU kernel sorted
// candidates by slot and streamed 1,024-slot blocks through an 8-deep DMA
// ring because its scatters are index-serial; on the GPU every thread
// issues independent stores.  The design (each choice measured against
// its alternatives by kernel_ab.py, PERF.md §6):
//  - a CTA (256 threads) takes a tile of T consecutive novel lanes, T =
//    min(256, kTileWords / W) (at least 1), so a tile's rows are about
//    kTileWords words wherever W > 4 and a wide batch still spreads over
//    many SMs (1,024 words beat 2,048 and 4,096; 256 lanes at every
//    width was 2-4 x slower at W >= 21).  Thread t < T owns lane
//    j = j0 + t: it writes the table half and the queue's per-row words
//    at r = tail + j (consecutive threads, consecutive rows: coalesced),
//    and puts sel[j] in shared memory.  Its parent's ebits and depth are
//    loaded before the row copy below and stored after it, so that load's
//    latency overlaps the copy's instead of adding to it;
//  - W > 1: the tile's destination rows [tail + j0, tail + j0 + live) are
//    one contiguous span of live * W words of `qrows`, and the whole CTA
//    copies it by flat index k: dst[k] = crows[sel[j0 + k / W] * W +
//    k % W].  Stores are fully coalesced, loads coalesced within each
//    source row (W contiguous words); each thread keeps kUnroll loads in
//    flight, and walks (k / W, k % W) by increments, with no division in
//    the loop.  At W = 1 the flat index is the lane itself: each thread
//    loads its own lane's word beside its parent's lanes, not through the
//    shared list (that way the mesh's window append took 0.0025 ms, this
//    way 0.0024, a thread-per-row copy 0.0022).  The two barriers stay at
//    every width: making them conditional on W > 1 cost 10-15 % at
//    W >= 21;
//  - the grid is capped at kCtasPerSm CTAs per SM and each CTA strides
//    over the tiles below *n_new (read once a CTA; no host read): a spill
//    inject's 245,760 plan lanes would otherwise start thousands of CTAs
//    that only read the count (0.0078 against 0.0034 ms).  Two an SM
//    measured the same as one, and keep a batch of 65,536 lanes at W = 1
//    in one round of tiles: there the capped grid is the uncapped one.
// Every row offset is 64-bit: a sweep's queue holds millions of rows.
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a CTA, and the most lanes a tile takes
constexpr int kTileWords = 1024;  // ops/insert_commit.py::COMMIT_TILE_WORDS
constexpr int kCtasPerSm = 2;
constexpr int kUnroll = 4;  // row words in flight per thread

// Lanes a tile takes at row width `width` (0: no queue half).
__host__ __device__ inline int tile_lanes(int width) {
  if (width <= 0) return kThreads;
  const int t = kTileWords / width;
  return t < 1 ? 1 : (t > kThreads ? kThreads : t);
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads) insert_commit_kernel(
    long long* __restrict__ tfp, long long* __restrict__ tpl,
    const long long* __restrict__ tgt, const long long* __restrict__ cfp,
    const long long* __restrict__ cpl, const long long* __restrict__ n_new,
    long long m, long long* __restrict__ qrows, long long* __restrict__ qfp,
    int* __restrict__ qebits, int* __restrict__ qdepth,
    const long long* __restrict__ tail, const long long* __restrict__ sel,
    const long long* __restrict__ crows, const int* __restrict__ pebits,
    const int* __restrict__ pdepth, int* __restrict__ qtag,
    const int* __restrict__ ptag, int width, int arity, long long qlo,
    long long qhi) {
  __shared__ long long s_sel[kThreads];
  const bool queue = qrows != nullptr;
  const int tile = tile_lanes(queue ? width : 0);
  const int t = threadIdx.x;
  long long lo = 0, hi = *n_new;
  if (hi > m) hi = m;
  long long base = 0;  // lane j's row in this launch's queue: base + j
  if (queue) {
    base = *tail - qlo;
    if (kWindow) {  // the lanes whose rows fall in [qlo, qhi)
      if (-base > lo) lo = -base;
      if (qhi - qlo - base < hi) hi = qhi - qlo - base;
    }
  }
  // (k / W, k % W) advances by (dl, dw) when k advances by kThreads
  const int dl = queue && width > 0 ? kThreads / width : 0;
  const int dw = kThreads - dl * width;
  for (long long j0 = lo + (long long)blockIdx.x * tile; j0 < hi;
       j0 += (long long)gridDim.x * tile) {
    const int live = (int)(hi - j0 < tile ? hi - j0 : tile);
    const bool mine = t < live;
    const long long r = base + j0 + t;  // this thread's lane's row
    long long s = 0;
    if (mine) {
      const long long j = j0 + t;
      const long long f = cfp[j];
      if (queue) {
        s = sel[j];
        s_sel[t] = s;
      }
      if (!kWindow) {
        const long long slot = tgt[j];
        tfp[slot] = f;
        tpl[slot] = cpl[j];
      }
      if (queue) qfp[r] = f;
    }
    if (!queue) continue;
    __syncthreads();
    // the parent's lanes (and at W = 1 the row) are loaded before the row
    // copy and stored after it, so their latency overlaps the copy's
    int eb = 0, dp = 0, tg = 0;
    long long row = 0;
    if (mine) {
      const long long p = s / arity;
      eb = pebits[p];
      dp = pdepth[p];
      if (qtag != nullptr) tg = ptag[p];
      if (width == 1) row = crows[s];
    }
    if (width > 1) {  // the tile's rows: one contiguous span of live * W
      long long* dst = qrows + (base + j0) * width;
      const int total = live * width;
      int lane = t / width, w = t - (t / width) * width;
      for (int k0 = t; k0 < total; k0 += kThreads * kUnroll) {
        long long v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k0 + u * kThreads < total)
            v[u] = crows[s_sel[lane] * width + w];
          lane += dl;
          w += dw;
          if (w >= width) {
            w -= width;
            ++lane;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k0 + u * kThreads < total) dst[k0 + u * kThreads] = v[u];
        }
      }
    }
    if (mine) {
      if (width == 1) qrows[r] = row;
      qebits[r] = eb;
      qdepth[r] = dp + 1;
      if (qtag != nullptr) qtag[r] = tg;
    }
    __syncthreads();  // the next tile rewrites s_sel
  }
}

// The SMs of the current device, asked once per device.
int sm_count() {
  static std::atomic<int> known[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  int n = known[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
    known[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// CTAs for m lanes at row width `width`: one a tile, at most kCtasPerSm
// an SM (the CTAs stride over the tiles).
unsigned grid_for(long long m, int width) {
  const int tile = tile_lanes(width);
  const long long blocks = (m + tile - 1) / tile;
  const long long cap = (long long)kCtasPerSm * sm_count();
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" int srt_insert_commit(void* tfp, void* tpl, const void* tgt,
                                 const void* cfp, const void* cpl,
                                 const void* n_new, int64_t m, void* qrows,
                                 void* qfp, void* qebits, void* qdepth,
                                 const void* tail, const void* sel,
                                 const void* crows, const void* pebits,
                                 const void* pdepth, void* qtag,
                                 const void* ptag, int width, int arity,
                                 void* stream) {
  const unsigned blocks = grid_for(m, qrows != nullptr ? width : 0);
  insert_commit_kernel<false>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (long long*)tfp, (long long*)tpl, (const long long*)tgt,
          (const long long*)cfp, (const long long*)cpl,
          (const long long*)n_new, (long long)m, (long long*)qrows,
          (long long*)qfp, (int*)qebits, (int*)qdepth,
          (const long long*)tail, (const long long*)sel,
          (const long long*)crows, (const int*)pebits, (const int*)pdepth,
          (int*)qtag, (const int*)ptag, width, arity, 0, 0);
  return (int)cudaGetLastError();
}

// The window mode: the queue half only (no table, no tag column), rows
// [qlo, qhi) of the global queue, held by this piece from its row 0.
extern "C" int srt_insert_commit_window(
    const void* cfp, const void* n_new, int64_t m, void* qrows, void* qfp,
    void* qebits, void* qdepth, const void* tail, const void* sel,
    const void* crows, const void* pebits, const void* pdepth, int64_t qlo,
    int64_t qhi, int width, int arity, void* stream) {
  const unsigned blocks = grid_for(m, width);
  insert_commit_kernel<true>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          nullptr, nullptr, nullptr, (const long long*)cfp, nullptr,
          (const long long*)n_new, (long long)m, (long long*)qrows,
          (long long*)qfp, (int*)qebits, (int*)qdepth,
          (const long long*)tail, (const long long*)sel,
          (const long long*)crows, (const int*)pebits, (const int*)pdepth,
          nullptr, nullptr, width, arity, (long long)qlo, (long long)qhi);
  return (int)cudaGetLastError();
}

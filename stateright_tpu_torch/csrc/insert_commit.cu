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
// Lanes at or past *n_new write nothing.
//
// The window mode (the mesh engine, stateright_tpu_torch/parallel/mesh.py;
// `srt_insert_commit_window`) is a null-table launch of the queue half for
// one piece of a queue held in row pieces: the piece holds global rows
// [qlo, qhi), and a lane writes row tail + j only when it falls there, at
// the piece's row tail + j - qlo.  The engine launches it once per piece,
// on that piece's device, with the merged novel lanes of the whole step,
// so the rows [tail, tail + n_new) may cross a piece boundary and no host
// learns n_new.  It is a template instance of its own: the plain launch
// above compiles to the same code it always did.
//
// Bound on an H100: memory traffic, and at the engine's shapes the launch
// itself.  A live lane reads 32 bytes of plan, 8*W of row and 8 of parent
// lanes, and writes 16 table bytes at a random slot (two 32-byte sectors)
// and 8*W + 16 queue bytes at consecutive rows.  The TPU kernel sorted
// candidates by slot and streamed 1,024-slot blocks through an 8-deep DMA
// ring because its scatters are index-serial; on the GPU every thread
// issues independent stores, so the design is one thread per lane, with
// both halves in one launch.  One thread copies a whole row: the engine's
// rows are a word or a few (2pc: 1), so a warp per row would idle.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <bool kWindow>
__global__ void insert_commit_kernel(
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
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m || j >= *n_new) return;
  const long long f = cfp[j];
  if (!kWindow) {
    const long long slot = tgt[j];
    tfp[slot] = f;
    tpl[slot] = cpl[j];
    if (qrows == nullptr) return;
  }
  long long r = *tail + j;
  if (kWindow) {
    if (r < qlo || r >= qhi) return;
    r -= qlo;
  }
  const long long s = sel[j];
  const long long p = s / arity;
  qfp[r] = f;
  qebits[r] = pebits[p];
  qdepth[r] = pdepth[p] + 1;
  if (qtag != nullptr) qtag[r] = ptag[p];
  const long long* src = crows + s * width;
  long long* dst = qrows + r * width;
  for (int w = 0; w < width; ++w) dst[w] = src[w];
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
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  insert_commit_kernel<false>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
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
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  insert_commit_kernel<true>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          nullptr, nullptr, nullptr, (const long long*)cfp, nullptr,
          (const long long*)n_new, (long long)m, (long long*)qrows,
          (long long*)qfp, (int*)qebits, (int*)qdepth,
          (const long long*)tail, (const long long*)sel,
          (const long long*)crows, (const int*)pebits, (const int*)pdepth,
          nullptr, nullptr, width, arity, (long long)qlo, (long long)qhi);
  return (int)cudaGetLastError();
}

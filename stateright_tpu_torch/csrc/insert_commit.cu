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

__global__ void insert_commit_kernel(
    long long* __restrict__ tfp, long long* __restrict__ tpl,
    const long long* __restrict__ tgt, const long long* __restrict__ cfp,
    const long long* __restrict__ cpl, const long long* __restrict__ n_new,
    long long m, long long* __restrict__ qrows, long long* __restrict__ qfp,
    int* __restrict__ qebits, int* __restrict__ qdepth,
    const long long* __restrict__ tail, const long long* __restrict__ sel,
    const long long* __restrict__ crows, const int* __restrict__ pebits,
    const int* __restrict__ pdepth, int* __restrict__ qtag,
    const int* __restrict__ ptag, int width, int arity) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m || j >= *n_new) return;
  const long long f = cfp[j];
  const long long slot = tgt[j];
  tfp[slot] = f;
  tpl[slot] = cpl[j];
  if (qrows == nullptr) return;
  const long long r = *tail + j;
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
  insert_commit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (long long*)tfp, (long long*)tpl, (const long long*)tgt,
      (const long long*)cfp, (const long long*)cpl, (const long long*)n_new,
      (long long)m, (long long*)qrows, (long long*)qfp, (int*)qebits,
      (int*)qdepth, (const long long*)tail, (const long long*)sel,
      (const long long*)crows, (const int*)pebits, (const int*)pdepth,
      (int*)qtag, (const int*)ptag, width, arity);
  return (int)cudaGetLastError();
}

// Kernel A — the visited-set insert's write half.
//
// Replaces: the Pallas kernel `_insert_kernel` driven by
// `pallas_scatter_insert` (stateright_tpu/ops/pallas_insert.py:85, wrapper
// :297), and the windowed-scatter while_loop it stands in for
// (stateright_tpu/ops/buckets.py:314-339).  Contract: write the first
// `*n_new` pairs (cfp[i], cpl[i]) to table slots tgt[i], in place.  The
// slots are distinct (bucket * 16 + occupancy + rank, computed by
// bucket_insert before this runs), so no two threads touch one slot: no
// atomics, no sort, and write order cannot matter.
//
// Bound on an H100: memory traffic.  Each live lane reads 24 bytes
// (tgt, cfp, cpl; coalesced) and writes 2 x 8 bytes to a random slot, and
// a random 8-byte store costs a whole 32-byte sector, so the real traffic
// is about 88 bytes per novel candidate against 40 moved.  The
// TPU kernel sorted candidates by slot and streamed 1,024-slot blocks
// through an 8-deep DMA ring because its scatters are index-serial; on the
// GPU every SM issues independent stores, and at about one candidate per
// block a block-granular read-modify-write would move two 8 KiB blocks in
// and out per candidate (docs/pallas-insert-verdict.md), so the design is
// one thread per lane.
// `n_new` stays a device pointer: the host never syncs to learn the count,
// and lanes at or past it return at once.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void insert_write_kernel(long long* __restrict__ tfp,
                                    long long* __restrict__ tpl,
                                    const long long* __restrict__ tgt,
                                    const long long* __restrict__ cfp,
                                    const long long* __restrict__ cpl,
                                    const long long* __restrict__ n_new,
                                    long long m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m || i >= *n_new) return;  // pad lanes (tgt == nslots) lie past it
  const long long t = tgt[i];
  tfp[t] = cfp[i];
  tpl[t] = cpl[i];
}

}  // namespace

extern "C" int srt_insert_write(void* tfp, void* tpl, const void* tgt,
                                const void* cfp, const void* cpl,
                                const void* n_new, int64_t m, void* stream) {
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  insert_write_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (long long*)tfp, (long long*)tpl, (const long long*)tgt,
      (const long long*)cfp, (const long long*)cpl, (const long long*)n_new,
      (long long)m);
  return (int)cudaGetLastError();
}

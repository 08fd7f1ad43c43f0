// Kernel B — the state fingerprint.
//
// Replaces: `row_hash` (stateright_tpu/ops/hashing.py:105, with `fold64`
// and `mix64`) together with the `jnp.where(valid, row_hash(..), EMPTY)`
// mask the engine applies to it (stateright_tpu/parallel/wavefront.py:491).
// One thread per row: the fold of `splitmix.cuh`, and rows whose `valid`
// byte is 0 get EMPTY.  Bit-identical to the host's
// `fingerprint.hash_words` (pinned by tests/test_torch_hashing.py against
// the JAX package and on the card by chip_smoke.py).  The engine's step
// hashes its successors inside `cand_prep.cu`; this kernel serves the
// init path and every caller outside the step.
//
// Bound on an H100: memory traffic.  A row reads 8*W bytes plus one valid
// byte and writes 8; the fold is 2 64-bit multiplies and 3 shift-xors per
// word, a few dozen integer instructions, far under the card's integer
// rate per byte moved.  Neighbouring threads read neighbouring rows, so
// for the engine's W=1 rows the loads coalesce; the design keeps the whole
// fold in registers and writes each fingerprint once.
#include <cuda_runtime.h>
#include <cstdint>

#include "splitmix.cuh"

namespace {

__global__ void row_hash_kernel(const unsigned long long* __restrict__ rows,
                                const unsigned char* __restrict__ valid,
                                unsigned long long* __restrict__ out,
                                long long n, int width) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (valid != nullptr && !valid[i]) {
    out[i] = kEmpty;
    return;
  }
  out[i] = row_fingerprint(rows + i * (long long)width, width);
}

}  // namespace

extern "C" int srt_row_hash(const void* rows, const void* valid, void* out,
                            int64_t n, int width, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  row_hash_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)rows, (const unsigned char*)valid,
      (unsigned long long*)out, (long long)n, width);
  return (int)cudaGetLastError();
}

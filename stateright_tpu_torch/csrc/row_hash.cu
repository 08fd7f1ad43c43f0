// Kernel B — the state fingerprint.
//
// Replaces: `row_hash` (stateright_tpu/ops/hashing.py:105, with `fold64`
// and `mix64`) together with the `jnp.where(valid, row_hash(..), EMPTY)`
// mask the engine applies to it (stateright_tpu/parallel/wavefront.py:491).
// One thread per row: the splitmix64 fold over the row's W words from the
// fixed seed, a fold of the length W, then 0 and EMPTY remap to GAMMA, and
// rows whose `valid` byte is 0 get EMPTY.  Bit-identical to the host's
// `fingerprint.hash_words` (pinned by tests/test_torch_hashing.py against
// the JAX package and on the card by chip_smoke.py).
//
// Bound on an H100: memory traffic.  A row reads 8*W bytes plus one valid
// byte and writes 8; the fold is 2 64-bit multiplies and 3 shift-xors per
// word, a few dozen integer instructions, far under the card's integer
// rate per byte moved.  Neighbouring threads read neighbouring rows, so
// for the engine's W=1 rows the loads coalesce; the design keeps the whole
// fold in registers and writes each fingerprint once.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned long long kGamma = 0x9E3779B97F4A7C15ULL;
constexpr unsigned long long kM1 = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kM2 = 0x94D049BB133111EBULL;
constexpr unsigned long long kSeed = 0x5374617465544655ULL;  // "StateTFU"
constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFULL;

__device__ __forceinline__ unsigned long long mix64(unsigned long long h) {
  h ^= h >> 30;
  h *= kM1;
  h ^= h >> 27;
  h *= kM2;
  h ^= h >> 31;
  return h;
}

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
  const unsigned long long* row = rows + i * (long long)width;
  unsigned long long h = kSeed;
  for (int w = 0; w < width; ++w) h = mix64((h ^ row[w]) + kGamma);
  h = mix64((h ^ (unsigned long long)width) + kGamma);
  if (h == 0ULL || h == kEmpty) h = kGamma;
  out[i] = h;
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

// Kernel B — the state fingerprint.
//
// Replaces: `row_hash` (stateright_tpu/ops/hashing.py:105, with `fold64`
// and `mix64`) together with the `jnp.where(valid, row_hash(..), EMPTY)`
// mask the engine applies to it (stateright_tpu/parallel/wavefront.py:491).
// Each row's fingerprint is the fold of `splitmix.cuh`, and rows whose
// `valid` byte is 0 get EMPTY.  Bit-identical to the host's
// `fingerprint.hash_words` (pinned by tests/test_torch_hashing.py against
// the JAX package and on the card by chip_smoke.py).  The engine's step
// hashes its successors inside `cand_prep.cu`; this kernel serves the
// init path and every caller outside the step.
//
// Bound on an H100: memory traffic.  A row reads 8*W bytes plus one valid
// byte and writes 8; the fold is 2 64-bit multiplies and 3 shift-xors per
// word, far under the card's integer rate per byte moved.
//
// Design: a block owns a tile of consecutive rows, which is one contiguous
// span of `rows * W` words in memory.  The block first reads the tile's
// valid bytes, then stages the valid rows' words in shared memory with
// coalesced `cp.async` copies (thread t copies words t, t + T, ..., so a
// warp reads 256 consecutive bytes per instruction whatever W is; a
// thread issues all its copies before it waits once; the words of invalid
// rows are not read, so a sparse mask costs no row traffic), then each
// thread folds its own row out of shared memory.  Folding straight from
// global memory, as one thread per row, makes every 8-byte load of a warp
// touch 32 rows 8*W bytes apart: each such load is 32 separate requests
// to the L1.  (A first staged design that copied through registers, a
// load then a store per word, was slower than that at every width: each
// word's load stalled its thread.)  Shared rows are stored at an odd
// stride (W | 1 words) so that the 64-bit reads of the fold hit distinct
// banks.  The tile is as many rows as fit in 48 KiB, at most 64 (small
// tiles keep many blocks resident, so one block's staging overlaps
// another's fold; 128 measured the same); a width whose single row does
// not fit (W > 6135) is refused.
#include <cuda_runtime.h>
#include <cstdint>

#include "splitmix.cuh"

namespace {

constexpr int kMaxTile = 64;
// the dynamic tile's share of a block's 48 KiB; `keep` takes the rest
constexpr int kSmemBytes = 48 * 1024 - kMaxTile;

// One 8-byte global-to-shared copy that bypasses the registers: a thread
// issues all of its copies back to back and waits once.
__device__ __forceinline__ void cp_async8(unsigned long long* smem,
                                          const unsigned long long* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

__global__ void row_hash_tiled(const unsigned long long* __restrict__ rows,
                               const unsigned char* __restrict__ valid,
                               unsigned long long* __restrict__ out,
                               long long n, int width, int stride) {
  extern __shared__ unsigned long long tile[];
  __shared__ unsigned char keep[kMaxTile];
  const int tr = blockDim.x;  // rows per tile
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * tr;
  const long long left = n - r0;
  const int rows_here = left < tr ? (int)left : tr;
  if (t < rows_here) keep[t] = valid == nullptr ? 1 : valid[r0 + t];
  __syncthreads();
  // word k = r * width + w of the tile's span, walked with stride tr and
  // (r, w) kept incrementally (no division in the loop)
  const unsigned long long* src = rows + r0 * (long long)width;
  const int words = rows_here * width;
  if (width > 0) {
    const int dr = tr / width, dw = tr - dr * width;
    int r = t / width, w = t - r * width;
    for (int k = t; k < words; k += tr) {
      if (keep[r]) cp_async8(tile + r * stride + w, src + k);
      r += dr;
      w += dw;
      if (w >= width) {
        w -= width;
        ++r;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (t >= rows_here) return;
  out[r0 + t] = keep[t] ? row_fingerprint(tile + t * stride, width) : kEmpty;
}

}  // namespace

extern "C" int srt_row_hash(const void* rows, const void* valid, void* out,
                            int64_t n, int width, void* stream) {
  const int stride = width | 1;
  int tile = kSmemBytes / (8 * stride);
  if (tile < 1) return (int)cudaErrorInvalidValue;
  if (tile > kMaxTile) tile = kMaxTile;
  const long long blocks = (n + tile - 1) / tile;
  row_hash_tiled<<<(unsigned)blocks, tile, (size_t)tile * stride * 8,
                   (cudaStream_t)stream>>>(
      (const unsigned long long*)rows, (const unsigned char*)valid,
      (unsigned long long*)out, (long long)n, width, stride);
  return (int)cudaGetLastError();
}

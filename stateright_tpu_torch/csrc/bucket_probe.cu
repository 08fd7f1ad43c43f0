// Kernel C — membership and occupancy over the 16-slot bucket line.
//
// Replaces: the membership/occupancy `while_loop` inside `bucket_insert`
// (stateright_tpu/ops/buckets.py:229-264): for each candidate, sorted by
// bucket key, `present = any(line == fp)` and `base = count(line != EMPTY)`
// over its bucket's line of 16 fingerprints (slots fill densely and never
// free, so the non-EMPTY count is the next free slot).  The JAX loop walked
// the valid prefix in `window`-wide chunks so padding lanes cost nothing;
// here one thread per lane returns at once on an EMPTY (invalid) lane,
// writing (false, 0), and the count of valid lanes never leaves the device.
//
// Bound on an H100: memory traffic, and latency of the random line reads.
// Every lane reads its 8-byte fingerprint; a valid lane also reads its
// 8-byte bucket index (EMPTY lanes sort last, so the skipped reads are one
// contiguous tail) and one 128-byte line (four 32-byte sectors, one aligned L2 line) and writes
// 5 bytes.  Sorted candidates put same-bucket lanes side by side, so
// repeated lines hit in L1/L2.  The line is read as eight 16-byte vector
// loads, the widest a thread issues, so a lane costs eight load
// instructions; a warp-cooperative probe (one lane per slot) is later work.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFULL;
constexpr int kSlots = 16;

__global__ void bucket_probe_kernel(const unsigned long long* __restrict__ tfp,
                                    const unsigned long long* __restrict__ sfp,
                                    const long long* __restrict__ bucket,
                                    bool* __restrict__ present,
                                    int* __restrict__ base, long long m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned long long fp = sfp[i];
  if (fp == kEmpty) {
    present[i] = false;
    base[i] = 0;
    return;
  }
  const ulonglong2* line =
      reinterpret_cast<const ulonglong2*>(tfp + bucket[i] * kSlots);
  bool hit = false;
  int used = 0;
#pragma unroll
  for (int k = 0; k < kSlots / 2; ++k) {
    const ulonglong2 v = line[k];
    hit |= (v.x == fp) | (v.y == fp);
    used += (v.x != kEmpty) + (v.y != kEmpty);
  }
  present[i] = hit;
  base[i] = used;
}

}  // namespace

extern "C" int srt_bucket_probe(const void* tfp, const void* sfp,
                                const void* bucket, void* present, void* base,
                                int64_t m, void* stream) {
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  bucket_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)tfp, (const unsigned long long*)sfp,
      (const long long*)bucket, (bool*)present, (int*)base, (long long)m);
  return (int)cudaGetLastError();
}

// The state fingerprint's splitmix64 fold, shared by row_hash.cu and
// cand_prep.cu so its constants exist once.  Bit-identical to the host's
// `fingerprint.hash_words` and to `row_hash` of the JAX package
// (stateright_tpu/ops/hashing.py:105): fold each of the row's W words into
// the digest from a fixed seed, fold the length W, then remap 0 and EMPTY
// to GAMMA.
#pragma once

#include <cuda_runtime.h>

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

// The exact inverse of mix64 (the host's `fingerprint.unmix64`): undo each
// xorshift and multiply by the multipliers' inverses mod 2^64, in reverse.
__device__ __forceinline__ unsigned long long unmix64(unsigned long long h) {
  h ^= (h >> 31) ^ (h >> 62);
  h *= 0x319642B2D24D8EC3ULL;  // kM2^-1 mod 2^64
  h ^= (h >> 27) ^ (h >> 54);
  h *= 0x96DE1B173F119089ULL;  // kM1^-1 mod 2^64
  h ^= (h >> 30) ^ (h >> 60);
  return h;
}

__device__ __forceinline__ unsigned long long row_fingerprint(
    const unsigned long long* __restrict__ row, int width) {
  unsigned long long h = kSeed;
  for (int w = 0; w < width; ++w) h = mix64((h ^ row[w]) + kGamma);
  h = mix64((h ^ (unsigned long long)width) + kGamma);
  return (h == 0ULL || h == kEmpty) ? kGamma : h;
}

}  // namespace

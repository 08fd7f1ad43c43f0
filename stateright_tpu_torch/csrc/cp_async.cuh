// Global-to-shared copies that bypass the registers (`cp.async`), shared
// by row_hash.cu and cand_prep.cu, which both stage the rows they hash in
// shared memory so that a warp's loads are coalesced whatever the row
// width.  A thread issues all of its copies back to back, then commits
// and waits once (`cp_async_wait_all`) before the block's barrier.
#pragma once

#include <cuda_runtime.h>

namespace {

// One 8-byte copy from global to shared memory.
__device__ __forceinline__ void cp_async8(unsigned long long* smem,
                                          const unsigned long long* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

// Commit this thread's copies and wait for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace

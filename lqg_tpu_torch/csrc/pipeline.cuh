// Shared-memory pipelines of one block on Hopper: mbarriers, 4-byte
// cp.async copies that complete on an mbarrier, named barriers and the
// warp's transpose reduction.
//
// mbarrier waits use the parity of the completion awaited: the u-th
// completion of a barrier (u = 0, 1, ...) is awaited with parity u & 1.
#pragma once

#include <cstdint>

namespace lqg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the inits visible to the block; a __syncthreads() follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival, with release semantics for this thread's earlier accesses.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Blocks until the completion of parity `parity` has happened (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Asynchronous copy of one float from device memory into shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// One arrival on `bar`, made when all of this thread's earlier cp.async
// copies have landed (counted against the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Barrier `id` (1..15) over `count` threads, a multiple of 32.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// One level of the transpose reduction: a lane keeps the half of its values
// whose index has bit OFF equal to the lane's, and adds its partner's
// (lane ^ OFF) copy of that half.  OFF is a template constant so that every
// index is one and the values stay in registers.
template <int OFF>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    const float send = upper ? v[k] : v[k + OFF];
    const float keep = upper ? v[k + OFF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Transpose reduction of a warp: each lane holds 32 values; on return lane
// l's v[0] is the sum over the warp's lanes of value l.  Recursive halving
// at offsets 16, 8, 4, 2, 1, 31 shuffles in all, so the sum of value l is
// the xor tree ((x_0 + x_16) + (x_8 + x_24)) + ... in a fixed order.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

}  // namespace lqg

// Bulk copies from device memory into shared memory by the Tensor Memory
// Accelerator (cp.async.bulk, sm_90), completing on an mbarrier.
//
// A bulk copy moves a contiguous run of bytes: its source, its destination
// and its size must be multiples of 16 bytes. The copy adds its bytes to
// the transaction count of an mbarrier in the destination CTA's shared
// memory; a thread that announced the bytes (mbar_expect) arrives, and the
// barrier's phase completes once every byte has landed. A thread that then
// waits on the phase (mbar_wait) sees the copied data. K4's barriers are
// used for one phase (parity 0): initialised, announced, waited on once.
// K3's bulk form reuses its barriers phase after phase, a ring: a stage's
// full barrier completes once per round (announced and filled by copies),
// its empty barrier once per round (mbar_arrive of every consumer warp),
// and round r waits on parity r & 1.
#pragma once
#include <cstdint>

#include "cpasync.cuh"

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

// After mbar_init, before any other thread or copy uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier, announcing `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

// Arrive on the barrier (no bytes announced).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile(
        "{\n .reg .b64 st;\n"
        " mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
            smem_u32(bar))
        : "memory");
}

// Wait until the barrier's phase `parity` has completed. A phase that
// never completes (a copy that never lands) traps after ~2^34 cycles, a
// launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned a = smem_u32(bar);
    const long long t0 = clock64();
    unsigned done = 0;
    while (!done) {
        if (clock64() - t0 > (1ll << 34)) __trap();
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    }
}

// bytes (a multiple of 16) from src to dst (both 16-byte aligned), counted
// on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

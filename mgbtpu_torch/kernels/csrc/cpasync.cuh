// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), in 16-byte pieces where the data allows.
//
// A 16-byte cp.async needs both addresses 16-byte aligned. A run of doubles
// that starts at an odd double (ld = f + 1 front rows, a block's share of
// the panels) is therefore staged to a shared address of the same parity:
// the caller shifts the destination by odd8(src), one double, and the run
// goes out as a leading 8-byte copy, 16-byte pairs and a trailing 8-byte
// copy. cp_async_wait_all() makes the calling thread's copies complete; a
// block barrier after it publishes them to the other threads.
// cp_async_commit() and cp_async_wait_group<N>() run a pipeline of stages
// instead (K3's spread form): wait for the oldest stage while N newer ones
// stay in flight.
#pragma once
#include <cstdint>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// A pipeline of stages: commit the calling thread's copies issued so far as
// one group; wait until at most N of its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1 when p sits at an odd double (8 bytes past a 16-byte boundary)
__device__ __forceinline__ int odd8(const void* p) {
    return (int)(((uintptr_t)p >> 3) & 1);
}

// Pieces a run of n doubles starting at parity h splits into.
__device__ __forceinline__ int cp_pieces(int n, int h) {
    return n > 0 ? (n + h + 1) >> 1 : 0;
}

// Piece q of the run src[0, n) -> dst[0, n), h = odd8(src) = odd8(dst):
// the aligned pair that starts at element 2q - h, or its one element inside
// the run.
__device__ __forceinline__ void cp_piece(double* dst, const double* src,
                                         int n, int h, int q) {
    const int c = 2 * q - h;
    if (c < 0) cp_async8(dst, src);                       // element 0 alone
    else if (c + 1 < n) cp_async16(dst + c, src + c);
    else cp_async8(dst + c, src + c);                     // element n - 1
}

// The whole run by threads t, t + nt, ... (dst shifted as the note says).
__device__ __forceinline__ void cp_run(double* dst, const double* src, int n,
                                       int t, int nt) {
    const int h = odd8(src);
    for (int q = t, np = cp_pieces(n, h); q < np; q += nt)
        cp_piece(dst, src, n, h, q);
}

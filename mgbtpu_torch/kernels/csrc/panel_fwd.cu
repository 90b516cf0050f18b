// panel_fwd: forward panel product with the gather fused in, f64.
//
//   out[e*p + q, k] = dz0[e*p + q, k] + sum_c panels[k, e, q, c] * s[cols[e, c]]
//
// Replaces the Pallas kernel fwd_dd (mgbtpu/ops/pallas_dd.py:186), which
// computed the same product in double-float from a gathered (C, N) slab
// that XLA built beforehand; here the s[cols] gather happens in the kernel.
//
// A block takes a group of E consecutive elements (E*p*nD ~ 128 threads).
// It stages, in shared memory, each k's panel slab of the group (E*p*C
// doubles, contiguous in the (nD, N, p, C) layout) with 16-byte cp.async
// copies, and the gathered s[cols[e, :]] once per element (not once per
// node). Then one thread per (element, node, k) output sums its C products
// from shared memory, and the (N*p, nD) output is written with k fastest
// across threads, so the loads and the stores are coalesced. Each sum runs
// in the order of the kernel this one replaced (acc = 0.0, then
// acc + panel * s for c = 0 .. C-1, each product and sum rounded apart
// under --fmad=false, then dz0 + acc), so the outputs keep its bits.
// Bound on an H100: bytes (panels are read once, 8 bytes per 2 flops); at
// fem2d_P2 L=5 the ~2 MB it moves sit in L2 and the call is launch-bound.
#include <cstdint>
#include <cuda_runtime.h>

#include "cpasync.cuh"

#define MAX_ND 12
#define THREADS_TARGET 128
#define SMEM_DEFAULT (48 * 1024)
#define SMEM_MAX (227 * 1024)

// doubles a k's slab takes in shared memory: room for the parity shift,
// rounded up to an even count so that every slab starts 16-byte aligned
__host__ __device__ __forceinline__ int slab_stride(int E, int p, int C) {
    return (E * p * C + 2) & ~1;
}

__global__ void __launch_bounds__(1024)
panel_fwd_kernel(const double* __restrict__ panels,
                 const int64_t* __restrict__ cols,
                 const double* __restrict__ s,
                 const double* __restrict__ dz0, double* __restrict__ out,
                 int nD, int N, int p, int C, int E) {
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, nt = blockDim.x;
    const int e0 = blockIdx.x * E;
    const int ne = min(E, N - e0);
    const int pc = p * C;
    const int ks = slab_stride(E, p, C);
    const size_t kstride = (size_t)N * pc;
    const double* src0 = panels + (size_t)e0 * pc;
    for (int k = 0; k < nD; ++k) {
        const double* src = src0 + k * kstride;
        cp_run(sh + k * ks + odd8(src), src, ne * pc, t, nt);
    }
    double* sv = sh + nD * ks;                   // s[cols[e, :]], E x C
    const int64_t* ce = cols + (size_t)e0 * C;
    for (int i = t; i < ne * C; i += nt) sv[i] = s[ce[i]];

    const int r = t / nD, k = t - r * nD;        // row e*p + q of the group
    const bool live = r < ne * p;
    const size_t o = (size_t)e0 * p * nD + t;
    const double d = (live && dz0) ? dz0[o] : 0.0;
    cp_async_wait_all();
    __syncthreads();
    if (!live) return;
    const double* src = src0 + k * kstride;
    const double* pk = sh + k * ks + odd8(src) + r * C;
    const double* se = sv + (r / p) * C;
    double acc = 0.0;
#pragma unroll 4
    for (int c = 0; c < C; ++c) acc = acc + pk[c] * se[c];
    out[o] = dz0 ? d + acc : acc;
}

extern "C" int panel_fwd_launch(const void* panels, const void* cols,
                                const void* s, const void* dz0, void* out,
                                int nD, int N, int p, int C, void* stream) {
    if (N <= 0 || nD <= 0 || p <= 0) return (int)cudaGetLastError();
    if (nD > MAX_ND || p * nD > 1024 || C <= 0)
        return (int)cudaErrorInvalidValue;
    const int per = p * nD;                      // threads per element
    int E = per >= THREADS_TARGET ? 1 : THREADS_TARGET / per;
    if (E > N) E = N;
    auto smem = [&](int e) {
        return sizeof(double) * ((size_t)nD * slab_stride(e, p, C)
                                 + (size_t)e * C);
    };
    while (E > 1 && smem(E) > SMEM_DEFAULT) --E;
    const size_t bytes = smem(E);
    if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (bytes > SMEM_DEFAULT) {
        const cudaError_t err = cudaFuncSetAttribute(
            panel_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    panel_fwd_kernel<<<(N + E - 1) / E, E * per, bytes,
                       (cudaStream_t)stream>>>(
        (const double*)panels, (const int64_t*)cols, (const double*)s,
        (const double*)dz0, (double*)out, nD, N, p, C, E);
    return (int)cudaGetLastError();
}

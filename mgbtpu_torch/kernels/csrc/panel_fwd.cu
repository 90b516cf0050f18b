// panel_fwd: forward panel product with the gather fused in, f64.
//
//   out[e*p + q, k] = dz0[e*p + q, k] + sum_c panels[k, e, q, c] * s[cols[e, c]]
//
// Replaces the Pallas kernel fwd_dd (mgbtpu/ops/pallas_dd.py:186), which
// computed the same product in double-float from a gathered (C, N) slab
// that XLA built beforehand; here the s[cols] gather happens in the kernel.
// One thread per (element, node) pair carries the nD sums in registers.
// Bound on an H100: bytes (panels are read once, 8 bytes per 2 flops).
#include <cstdint>
#include <cuda_runtime.h>

#define MAX_ND 8

__global__ void panel_fwd_kernel(const double* __restrict__ panels,
                                 const int64_t* __restrict__ cols,
                                 const double* __restrict__ s,
                                 const double* __restrict__ dz0,
                                 double* __restrict__ out,
                                 int nD, int N, int p, int C) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= N * p) return;
    const int e = t / p;
    const int q = t - e * p;
    double acc[MAX_ND];
#pragma unroll
    for (int k = 0; k < MAX_ND; ++k) acc[k] = 0.0;
    const size_t kstride = (size_t)N * p * C;
    const double* pq = panels + ((size_t)e * p + q) * C;
    for (int c = 0; c < C; ++c) {
        const double sv = s[cols[(size_t)e * C + c]];
#pragma unroll
        for (int k = 0; k < MAX_ND; ++k)
            if (k < nD) acc[k] += pq[k * kstride + c] * sv;
    }
    double* o = out + (size_t)t * nD;
    for (int k = 0; k < nD; ++k)
        o[k] = dz0 ? dz0[(size_t)t * nD + k] + acc[k] : acc[k];
}

extern "C" int panel_fwd_launch(const void* panels, const void* cols,
                                const void* s, const void* dz0, void* out,
                                int nD, int N, int p, int C, void* stream) {
    const int n = N * p;
    if (n > 0) {
        const int block = 128;
        panel_fwd_kernel<<<(n + block - 1) / block, block, 0,
                           (cudaStream_t)stream>>>(
            (const double*)panels, (const int64_t*)cols, (const double*)s,
            (const double*)dz0, (double*)out, nD, N, p, C);
    }
    return (int)cudaGetLastError();
}

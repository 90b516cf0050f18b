// Deterministic adjoint panel product: the scatter into n_J as a gather.
//
//   out[j] = sum over the (element e, slot c) pairs of column j, in
//            increasing flat order f = e*C + c, of
//            sum_k sum_q panels[k, e, q, c] * Y[e*p + q, k]
//
// inv[j, :] lists column j's flat slots, padded with N*C. Each output is
// written by one thread in a fixed order: no atomics, no zero-fill, and the
// same bits on every run (a cross-element atomicAdd scatter changes its
// summation order from run to run).
#pragma once
#include <cstdint>

__global__ void adjoint_gather_kernel(const double* __restrict__ panels,
                                      const int64_t* __restrict__ inv,
                                      const double* __restrict__ Y,
                                      double* __restrict__ out,
                                      int nD, int N, int p, int C, int n_J,
                                      int K) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_J) return;
    const int64_t pad = (int64_t)N * C;
    const size_t kstride = (size_t)N * p * C;
    const int64_t* ij = inv + (size_t)j * K;
    double acc = 0.0;
    for (int t = 0; t < K; ++t) {
        const int64_t f = ij[t];
        if (f == pad) break;  // padding is trailing
        const int64_t e = f / C;
        const int64_t c = f - e * C;
        const double* pe = panels + (size_t)e * p * C + c;
        const double* ye = Y + (size_t)e * p * nD;
        double s = 0.0;
        for (int k = 0; k < nD; ++k)
            for (int q = 0; q < p; ++q)
                s += pe[k * kstride + (size_t)q * C] * ye[q * nD + k];
        acc += s;
    }
    out[j] = acc;
}

static inline void adjoint_gather(const double* panels, const int64_t* inv,
                                  const double* Y, double* out, int nD, int N,
                                  int p, int C, int n_J, int K,
                                  cudaStream_t stream) {
    if (n_J > 0) {
        const int block = 128;
        adjoint_gather_kernel<<<(n_J + block - 1) / block, block, 0, stream>>>(
            panels, inv, Y, out, nD, N, p, C, n_J, K);
    }
}

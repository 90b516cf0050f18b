// front_factor: batched partial Cholesky of the nested-dissection fronts, f64.
//
// Each front F (f x f, f = a + b, leading dimension ld >= f) holds the
// eliminated block A (a x a), the coupling B (b x a) and the boundary block
// C (b x b):
//   A_s = (A + A^T) / 2,  A_s = Lf Lf^T,  U = B Lf^-T,  S = C - U U^T.
// A front whose A_s is not positive definite (a pivot that is not > 0,
// NaN included) comes back all NaN in Lf, U and S, the reference's
// cholesky semantics.
//
// Replaces the Pallas kernel panel_chol_inv (mgbtpu/ops/pallas_dd.py:446,
// kernel _chol_inv_kernel :386), which factored and inverted the dd front
// panels one (w, w) tile per grid step; the x64 reference runs the same
// fronts through cholesky + triangular_solve + a batched product
// (mgbtpu/ops/ndchol.py:518-522). Hopper has native f64, so the whole
// partial factorization of a front is one right-looking elimination:
// one block per front, column j of [Lf; U] scaled by its pivot and cached
// in shared memory, then the trailing update of the lower part of A, of U
// and of all of S by the block's threads, one __syncthreads per phase.
// The factor is written in place in the outputs (no scratch).
// Bound on an H100: at the nested-dissection front sizes (f <= ~300) the
// operations, a^3/3 + b a^2 + 2 b^2 a per front, are a few MFLOP; the
// kernel is latency-bound on its a-step serial chain.
#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256

__global__ void front_factor_kernel(const double* __restrict__ F,
                                    double* __restrict__ Lf,
                                    double* __restrict__ U,
                                    double* __restrict__ S, int a, int b,
                                    int ld) {
    extern __shared__ double col[];  // column j of [Lf; U] below the pivot
    __shared__ double piv;
    __shared__ int bad;
    const int n = blockIdx.x;
    const int tid = threadIdx.x;
    const double* Fn = F + (size_t)n * ld * ld;
    double* Ln = Lf + (size_t)n * a * a;
    double* Un = U + (size_t)n * b * a;
    double* Sn = S + (size_t)n * b * b;

    for (int t = tid; t < a * a; t += THREADS) {
        const int i = t / a, k = t - i * a;
        Ln[t] = i >= k ? (Fn[i * ld + k] + Fn[k * ld + i]) / 2 : 0.0;
    }
    for (int t = tid; t < b * a; t += THREADS) {
        const int i = t / a, k = t - i * a;
        Un[t] = Fn[(size_t)(a + i) * ld + k];
    }
    for (int t = tid; t < b * b; t += THREADS) {
        const int i = t / b, k = t - i * b;
        Sn[t] = Fn[(size_t)(a + i) * ld + a + k];
    }
    if (tid == 0) bad = 0;
    __syncthreads();

    for (int j = 0; j < a; ++j) {
        if (tid == 0) {
            const double d = Ln[j * a + j];
            if (!(d > 0.0)) bad = 1;
            piv = sqrt(d);
            Ln[j * a + j] = piv;
        }
        __syncthreads();
        if (bad) break;  // block-uniform
        const int w = a - 1 - j;  // A rows below the pivot
        for (int t = tid; t < w + b; t += THREADS) {
            double* x = t < w ? &Ln[(j + 1 + t) * a + j] : &Un[(t - w) * a + j];
            const double v = *x / piv;
            *x = v;
            col[t] = v;
        }
        __syncthreads();
        // trailing update: A lower (w x w, k <= i), U (b x w), S (b x b)
        const int nA = w * w, nU = b * w, nS = b * b;
        for (int t = tid; t < nA + nU + nS; t += THREADS) {
            if (t < nA) {
                const int i = t / w, k = t - i * w;
                if (k <= i) Ln[(j + 1 + i) * a + j + 1 + k] -= col[i] * col[k];
            } else if (t < nA + nU) {
                const int u = t - nA, i = u / w, k = u - i * w;
                Un[i * a + j + 1 + k] -= col[w + i] * col[k];
            } else {
                const int u = t - nA - nU, i = u / b, k = u - i * b;
                Sn[i * b + k] -= col[w + i] * col[w + k];
            }
        }
        __syncthreads();
    }
    if (bad) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        for (int t = tid; t < a * a; t += THREADS) Ln[t] = nan;
        for (int t = tid; t < b * a; t += THREADS) Un[t] = nan;
        for (int t = tid; t < b * b; t += THREADS) Sn[t] = nan;
    }
}

extern "C" int front_factor_launch(const void* F, void* Lf, void* U, void* S,
                                   int nk, int a, int b, int ld,
                                   void* stream) {
    const size_t smem = (size_t)(a + b) * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            front_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (nk > 0) {
        front_factor_kernel<<<nk, THREADS, smem, (cudaStream_t)stream>>>(
            (const double*)F, (double*)Lf, (double*)U, (double*)S, a, b, ld);
    }
    return (int)cudaGetLastError();
}

// front_solve: batched triangular solves with the nested-dissection front
// factors, f64.
//
//   trans == 0:  x = Lf^-1 r      (forward sweep of the solve)
//   trans == 1:  x = Lf^-T r      (backward sweep)
// for each front n: Lf[n] (a x a, lower, row-major), r[n], x[n] (a).
//
// Replaces the other half of the Pallas kernel panel_chol_inv
// (mgbtpu/ops/pallas_dd.py:446), whose triangular inverse L^-1 turned the
// dd solves into products; the x64 reference solves with the factor itself
// (lax.linalg.triangular_solve, mgbtpu/ops/ndchol.py:540-556), and so does
// this kernel. One block per front, the right-hand side in shared memory,
// column-oriented substitution: x_j from the finished entry j, then every
// thread updates its later entries; one __syncthreads per column.
// Bound on an H100: bytes (the factor is read once, 2 flops per 8 bytes);
// at the nested-dissection front sizes the a-step chain of
// synchronisations dominates.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void front_solve_kernel(const double* __restrict__ Lf,
                                   const double* __restrict__ r,
                                   double* __restrict__ x, int a, int trans) {
    extern __shared__ double rs[];
    const int n = blockIdx.x;
    const int tid = threadIdx.x, nt = blockDim.x;
    const double* Ln = Lf + (size_t)n * a * a;
    double* xn = x + (size_t)n * a;
    for (int t = tid; t < a; t += nt) rs[t] = r[(size_t)n * a + t];
    __syncthreads();
    for (int s = 0; s < a; ++s) {
        const int j = trans ? a - 1 - s : s;
        const double xj = rs[j] / Ln[j * a + j];
        if (tid == 0) xn[j] = xj;
        if (trans) {
            for (int i = tid; i < j; i += nt) rs[i] -= Ln[j * a + i] * xj;
        } else {
            for (int i = j + 1 + tid; i < a; i += nt) rs[i] -= Ln[i * a + j] * xj;
        }
        __syncthreads();
    }
}

extern "C" int front_solve_launch(const void* Lf, const void* r, void* x,
                                  int nk, int a, int trans, void* stream) {
    const size_t smem = (size_t)a * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            front_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int threads = ((a + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
    if (nk > 0) {
        front_solve_kernel<<<nk, threads, smem, (cudaStream_t)stream>>>(
            (const double*)Lf, (const double*)r, (double*)x, a, trans);
    }
    return (int)cudaGetLastError();
}

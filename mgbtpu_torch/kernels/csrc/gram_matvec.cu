// gram_matvec: matrix-free Gram-form Hessian apply, fused, f64.
//
//   H v = P^T L L^T P v   with per-node lower factors L (bw*F2 = L L^T):
//   Pv[q, j]  = sum_c panels[j, e, q, c] * v[cols[e, c]]      (gather + forward)
//   B[q, i]   = sum_j L[e*p+q, j, i] * Pv[q, j]                (L^T)
//   W[q, j]   = sum_i L[e*p+q, j, i] * B[q, i]                 (L)
//   out[col]  = sum over the column's slots of sum_{q,k} panels[k, e, q, c] W[q, k]
//
// Replaces the Pallas kernel ymv_contrib (mgbtpu/ops/pallas_dd.py:142),
// which applied the dd node blocks Y directly; the x64 reference runs the
// Lnode form (mgbtpu/solver/levelops.py:304-313), and so does this kernel.
// Phase 1: one warp per element, gather -> forward -> L^T -> L with the
// intermediates in shared memory; only W (p*nD doubles per element) goes to
// device memory; only the lower triangle of each factor is read. Phase 2:
// K3's two deterministic adjoint phases (adjoint.cuh) on W, which is
// per-element as K3's Y is: coalesced per-slot contributions, then each
// column's fixed-order sum by a thread or a block (no atomics).
// Bound on an H100: bytes (panels and the factors' lower triangles read
// once).
#include <cstdint>
#include <cuda_runtime.h>

#include "adjoint.cuh"

#define WARPS 4
#define MAX_PN 128  // p * nD

__global__ void gram_node_kernel(const double* __restrict__ panels,
                                 const int64_t* __restrict__ cols,
                                 const double* __restrict__ Lnode,
                                 const double* __restrict__ v,
                                 double* __restrict__ W,
                                 int nD, int N, int p, int C) {
    __shared__ double sPv[WARPS][MAX_PN];
    __shared__ double sB[WARPS][MAX_PN];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    pdl_trigger();  // the adjoint phases may be scheduled now
    const int e = blockIdx.x * WARPS + warp;
    if (e >= N) return;  // whole warp leaves together
    const int pn = p * nD;
    const size_t kstride = (size_t)N * p * C;
    const double* pe = panels + (size_t)e * p * C;
    const int64_t* ce = cols + (size_t)e * C;
    double* Pv = sPv[warp];
    double* Bv = sB[warp];

    for (int r = lane; r < pn; r += 32) {
        const int q = r / nD, j = r - q * nD;
        const double* pj = pe + j * kstride + (size_t)q * C;
        double acc = 0.0;
        for (int c = 0; c < C; ++c) acc += pj[c] * v[ce[c]];
        Pv[r] = acc;
    }
    __syncwarp();
    for (int r = lane; r < pn; r += 32) {
        const int q = r / nD, i = r - q * nD;
        const double* Lq = Lnode + ((size_t)e * p + q) * nD * nD;
        double acc = 0.0;
        for (int j = i; j < nD; ++j) acc += Lq[j * nD + i] * Pv[q * nD + j];
        Bv[r] = acc;
    }
    __syncwarp();
    double* We = W + (size_t)e * pn;
    for (int r = lane; r < pn; r += 32) {
        const int q = r / nD, j = r - q * nD;
        const double* Lq = Lnode + ((size_t)e * p + q) * nD * nD;
        double acc = 0.0;
        for (int i = 0; i <= j; ++i) acc += Lq[j * nD + i] * Bv[q * nD + i];
        We[r] = acc;
    }
}

extern "C" int gram_matvec_launch(const void* panels, const void* cols,
                                  const void* inv, const void* Lnode,
                                  const void* v, void* W, void* contrib,
                                  void* out, int nD, int N, int p, int C,
                                  int n_J, int K, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (N > 0) {
        gram_node_kernel<<<(N + WARPS - 1) / WARPS, 32 * WARPS, 0, s>>>(
            (const double*)panels, (const int64_t*)cols, (const double*)Lnode,
            (const double*)v, (double*)W, nD, N, p, C);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = adjoint_launch((const double*)panels, (const int64_t*)inv,
                       (const double*)W, (double*)contrib, (double*)out, nD,
                       N, p, C, n_J, K, s);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

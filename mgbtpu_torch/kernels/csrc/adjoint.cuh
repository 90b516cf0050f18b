// Deterministic adjoint panel product, in two coalesced phases.
//
//   A:  contrib[e*C + c] = sum_k sum_q panels[k, e, q, c] * Y[e*p + q, k]
//   B:  out[j]           = sum of contrib[f] over inv[j, :], increasing f
//
// Phase A runs one thread per slot (e, c), c fastest, so neighbouring threads
// read neighbouring panel entries; a block stages its elements' p*nD values
// of Y in shared memory and each thread sums in the fixed (k, q) order,
// its loads unrolled so that many are in flight.
// Phase B sums each column's slots from the inverse incidence inv (n_J, K),
// padded with N*C at the end, in one of two forms adjoint_launch picks from
// K:
//   K <= ADJ_THREAD_K  one thread per column, slots in increasing order (the
//                      fine levels);
//   larger K           one block of ADJ_COL_THREADS per column (the coarse
//                      levels, hundreds to thousands of slots): thread r sums
//                      slots r, r + ADJ_COL_THREADS, ... in order, then a
//                      fixed shuffle tree per warp and one over the warps'
//                      partials.
// No atomics: every run gives the same bits (an atomicAdd scatter changes
// its summation order from run to run). The thread form adds in the order
// of the one-pass gather it replaces, so its bits are that kernel's. Both
// phases launch as programmatic dependents (pdl.cuh): phase B is scheduled
// while phase A runs and waits for it on the device.
// K3 (panel_adj.cu) runs both phases through adjoint_launch; K4
// (gram_matvec.cu) computes its per-slot contributions in its own fused
// kernel, in phase A's order, and runs phase B alone (adjoint_sum_launch).
#pragma once
#include <cstdint>

#include "pdl.cuh"

#define ADJ_THREADS 128        // phase A threads per block
#define ADJ_STAGE 4096         // phase A: most doubles of Y staged per block
#define ADJ_THREAD_K 32        // phase B: most slots a thread sums alone
#define ADJ_COL_THREADS 256    // phase B: threads per column in block form

// P > 0: p == P at compile time (7, the P2 element), so a thread's loads
// of a row k, and of the next rows, go out together
template <int P>
__global__ void adjoint_contrib_kernel(const double* __restrict__ panels,
                                       const double* __restrict__ Y,
                                       double* __restrict__ contrib, int nD,
                                       int N, int p, int C, int EB) {
    extern __shared__ double sY[];  // EB elements x p*nD
    pdl_wait();
    pdl_trigger();
    if (P > 0) p = P;
    const int pn = p * nD;
    const int e0 = blockIdx.x * EB;
    const int ne = min(EB, N - e0);
    const double* Yb = Y + (size_t)e0 * pn;
    for (int t = threadIdx.x; t < ne * pn; t += blockDim.x) sY[t] = Yb[t];
    __syncthreads();
    const size_t kstride = (size_t)N * p * C;
    for (int t = threadIdx.x; t < ne * C; t += blockDim.x) {
        const int el = t / C, c = t - el * C;
        const double* pe = panels + (size_t)(e0 + el) * p * C + c;
        const double* ye = sY + el * pn;
        double s = 0.0;
#pragma unroll 4
        for (int k = 0; k < nD; ++k) {
#pragma unroll
            for (int q = 0; q < (P > 0 ? P : p); ++q)
                s += pe[k * kstride + (size_t)q * C] * ye[q * nD + k];
        }
        contrib[(size_t)(e0 + el) * C + c] = s;
    }
}

__global__ void adjoint_sum_thread_kernel(const double* __restrict__ contrib,
                                          const int64_t* __restrict__ inv,
                                          double* __restrict__ out, int n_J,
                                          int K, int64_t pad) {
    pdl_wait();
    pdl_trigger();
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_J) return;
    const int64_t* ij = inv + (size_t)j * K;
    double acc = 0.0;
#pragma unroll 4  // independent loads in flight; the adds stay in order
    for (int t = 0; t < K; ++t) {
        const int64_t f = ij[t];
        if (f != pad) acc += contrib[f];  // padding is trailing
    }
    out[j] = acc;
}

__device__ __forceinline__ double adj_warp_tree(double v) {
    // lane 0 ends with a fixed-shape tree sum of the warp's 32 values
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__global__ void adjoint_sum_block_kernel(const double* __restrict__ contrib,
                                         const int64_t* __restrict__ inv,
                                         double* __restrict__ out, int K,
                                         int64_t pad) {
    constexpr int WARPS = ADJ_COL_THREADS / 32;
    __shared__ double part[WARPS];
    pdl_wait();
    pdl_trigger();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x;
    const int64_t* ij = inv + (size_t)j * K;
    double acc = 0.0;
#pragma unroll 4
    for (int t = threadIdx.x; t < K; t += ADJ_COL_THREADS) {
        const int64_t f = ij[t];
        if (f != pad) acc += contrib[f];  // padding is trailing
    }
    acc = adj_warp_tree(acc);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        double v = lane < WARPS ? part[lane] : 0.0;
        v = adj_warp_tree(v);
        if (lane == 0) out[j] = v;
    }
}

// Phase B alone: out (n_J,) from the per-slot contributions contrib
// (N*C,), in the form K asks for.
static inline cudaError_t adjoint_sum_launch(const int64_t* inv,
                                             const double* contrib,
                                             double* out, int N, int C,
                                             int n_J, int K,
                                             cudaStream_t stream) {
    if (n_J <= 0) return cudaSuccess;
    const int64_t pad = (int64_t)N * C;
    if (K <= ADJ_THREAD_K)
        return launch_pdl(adjoint_sum_thread_kernel, dim3((n_J + 127) / 128),
                          dim3(128), 0, stream, contrib, inv, out, n_J, K,
                          pad);
    return launch_pdl(adjoint_sum_block_kernel, dim3(n_J),
                      dim3(ADJ_COL_THREADS), 0, stream, contrib, inv, out, K,
                      pad);
}

// Both phases on one stream; contrib is (N*C,) scratch. Returns the first
// launch error, or cudaErrorInvalidValue when an element's p*nD values of Y
// do not fit phase A's stage.
static inline cudaError_t adjoint_launch(const double* panels,
                                         const int64_t* inv, const double* Y,
                                         double* contrib, double* out, int nD,
                                         int N, int p, int C, int n_J, int K,
                                         cudaStream_t stream) {
    const int pn = p * nD;
    if (pn > ADJ_STAGE) return cudaErrorInvalidValue;
    if (N > 0 && C > 0) {
        int EB = ADJ_THREADS / C;
        if (EB > ADJ_STAGE / pn) EB = ADJ_STAGE / pn;
        if (EB < 1) EB = 1;
        cudaError_t e = launch_pdl(
            p == 7 ? adjoint_contrib_kernel<7> : adjoint_contrib_kernel<0>,
            dim3((N + EB - 1) / EB),
            dim3(ADJ_THREADS), (size_t)EB * pn * sizeof(double), stream,
            panels, Y, contrib, nD, N, p, C, EB);
        if (e != cudaSuccess) return e;
    }
    return adjoint_sum_launch(inv, contrib, out, N, C, n_J, K, stream);
}

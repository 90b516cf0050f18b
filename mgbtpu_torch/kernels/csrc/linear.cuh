// Closed forms of the linear block {A y[idx] + b > 0}, per node, f64.
//
// With F = A y[idx] + b (nc constraints over ni inputs), and F + slack in
// the cobarrier form:
//   F0 = -sum_i Log(F_i)
//   g_i = -sum_k A[k][i] / F_k               (slack: -sum_k 1 / F_k)
//   H_ij = sum_k A[k][i] A[k][j] iF2_k       (cross_i = sum_k A[k][i] iF2_k,
//                                             corner = sum_k iF2_k)
// with iF2_k = 1 / (F_k F_k) for the barrier and (1 / F_k)^2 for the
// cobarrier, as mgbtpu/convex/linear.py (F0/F1/F2 :84-100, C0/C1/C2
// :102-137) writes them; every sum is a left fold in the reference's order.
// Used by node_barrier.cu (K6).
//
// Each helper is a template on the block's shape NC x NI. A fixed shape
// unrolls every loop to it; NC = NI = 0 is the runtime-width form, whose
// loops unroll to the limits LN_MAXC x LN_MAXI with a guard on the runtime
// nc and ni passed in. Either way every small array is indexed only by
// unrolled loop counters, so it stays in registers, and the sums run in the
// same order. The lnw_ helpers at the end are the wide form (K6's wide and
// table kernels, any nc and ni): MIRRORS of ln_affine, ln_value, ln_grad and
// ln_hess, the same sums in the same order over one vector held in shared
// memory, overwritten in place (F, then 1 / F or iF2), each entry of F, g
// or H one call, so that a node's group of threads shares the entries; a
// change to one of a pair must be made to the other in the same order
// (tests/test_torch_kernels_cuda.py holds both to the plain version's
// bits).
#pragma once
#include <math.h>

#include "power_cone.cuh"  // log_barrier

#define LN_MAXC 4
#define LN_MAXI 5

template <int NC>
struct LnRows {
    static constexpr int M = NC > 0 ? NC : LN_MAXC;
};
template <int NI>
struct LnCols {
    static constexpr int M = NI > 0 ? NI : LN_MAXI;
};

// Ar = A (nc x ni, row-major), F = A y[idx] + b.
template <int NC, int NI>
__device__ __forceinline__ void ln_affine(const double* A, const double* b,
                                          const double* y, const int* idx,
                                          int nc, int ni,
                                          double Ar[LN_MAXC][LN_MAXI],
                                          double* F) {
    constexpr int MC = LnRows<NC>::M, MI = LnCols<NI>::M;
#pragma unroll
    for (int i = 0; i < MC; ++i)
#pragma unroll
        for (int j = 0; j < MI; ++j)
            if (i < nc && j < ni) Ar[i][j] = A[i * ni + j];
#pragma unroll
    for (int i = 0; i < MC; ++i) {
        if (i >= nc) continue;
        double acc = Ar[i][0] * y[idx[0]];
#pragma unroll
        for (int j = 1; j < MI; ++j)
            if (j < ni) acc = acc + Ar[i][j] * y[idx[j]];
        F[i] = acc + b[i];
    }
}

template <int NC>
__device__ __forceinline__ double ln_value(const double* F, int nc,
                                           double floor) {
    double acc = log_barrier(F[0], floor);
#pragma unroll
    for (int i = 1; i < LnRows<NC>::M; ++i)
        if (i < nc) acc = acc + log_barrier(F[i], floor);
    return -acc;
}

// g = A' (-1/F) and its slack entry gl = -sum 1/F
template <int NC, int NI>
__device__ __forceinline__ void ln_grad(const double Ar[LN_MAXC][LN_MAXI],
                                        const double* F, int nc, int ni,
                                        double* g, double* gl) {
    constexpr int MC = LnRows<NC>::M, MI = LnCols<NI>::M;
    double invF[LN_MAXC];
#pragma unroll
    for (int k = 0; k < MC; ++k)
        if (k < nc) invF[k] = 1.0 / F[k];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        if (i >= ni) continue;
        double acc = Ar[0][i] * invF[0];
#pragma unroll
        for (int k = 1; k < MC; ++k)
            if (k < nc) acc = acc + Ar[k][i] * invF[k];
        g[i] = -acc;
    }
    double acc = invF[0];
#pragma unroll
    for (int k = 1; k < MC; ++k)
        if (k < nc) acc = acc + invF[k];
    *gl = -acc;
}

// H (ni x ni), and in the cobarrier form (CO) the cross column cr and
// corner cn
template <int NC, int NI, bool CO>
__device__ __forceinline__ void ln_hess(const double Ar[LN_MAXC][LN_MAXI],
                                        const double* F, int nc, int ni,
                                        double H[LN_MAXI][LN_MAXI],
                                        double* cr, double* cn) {
    constexpr int MC = LnRows<NC>::M, MI = LnCols<NI>::M;
    double iF2[LN_MAXC];
#pragma unroll
    for (int k = 0; k < MC; ++k) {
        if (k >= nc) continue;
        if (CO) {
            const double inv = 1.0 / F[k];
            iF2[k] = inv * inv;
        } else {
            iF2[k] = 1.0 / (F[k] * F[k]);
        }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MI; ++j) {
            if (i >= ni || j >= ni) continue;
            double acc = Ar[0][i] * Ar[0][j] * iF2[0];
#pragma unroll
            for (int k = 1; k < MC; ++k)
                if (k < nc) acc = acc + Ar[k][i] * Ar[k][j] * iF2[k];
            H[i][j] = acc;
        }
    if (!CO) return;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        if (i >= ni) continue;
        double acc = Ar[0][i] * iF2[0];
#pragma unroll
        for (int k = 1; k < MC; ++k)
            if (k < nc) acc = acc + Ar[k][i] * iF2[k];
        cr[i] = acc;
    }
    double acc = iF2[0];
#pragma unroll
    for (int k = 1; k < MC; ++k)
        if (k < nc) acc = acc + iF2[k];
    *cn = acc;
}

// ---- wide blocks -----------------------------------------------------------

// entry i of F = A y[idx] + b (A row-major nc x ni), from the gathered
// yg[j] = y[idx[j]]
__device__ __forceinline__ double lnw_affine_i(const double* A,
                                               const double* b,
                                               const double* yg, int ni,
                                               int i) {
    double acc = A[i * ni] * yg[0];
    for (int j = 1; j < ni; ++j) acc = acc + A[i * ni + j] * yg[j];
    return acc + b[i];
}

__device__ __forceinline__ double lnw_value(const double* F, int nc,
                                            double floor) {
    double acc = log_barrier(F[0], floor);
    for (int i = 1; i < nc; ++i) acc = acc + log_barrier(F[i], floor);
    return -acc;
}

// F -> 1 / F in place; returns the slack entry gl = -sum 1/F
__device__ __forceinline__ double lnw_inv(double* F, int nc) {
    for (int k = 0; k < nc; ++k) F[k] = 1.0 / F[k];
    double acc = F[0];
    for (int k = 1; k < nc; ++k) acc = acc + F[k];
    return -acc;
}

// entry i of g = A' (-1/F), from invF
__device__ __forceinline__ double lnw_grad(const double* A,
                                           const double* invF, int nc, int ni,
                                           int i) {
    double acc = A[i] * invF[0];
    for (int k = 1; k < nc; ++k) acc = acc + A[k * ni + i] * invF[k];
    return -acc;
}

// F -> iF2 in place; returns the corner sum iF2
template <bool CO>
__device__ __forceinline__ double lnw_inv2(double* F, int nc) {
    for (int k = 0; k < nc; ++k) {
        if (CO) {
            const double inv = 1.0 / F[k];
            F[k] = inv * inv;
        } else {
            F[k] = 1.0 / (F[k] * F[k]);
        }
    }
    double acc = F[0];
    for (int k = 1; k < nc; ++k) acc = acc + F[k];
    return acc;
}

__device__ __forceinline__ double lnw_hess_ij(const double* A,
                                              const double* iF2, int nc,
                                              int ni, int i, int j) {
    double acc = A[i] * A[j] * iF2[0];
    for (int k = 1; k < nc; ++k)
        acc = acc + A[k * ni + i] * A[k * ni + j] * iF2[k];
    return acc;
}

__device__ __forceinline__ double lnw_cross(const double* A,
                                            const double* iF2, int nc, int ni,
                                            int i) {
    double acc = A[i] * iF2[0];
    for (int k = 1; k < nc; ++k) acc = acc + A[k * ni + i] * iF2[k];
    return acc;
}

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
#pragma once
#include <math.h>

#include "power_cone.cuh"  // log_barrier, PC_MAXNZ

#define LN_MAXC 4
#define LN_MAXI 5

// Ar = A (nc x ni, row-major), F = A y[idx] + b.
__device__ __forceinline__ void ln_affine(const double* A, const double* b,
                                          const double* y, const int* idx,
                                          int nc, int ni,
                                          double Ar[LN_MAXC][LN_MAXI],
                                          double* F) {
    for (int i = 0; i < nc; ++i)
        for (int j = 0; j < ni; ++j) Ar[i][j] = A[i * ni + j];
    for (int i = 0; i < nc; ++i) {
        double acc = Ar[i][0] * y[idx[0]];
        for (int j = 1; j < ni; ++j) acc = acc + Ar[i][j] * y[idx[j]];
        F[i] = acc + b[i];
    }
}

__device__ __forceinline__ double ln_value(const double* F, int nc,
                                           double floor) {
    double acc = log_barrier(F[0], floor);
    for (int i = 1; i < nc; ++i) acc = acc + log_barrier(F[i], floor);
    return -acc;
}

// g = A' (-1/F) and its slack entry gl = -sum 1/F
__device__ __forceinline__ void ln_grad(const double Ar[LN_MAXC][LN_MAXI],
                                        const double* F, int nc, int ni,
                                        double* g, double* gl) {
    double invF[LN_MAXC];
    for (int k = 0; k < nc; ++k) invF[k] = 1.0 / F[k];
    for (int i = 0; i < ni; ++i) {
        double acc = Ar[0][i] * invF[0];
        for (int k = 1; k < nc; ++k) acc = acc + Ar[k][i] * invF[k];
        g[i] = -acc;
    }
    double acc = invF[0];
    for (int k = 1; k < nc; ++k) acc = acc + invF[k];
    *gl = -acc;
}

// H (ni x ni), and in the cobarrier form the cross column cr and corner cn
__device__ __forceinline__ void ln_hess(const double Ar[LN_MAXC][LN_MAXI],
                                        const double* F, int nc, int ni,
                                        bool co, double H[][PC_MAXNZ],
                                        double* cr, double* cn) {
    double iF2[LN_MAXC];
    for (int k = 0; k < nc; ++k) {
        if (co) {
            const double inv = 1.0 / F[k];
            iF2[k] = inv * inv;
        } else {
            iF2[k] = 1.0 / (F[k] * F[k]);
        }
    }
    for (int i = 0; i < ni; ++i)
        for (int j = 0; j < ni; ++j) {
            double acc = Ar[0][i] * Ar[0][j] * iF2[0];
            for (int k = 1; k < nc; ++k) acc = acc + Ar[k][i] * Ar[k][j] * iF2[k];
            H[i][j] = acc;
        }
    if (!co) return;
    for (int i = 0; i < ni; ++i) {
        double acc = Ar[0][i] * iF2[0];
        for (int k = 1; k < nc; ++k) acc = acc + Ar[k][i] * iF2[k];
        cr[i] = acc;
    }
    double acc = iF2[0];
    for (int k = 1; k < nc; ++k) acc = acc + iF2[k];
    *cn = acc;
}

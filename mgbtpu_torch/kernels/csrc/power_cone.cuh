// Closed forms of the Euclidean power cone {s >= |q|^p}, per node, f64.
//
// With z = A y[idx] + b = (q, s) and alpha = 2 / p:
//   F0 = -Log(s^alpha - |q|^2) - mu Log(s)
//   grad and Hess wrt z in the factored u = q/r, v = s^(alpha-1)/r form,
//   then A' grad and A' Hess A.
// Every expression follows mgbtpu/convex/euclidian_power.py (_core_parts,
// _core_grad, _core_hess, _AtHA) operation by operation, and the plain
// versions in mgbtpu_torch/kernels/power_cone.py do the same; the kernels
// are built with --fmad=false, so each product and sum rounds as theirs do.
// Non-finite semantics are the reference's: Log(x) is -inf for x <= floor
// (NaN included), safe_pow gives 0 for s <= 0.
//
// Each helper is a template on the cone's size NZ (and the value ones on
// the alpha specialisation SPEC). K2 (power_cone.cu) and K6
// (node_barrier.cu) instantiate them with both fixed, so every loop unrolls
// and the small arrays stay in registers.
#pragma once
#include <math.h>

#define PC_MAXNZ 5

__device__ __forceinline__ double log_barrier(double x, double floor) {
    return x > floor ? log(x) : -INFINITY;
}

__device__ __forceinline__ double pow_alpha(double s, double alpha, int spec,
                                            double floor) {
    if (spec == 2) return s > 0.0 ? s * s : 0.0;
    if (spec == 1) return s > 0.0 ? s : 0.0;
    return exp(alpha * log_barrier(s, floor));
}

// Ar = A (nz x nz, row-major), z = A y[idx] + b.
template <int NZ>
__device__ __forceinline__ void pc_affine(const double* A, const double* b,
                                          const double* y, const int* idx,
                                          int nz_,
                                          double Ar[PC_MAXNZ][PC_MAXNZ],
                                          double* z) {
    const int nz = NZ > 0 ? NZ : nz_;
#pragma unroll
    for (int i = 0; i < nz; ++i)
#pragma unroll
        for (int j = 0; j < nz; ++j) Ar[i][j] = A[i * nz + j];
#pragma unroll
    for (int i = 0; i < nz; ++i) {
        double acc = Ar[i][0] * y[idx[0]];
#pragma unroll
        for (int j = 1; j < nz; ++j) acc = acc + Ar[i][j] * y[idx[j]];
        z[i] = acc + b[i];
    }
}

template <int NZ>
__device__ __forceinline__ double pc_qsq(const double* z, int nq_) {
    const int nq = NZ > 0 ? NZ - 1 : nq_;
    double q_sq = z[0] * z[0];
#pragma unroll
    for (int i = 1; i < nq; ++i) q_sq = q_sq + z[i] * z[i];
    return q_sq;
}

template <int NZ, int SPEC>
__device__ __forceinline__ double pc_value(const double* z, int nz_,
                                           double alpha, double mu, int spec_,
                                           double floor) {
    const int nq = (NZ > 0 ? NZ : nz_) - 1;
    const int spec = SPEC >= 0 ? SPEC : spec_;
    const double s = z[nq];
    const double s_a = pow_alpha(s, alpha, spec, floor);
    return -log_barrier(s_a - pc_qsq<NZ>(z, nq), floor)
           - mu * log_barrier(s, floor);
}

// gradient wrt z (_core_grad)
template <int NZ, int SPEC>
__device__ __forceinline__ void pc_grad(const double* z, int nz_, double alpha,
                                        double mu, int spec_, double floor,
                                        double* gz) {
    const int nq = (NZ > 0 ? NZ : nz_) - 1;
    const int spec = SPEC >= 0 ? SPEC : spec_;
    const double s = z[nq];
    const double s_a = pow_alpha(s, alpha, spec, floor);
    const double r = s_a - pc_qsq<NZ>(z, nq);
    const double inv_r = 1.0 / r;
    const double two_ir = 2.0 * inv_r;
#pragma unroll
    for (int i = 0; i < nq; ++i) gz[i] = two_ir * z[i];
    const double s_am1 = s_a / s;
    gz[nq] = -alpha * s_am1 * inv_r - mu / s;
}

// Hessian wrt z (_core_hess)
template <int NZ, int SPEC>
__device__ __forceinline__ void pc_hess(const double* z, int nz_, double alpha,
                                        double mu, int spec_, double floor,
                                        double Hz[PC_MAXNZ][PC_MAXNZ]) {
    const int nq = (NZ > 0 ? NZ : nz_) - 1;
    const int spec = SPEC >= 0 ? SPEC : spec_;
    const double s = z[nq];
    const double s_a = pow_alpha(s, alpha, spec, floor);
    const double r = s_a - pc_qsq<NZ>(z, nq);
    const double inv_r = 1.0 / r;
    const double two_ir = 2.0 * inv_r;
    const double s_am1 = s_a / s;
    const double s_am2 = s_am1 / s;
    double u[PC_MAXNZ];
#pragma unroll
    for (int i = 0; i < nq; ++i) u[i] = inv_r * z[i];
    const double v = s_am1 * inv_r;
    const double H_ss = -alpha * (alpha - 1.0) * s_am2 * inv_r
                        + (alpha * alpha) * (v * v) + (mu / s) / s;
    const double cv = -2.0 * alpha * v;
#pragma unroll
    for (int i = 0; i < nq; ++i) {
#pragma unroll
        for (int j = 0; j < nq; ++j) {
            const double uu = 4.0 * u[i] * u[j];
            Hz[i][j] = i == j ? uu + two_ir : uu;
        }
        Hz[i][nq] = cv * u[i];
        Hz[nq][i] = cv * u[i];
    }
    Hz[nq][nq] = H_ss;
}

// g = A' gz
template <int NZ>
__device__ __forceinline__ void pc_at_g(const double Ar[PC_MAXNZ][PC_MAXNZ],
                                        const double* gz, int nz_, double* g) {
    const int nz = NZ > 0 ? NZ : nz_;
#pragma unroll
    for (int i = 0; i < nz; ++i) {
        double acc = Ar[0][i] * gz[0];
#pragma unroll
        for (int k = 1; k < nz; ++k) acc = acc + Ar[k][i] * gz[k];
        g[i] = acc;
    }
}

// Entry (i, j) of A' Hz A (_AtHA: the (k, l) pairs summed k-major, from
// (0, 0)); i and j are unrolled loop counters at every call.
template <int NZ>
__device__ __forceinline__ double pc_at_h_a_ij(
    const double Ar[PC_MAXNZ][PC_MAXNZ], const double Hz[PC_MAXNZ][PC_MAXNZ],
    int i, int j) {
    double acc = Ar[0][i] * Hz[0][0] * Ar[0][j];
#pragma unroll
    for (int l = 1; l < NZ; ++l) acc = acc + Ar[0][i] * Hz[0][l] * Ar[l][j];
#pragma unroll
    for (int k = 1; k < NZ; ++k)
#pragma unroll
        for (int l = 0; l < NZ; ++l)
            acc = acc + Ar[k][i] * Hz[k][l] * Ar[l][j];
    return acc;
}

// H = A' Hz A
template <int NZ>
__device__ __forceinline__ void pc_at_h_a(const double Ar[PC_MAXNZ][PC_MAXNZ],
                                          const double Hz[PC_MAXNZ][PC_MAXNZ],
                                          int nz_,
                                          double H[PC_MAXNZ][PC_MAXNZ]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j < NZ; ++j) H[i][j] = pc_at_h_a_ij<NZ>(Ar, Hz, i, j);
}

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
// the alpha specialisation SPEC). K2 (power_cone.cu) and K6's register
// kernels (node_barrier.cu) instantiate them with both fixed, so every loop
// unrolls and the small arrays stay in registers.
//
// K6's runtime-width cone (its wide and table kernels, any nz) runs a node
// on a group of threads, over vectors in shared memory (y[idx] gathered,
// z, then gz, and w). It takes pc_qsq, pc_value and pc_grad (gz over z) at
// NZ = 0 as they are, and the pcw_ helpers at the end for the rest, each
// one entry (or a 2 x 2 tile) of a vector or matrix, so that the group's
// threads share the entries and every sum stays one thread's fold:
// - pcw_affine_i and pcw_at_g_i are MIRRORS of pc_affine and pc_at_g (the
//   same sums in the same order), so modes 0 and 1 give the bits of the
//   register kernels' order; pcw_hess mirrors pc_hess's scalars, and u_k =
//   inv_r z_k is formed where it is used. A change to one of a pair must be
//   made to the other.
// - The Hessian (pcw_w_i, pcw_gram_tile, pcw_h) is NOT _AtHA's order. With
//   nq = nz - 1, Hz = [[4 u u' + two_ir I, cv u], [cv u', H_ss]] and
//   a = row nq of A, A' Hz A = two_ir G + 4 w w' + cv (w a' + a w')
//   + H_ss a a', where G = Aq' Aq over the rows 0..nq-1 and w = Aq' u: a
//   Gram product and rank-one terms, ~nz^3 operations a node where _AtHA's
//   fold takes ~nz^4. The order (written out at those helpers) is that of
//   node_barrier.py's node_barrier_gram_plain (power_cone.py's
//   at_h_a_gram), which the card tests hold the kernels to, bit for bit;
//   it is bitwise symmetric, so a thread makes entry (i, j), i <= j, and
//   stores both.
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

// ---- runtime width ---------------------------------------------------------

// entry i of z = A y[idx] + b (A row-major nz x nz), from the gathered
// yg[j] = y[idx[j]]: pc_affine's fold
__device__ __forceinline__ double pcw_affine_i(const double* A,
                                               const double* b,
                                               const double* yg, int nz,
                                               int i) {
    double acc = A[i * nz] * yg[0];
    for (int j = 1; j < nz; ++j) acc = acc + A[i * nz + j] * yg[j];
    return acc + b[i];
}

// entry i of A' gz: pc_at_g's fold
__device__ __forceinline__ double pcw_at_g_i(const double* A,
                                             const double* gz, int nz,
                                             int i) {
    double acc = A[i] * gz[0];
    for (int k = 1; k < nz; ++k) acc = acc + A[k * nz + i] * gz[k];
    return acc;
}

// The scalars of Hz (pc_hess); u_k = inv_r z_k is made where it is used.
struct PcwHess {
    double two_ir, cv, H_ss, inv_r;
};

__device__ __forceinline__ PcwHess pcw_hess(const double* z, int nz,
                                            double alpha, double mu,
                                            int spec, double floor) {
    const int nq = nz - 1;
    const double s = z[nq];
    const double s_a = pow_alpha(s, alpha, spec, floor);
    const double r = s_a - pc_qsq<0>(z, nq);
    PcwHess h;
    h.inv_r = 1.0 / r;
    h.two_ir = 2.0 * h.inv_r;
    const double s_am1 = s_a / s;
    const double s_am2 = s_am1 / s;
    const double v = s_am1 * h.inv_r;
    h.H_ss = -alpha * (alpha - 1.0) * s_am2 * h.inv_r
             + (alpha * alpha) * (v * v) + (mu / s) / s;
    h.cv = -2.0 * alpha * v;
    return h;
}

// w_i = fold over k = 0..nq-1, ascending, of A[k,i] u_k, u_k = inv_r z_k
__device__ __forceinline__ double pcw_w_i(const double* A, const double* z,
                                          double inv_r, int nz, int i) {
    double acc = A[i] * (inv_r * z[0]);
    for (int k = 1; k < nz - 1; ++k)
        acc = acc + A[k * nz + i] * (inv_r * z[k]);
    return acc;
}

// The Gram entries g_ij = fold over k = 0..nq-1, ascending, of
// A[k,i] A[k,j] of a 2 x 2 tile, (i0, i1) x (j0, j1): g[0] (i0, j0), g[1]
// (i0, j1), g[2] (i1, j0), g[3] (i1, j1); four folds side by side, each
// column loaded once a row.
__device__ __forceinline__ void pcw_gram_tile(const double* A, int nz,
                                              int i0, int i1, int j0, int j1,
                                              double g[4]) {
    g[0] = A[i0] * A[j0];
    g[1] = A[i0] * A[j1];
    g[2] = A[i1] * A[j0];
    g[3] = A[i1] * A[j1];
    for (int k = 1; k < nz - 1; ++k) {
        const double* r = A + k * nz;
        const double a0 = r[i0], a1 = r[i1], b0 = r[j0], b1 = r[j1];
        g[0] = g[0] + a0 * b0;
        g[1] = g[1] + a0 * b1;
        g[2] = g[2] + a1 * b0;
        g[3] = g[3] + a1 * b1;
    }
}

// Entry (i, j) of A' Hz A in the Gram order, from g_ij, w and a = row nq
// of A:
//   H_ij = ((two_ir g_ij + 4 (w_i w_j)) + cv (w_i a_j + a_i w_j))
//          + H_ss (a_i a_j)
// Every product and sum of two operands commutes exactly, so H_ij and
// H_ji hold the same bits. (The cobarrier's cross entry is
// cv w_i + H_ss a_i, its corner H_ss.)
__device__ __forceinline__ double pcw_h(double g, double wi, double wj,
                                        double ai, double aj,
                                        const PcwHess& h) {
    return ((h.two_ir * g + 4.0 * (wi * wj)) + h.cv * (wi * aj + ai * wj))
           + h.H_ss * (ai * aj);
}

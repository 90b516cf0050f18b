// power_cone: the per-node Euclidean power-cone barrier, f64, fused with the
// level's weight mask (bw) and linear term (wc).
//
// Per node n, with y = Dz[n, :], z = A[n] y[idx] + b[n] = (q, s),
// alpha = 2 / p[n]:
//   F0   = -Log(s^alpha - |q|^2) - mu Log(s)
//   mode 0: out[n]       = (bw != 0 ? bw F0 : 0) + sum_k wc[n,k] y[k]
//   mode 1: out[n, :]    = (bw != 0 ? bw scatter(A' grad) : 0) + wc[n, :]
//   mode 2: out[n, :, :] =  bw != 0 ? bw scatter(A' Hess A) : 0
// Every expression follows mgbtpu/convex/euclidian_power.py (_core_grad,
// _core_hess, _AtHA) operation by operation; the library is built with
// --fmad=false so each product and sum rounds as the reference's do.
// Non-finite semantics are the reference's: Log(x) is -inf for x <= floor
// (NaN included), safe_pow gives 0 for s <= 0, masked nodes give 0.
//
// Replaces the Pallas kernel node_eval (mgbtpu/ops/pallas_dd.py:258), which
// ran vmap(F) of a traced per-node function in double-float.
// One thread per node; nz <= 4, nD <= 8.
// Bound on an H100: bytes (a few hundred flops per ~30 doubles read).
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#define MAXNZ 4
#define MAXND 8

__device__ __forceinline__ double log_barrier(double x, double floor) {
    return x > floor ? log(x) : -INFINITY;
}

__device__ __forceinline__ double pow_alpha(double s, double alpha, int spec,
                                            double floor) {
    if (spec == 2) return s > 0.0 ? s * s : 0.0;
    if (spec == 1) return s > 0.0 ? s : 0.0;
    return exp(alpha * log_barrier(s, floor));
}

__global__ void power_cone_kernel(int mode, int spec, int m, int nD, int nz,
                                  int i0, int i1, int i2, int i3,
                                  const double* __restrict__ Dz,
                                  const double* __restrict__ A,
                                  const double* __restrict__ b,
                                  const double* __restrict__ pg,
                                  const double* __restrict__ mug,
                                  const double* __restrict__ bwg,
                                  const double* __restrict__ wc,
                                  double floor, double* __restrict__ out) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= m) return;
    const int idx[MAXNZ] = {i0, i1, i2, i3};
    const double* y = Dz + (size_t)n * nD;
    double Ar[MAXNZ][MAXNZ];
    for (int i = 0; i < nz; ++i)
        for (int j = 0; j < nz; ++j) Ar[i][j] = A[(size_t)n * nz * nz + i * nz + j];
    double z[MAXNZ];
    for (int i = 0; i < nz; ++i) {
        double acc = Ar[i][0] * y[idx[0]];
        for (int j = 1; j < nz; ++j) acc = acc + Ar[i][j] * y[idx[j]];
        z[i] = acc + b[(size_t)n * nz + i];
    }
    const int nq = nz - 1;
    const double s = z[nq];
    double q_sq = z[0] * z[0];
    for (int i = 1; i < nq; ++i) q_sq = q_sq + z[i] * z[i];
    const double p = pg[n], mu = mug[n], bw = bwg[n];
    const double alpha = 2.0 / p;
    const double s_a = pow_alpha(s, alpha, spec, floor);
    const double* wcn = wc + (size_t)n * nD;

    if (mode == 0) {
        const double F = -log_barrier(s_a - q_sq, floor) - mu * log_barrier(s, floor);
        double lin = wcn[0] * y[0];
        for (int k = 1; k < nD; ++k) lin = lin + wcn[k] * y[k];
        out[n] = (bw != 0.0 ? bw * F : 0.0) + lin;
        return;
    }
    const double r = s_a - q_sq;
    const double inv_r = 1.0 / r;
    const double two_ir = 2.0 * inv_r;
    const double s_am1 = s_a / s;
    // position of each input row in idx (-1: not an input of the cone)
    int pos[MAXND];
    for (int k = 0; k < nD; ++k) pos[k] = -1;
    for (int j = 0; j < nz; ++j) pos[idx[j]] = j;

    if (mode == 1) {
        double gz[MAXNZ];
        for (int i = 0; i < nq; ++i) gz[i] = two_ir * z[i];
        gz[nq] = -alpha * s_am1 * inv_r - mu / s;
        double g[MAXNZ];
        for (int i = 0; i < nz; ++i) {
            double acc = Ar[0][i] * gz[0];
            for (int k = 1; k < nz; ++k) acc = acc + Ar[k][i] * gz[k];
            g[i] = acc;
        }
        double* o = out + (size_t)n * nD;
        for (int k = 0; k < nD; ++k) {
            const double gk = pos[k] >= 0 ? g[pos[k]] : 0.0;
            o[k] = (bw != 0.0 ? bw * gk : 0.0) + wcn[k];
        }
        return;
    }

    const double s_am2 = s_am1 / s;
    double u[MAXNZ];
    for (int i = 0; i < nq; ++i) u[i] = inv_r * z[i];
    const double v = s_am1 * inv_r;
    const double H_ss = -alpha * (alpha - 1.0) * s_am2 * inv_r
                        + (alpha * alpha) * (v * v) + (mu / s) / s;
    double Hz[MAXNZ][MAXNZ];
    const double cv = -2.0 * alpha * v;
    for (int i = 0; i < nq; ++i) {
        for (int j = 0; j < nq; ++j) {
            const double uu = 4.0 * u[i] * u[j];
            Hz[i][j] = i == j ? uu + two_ir : uu;
        }
        Hz[i][nq] = cv * u[i];
        Hz[nq][i] = cv * u[i];
    }
    Hz[nq][nq] = H_ss;
    double H[MAXNZ][MAXNZ];
    for (int i = 0; i < nz; ++i)
        for (int j = 0; j < nz; ++j) {
            double acc = Ar[0][i] * Hz[0][0] * Ar[0][j];
            for (int t = 1; t < nz * nz; ++t) {
                const int k = t / nz, l = t - k * nz;
                acc = acc + Ar[k][i] * Hz[k][l] * Ar[l][j];
            }
            H[i][j] = acc;
        }
    double* o = out + (size_t)n * nD * nD;
    for (int a = 0; a < nD; ++a)
        for (int c = 0; c < nD; ++c) {
            const double h = (pos[a] >= 0 && pos[c] >= 0) ? H[pos[a]][pos[c]] : 0.0;
            o[a * nD + c] = bw != 0.0 ? bw * h : 0.0;
        }
}

extern "C" int power_cone_launch(int mode, int spec, int m, int nD, int nz,
                                 int i0, int i1, int i2, int i3,
                                 const void* Dz, const void* A, const void* b,
                                 const void* p, const void* mu, const void* bw,
                                 const void* wc, double floor, void* out,
                                 void* stream) {
    if (m > 0) {
        const int block = 128;
        power_cone_kernel<<<(m + block - 1) / block, block, 0,
                            (cudaStream_t)stream>>>(
            mode, spec, m, nD, nz, i0, i1, i2, i3, (const double*)Dz,
            (const double*)A, (const double*)b, (const double*)p,
            (const double*)mu, (const double*)bw, (const double*)wc, floor,
            (double*)out);
    }
    return (int)cudaGetLastError();
}

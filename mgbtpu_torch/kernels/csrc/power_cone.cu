// power_cone: the per-node Euclidean power-cone barrier, f64, fused with the
// level's weight mask (bw) and linear term (wc).
//
// Per node n, with y = Dz[n, :], z = A[n] y[idx] + b[n] = (q, s),
// alpha = 2 / p[n]:
//   F0   = -Log(s^alpha - |q|^2) - mu Log(s)
//   mode 0: out[n]       = (bw != 0 ? bw F0 : 0) + sum_k wc[n,k] y[k]
//   mode 1: out[n, :]    = (bw != 0 ? bw scatter(A' grad) : 0) + wc[n, :]
//   mode 2: out[n, :, :] =  bw != 0 ? bw scatter(A' Hess A) : 0
// The closed forms are those of power_cone.cuh (shared with node_barrier.cu),
// which follow mgbtpu/convex/euclidian_power.py operation by operation.
//
// Replaces the Pallas kernel node_eval (mgbtpu/ops/pallas_dd.py:258), which
// ran vmap(F) of a traced per-node function in double-float, for a lone
// power cone; every other barrier family goes through node_barrier.cu.
// One thread per node; nz <= 5, nD <= 12.
// Bound on an H100: bytes (a few hundred flops per ~30 doubles read).
#include <cstdint>
#include <cuda_runtime.h>

#include "power_cone.cuh"

#define MAXND 12

__global__ void power_cone_kernel(int mode, int spec, int m, int nD, int nz,
                                  int i0, int i1, int i2, int i3, int i4,
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
    const int idx[PC_MAXNZ] = {i0, i1, i2, i3, i4};
    const double* y = Dz + (size_t)n * nD;
    double Ar[PC_MAXNZ][PC_MAXNZ];
    double z[PC_MAXNZ];
    pc_affine(A + (size_t)n * nz * nz, b + (size_t)n * nz, y, idx, nz, Ar, z);
    const double mu = mug[n], bw = bwg[n];
    const double alpha = 2.0 / pg[n];
    const double* wcn = wc + (size_t)n * nD;

    if (mode == 0) {
        const double F = pc_value(z, nz, alpha, mu, spec, floor);
        double lin = wcn[0] * y[0];
        for (int k = 1; k < nD; ++k) lin = lin + wcn[k] * y[k];
        out[n] = (bw != 0.0 ? bw * F : 0.0) + lin;
        return;
    }
    // position of each input row in idx (-1: not an input of the cone)
    int pos[MAXND];
    for (int k = 0; k < nD; ++k) pos[k] = -1;
    for (int j = 0; j < nz; ++j) pos[idx[j]] = j;

    if (mode == 1) {
        double gz[PC_MAXNZ], g[PC_MAXNZ];
        pc_grad(z, nz, alpha, mu, spec, floor, gz);
        pc_at_g(Ar, gz, nz, g);
        double* o = out + (size_t)n * nD;
        for (int k = 0; k < nD; ++k) {
            const double gk = pos[k] >= 0 ? g[pos[k]] : 0.0;
            o[k] = (bw != 0.0 ? bw * gk : 0.0) + wcn[k];
        }
        return;
    }

    double Hz[PC_MAXNZ][PC_MAXNZ], H[PC_MAXNZ][PC_MAXNZ];
    pc_hess(z, nz, alpha, mu, spec, floor, Hz);
    pc_at_h_a(Ar, Hz, nz, H);
    double* o = out + (size_t)n * nD * nD;
    for (int a = 0; a < nD; ++a)
        for (int c = 0; c < nD; ++c) {
            const double h = (pos[a] >= 0 && pos[c] >= 0) ? H[pos[a]][pos[c]] : 0.0;
            o[a * nD + c] = bw != 0.0 ? bw * h : 0.0;
        }
}

extern "C" int power_cone_launch(int mode, int spec, int m, int nD, int nz,
                                 int i0, int i1, int i2, int i3, int i4,
                                 const void* Dz, const void* A, const void* b,
                                 const void* p, const void* mu, const void* bw,
                                 const void* wc, double floor, void* out,
                                 void* stream) {
    if (m > 0) {
        const int block = 128;
        power_cone_kernel<<<(m + block - 1) / block, block, 0,
                            (cudaStream_t)stream>>>(
            mode, spec, m, nD, nz, i0, i1, i2, i3, i4, (const double*)Dz,
            (const double*)A, (const double*)b, (const double*)p,
            (const double*)mu, (const double*)bw, (const double*)wc, floor,
            (double*)out);
    }
    return (int)cudaGetLastError();
}

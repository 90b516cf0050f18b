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
//
// One thread per node, in blocks of 32 nodes (64 above 8,448 nodes), one
// instance per (nz, mode, spec): every loop over the cone unrolls, and z,
// A, its Hessians and gradients stay in registers (no runtime-indexed
// array). A block stages its nodes' A, b, Dz and wc in shared memory with
// coalesced cp.async copies; modes 1 and 2 build the block's output in
// shared memory (each node's row or nD x nD block first filled with the
// value of an entry outside the cone's rows, then the cone's entries
// written at the idx positions) and store it coalesced. Node n's value of
// an entry outside the cone's rows is bw * 0.0 (or 0.0 where bw == 0), as
// the plain version's scatter of exact zeros gives it.
// Bound on an H100: bytes (a few hundred flops per ~30 doubles moved); at
// fem2d_P2 L=5 the inputs sit in L2 and the call is launch-bound.
#include <cstdint>
#include <cuda_runtime.h>

#include "cpasync.cuh"
#include "power_cone.cuh"

#define PCK_MAXND 12
#define PCK_SMEM (48 * 1024)

struct PCArgs {
    const double *Dz, *A, *b, *p, *mu, *bw, *wc;
    double* out;
    double floor;
    int m, nD;
    int idx[PC_MAXNZ];
};

// doubles a staged region of B rows of w takes: room for the parity shift,
// rounded up to even so that the next region starts 16-byte aligned
__host__ __device__ __forceinline__ int region(int B, int w) {
    return (B * w + 2) & ~1;
}

// the output row of a node in shared memory: an odd stride, so that the
// threads of a warp write to distinct banks
__host__ __device__ __forceinline__ int out_stride(int mode, int nD) {
    return (mode == 1 ? nD : nD * nD) | 1;
}

__host__ __device__ __forceinline__ int smem_doubles(int mode, int nz, int nD,
                                                     int B) {
    int n = region(B, nz * nz) + region(B, nz) + region(B, nD);
    if (mode < 2) n += region(B, nD);                            // wc
    if (mode > 0) n += B * out_stride(mode, nD);
    return n;
}

// Stage src[0, n) into dst (shifted to src's parity); returns the start.
__device__ __forceinline__ const double* stage(double* dst, const double* src,
                                               int n, int t, int nt) {
    double* d = dst + odd8(src);
    cp_run(d, src, n, t, nt);
    return d;
}

// The block's nb rows of w doubles, shared (stride so) -> global dst.
__device__ __forceinline__ void store_rows(double* dst, const double* so,
                                           int nb, int w, int so_stride,
                                           int t, int nt) {
    int row = t / w, x = t - row * w;
    const int dq = nt / w, dr = nt - dq * w;
    for (int i = t; i < nb * w; i += nt) {
        dst[i] = so[row * so_stride + x];
        row += dq;
        x += dr;
        if (x >= w) {
            x -= w;
            ++row;
        }
    }
}

template <int NZ, int MODE, int SPEC>
__global__ void __launch_bounds__(64) power_cone_kernel(const PCArgs a) {
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, B = blockDim.x;
    const int n0 = blockIdx.x * B;
    const int nb = min(B, a.m - n0);
    const int nD = a.nD;
    double* base = sh;
    const double* sA = stage(base, a.A + (size_t)n0 * NZ * NZ, nb * NZ * NZ,
                             t, B);
    base += region(B, NZ * NZ);
    const double* sb = stage(base, a.b + (size_t)n0 * NZ, nb * NZ, t, B);
    base += region(B, NZ);
    const double* sy = stage(base, a.Dz + (size_t)n0 * nD, nb * nD, t, B);
    base += region(B, nD);
    const double* sw = nullptr;
    if (MODE < 2) {
        sw = stage(base, a.wc + (size_t)n0 * nD, nb * nD, t, B);
        base += region(B, nD);
    }
    double* so = base;
    const int sos = out_stride(MODE, nD);
    const int n = n0 + t;
    const bool live = t < nb;
    double mu = 0.0, bw = 0.0, pn = 1.0;
    if (live) {
        mu = a.mu[n];
        bw = a.bw[n];
        pn = a.p[n];
    }
    cp_async_wait_all();
    __syncthreads();

    if (live) {
        int idx[NZ];
#pragma unroll
        for (int j = 0; j < NZ; ++j) idx[j] = a.idx[j];
        const double* y = sy + t * nD;
        double Ar[PC_MAXNZ][PC_MAXNZ], z[PC_MAXNZ];
        pc_affine<NZ>(sA + t * NZ * NZ, sb + t * NZ, y, idx, NZ, Ar, z);
        const double alpha = 2.0 / pn;
        if (MODE == 0) {
            const double F = pc_value<NZ, SPEC>(z, NZ, alpha, mu, SPEC,
                                                a.floor);
            const double* w = sw + t * nD;
            double lin = w[0] * y[0];
            for (int k = 1; k < nD; ++k) lin = lin + w[k] * y[k];
            a.out[n] = (bw != 0.0 ? bw * F : 0.0) + lin;
        } else if (MODE == 1) {
            double gz[PC_MAXNZ], g[PC_MAXNZ];
            pc_grad<NZ, SPEC>(z, NZ, alpha, mu, SPEC, a.floor, gz);
            pc_at_g<NZ>(Ar, gz, NZ, g);
            const double* w = sw + t * nD;
            double* o = so + t * sos;
            const double zero = bw != 0.0 ? bw * 0.0 : 0.0;
            for (int k = 0; k < nD; ++k) o[k] = zero + w[k];
#pragma unroll
            for (int j = 0; j < NZ; ++j)
                o[idx[j]] = (bw != 0.0 ? bw * g[j] : 0.0) + w[idx[j]];
        } else {
            double Hz[PC_MAXNZ][PC_MAXNZ], H[PC_MAXNZ][PC_MAXNZ];
            pc_hess<NZ, SPEC>(z, NZ, alpha, mu, SPEC, a.floor, Hz);
            pc_at_h_a<NZ>(Ar, Hz, NZ, H);
            double* o = so + t * sos;
            const double zero = bw != 0.0 ? bw * 0.0 : 0.0;
            for (int i = 0; i < nD * nD; ++i) o[i] = zero;
#pragma unroll
            for (int i = 0; i < NZ; ++i)
#pragma unroll
                for (int j = 0; j < NZ; ++j)
                    o[idx[i] * nD + idx[j]] = bw != 0.0 ? bw * H[i][j] : 0.0;
        }
    }
    if (MODE == 0) return;
    __syncthreads();
    const int w = MODE == 1 ? nD : nD * nD;
    store_rows(a.out + (size_t)n0 * w, so, nb, w, sos, t, B);
}

template <int NZ, int MODE>
static cudaError_t launch_spec(int spec, dim3 grid, int B, size_t smem,
                               cudaStream_t st, const PCArgs& a) {
    switch (spec) {
        case 0: power_cone_kernel<NZ, MODE, 0><<<grid, B, smem, st>>>(a); break;
        case 1: power_cone_kernel<NZ, MODE, 1><<<grid, B, smem, st>>>(a); break;
        default: power_cone_kernel<NZ, MODE, 2><<<grid, B, smem, st>>>(a);
    }
    return cudaGetLastError();
}

template <int NZ>
static cudaError_t launch_mode(int mode, int spec, dim3 grid, int B,
                               size_t smem, cudaStream_t st, const PCArgs& a) {
    switch (mode) {
        case 0: return launch_spec<NZ, 0>(spec, grid, B, smem, st, a);
        case 1: return launch_spec<NZ, 1>(spec, grid, B, smem, st, a);
        default: return launch_spec<NZ, 2>(spec, grid, B, smem, st, a);
    }
}

extern "C" int power_cone_launch(int mode, int spec, int m, int nD, int nz,
                                 int i0, int i1, int i2, int i3, int i4,
                                 const void* Dz, const void* A, const void* b,
                                 const void* p, const void* mu, const void* bw,
                                 const void* wc, double floor, void* out,
                                 void* stream) {
    if (m <= 0) return (int)cudaGetLastError();
    if (mode < 0 || mode > 2 || spec < 0 || spec > 2 || nz < 2
        || nz > PC_MAXNZ || nD < 1 || nD > PCK_MAXND)
        return (int)cudaErrorInvalidValue;
    PCArgs a = {(const double*)Dz, (const double*)A, (const double*)b,
                (const double*)p, (const double*)mu, (const double*)bw,
                (const double*)wc, (double*)out, floor, m, nD,
                {i0, i1, i2, i3, i4}};
    // 32 nodes a block spread fem2d_P2 L=5's 3,584 nodes over 112 SMs
    int B = m <= 8448 ? 32 : 64;
    while (B > 32 && sizeof(double) * smem_doubles(mode, nz, nD, B) > PCK_SMEM)
        B /= 2;
    const size_t smem = sizeof(double) * smem_doubles(mode, nz, nD, B);
    const dim3 grid((m + B - 1) / B);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (nz) {
        case 2: return (int)launch_mode<2>(mode, spec, grid, B, smem, st, a);
        case 3: return (int)launch_mode<3>(mode, spec, grid, B, smem, st, a);
        case 4: return (int)launch_mode<4>(mode, spec, grid, B, smem, st, a);
        default: return (int)launch_mode<5>(mode, spec, grid, B, smem, st, a);
    }
}

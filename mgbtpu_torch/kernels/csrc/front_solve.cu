// front_solve: one tree level's share of a nested-dissection solve sweep,
// fused, f64. Per front n (Lf[n] a x a lower, U[n] b x a, both row-major),
// on the padded vectors r, x of n_J + 1 entries (entry n_J is the dump):
//
//   forward:   y[n]   = Lf[n]^-1 r[adofs[n]]
//              upd[n] = U[n] y[n]
//              r[rows[i]] -= upd[inc[i, 0]], upd[inc[i, 1]], ... in turn
//   backward:  t      = y[n] - U[n]^T x[bdofs[n]]
//              xA[n]  = Lf[n]^-T t, 0 where adofs[n] >= n_J
//              x[adofs[n]] = xA[n]
//
// Replaces the solve half of the Pallas kernel panel_chol_inv
// (mgbtpu/ops/pallas_dd.py:446), whose triangular inverse turned the dd
// solves into products; the x64 reference solves with the factor itself
// (mgbtpu/ops/ndchol.py:538-559), and so does this kernel. Its gathers,
// products and the separator update live in the kernel, so a sweep costs
// the host one call per tree level.
//
// Design: one block per front; the right-hand side in shared memory.
// Substitution runs in 32-wide diagonal tiles: the block stages the tile row
// by row (coalesced 32-double segments) in shared memory, one warp solves it
// with shuffles and no block barrier, then all warps apply the tile's
// off-diagonal panel to the rest of the right-hand side, reading the factor
// by rows: forward, a warp per four rows, each a fixed shuffle-tree sum;
// backward, a thread per column over the tile's rows. Two block barriers per
// tile, ceil(a/32) tiles; the diagonal's reciprocals are taken as the tile
// is staged, so the warp's serial chain has no division. The separator
// update (r[rows] -= the level's updates landing on each separator dof, in
// increasing flat position, from the inverse incidence inc) is a second
// kernel of the forward entry: a gather in a fixed order, no atomics, the
// same bits as a sequential scatter-add.
// Bound on an H100: bytes (the factor and U read once, 2 flops per 8 bytes);
// at the nested-dissection front sizes the ceil(a/32)-step chain of warp
// solves and barriers, and the launches: every kernel here launches as a
// programmatic dependent (pdl.cuh), so the next level's kernel is scheduled
// while this one runs.
#include <cstdint>
#include <cuda_runtime.h>

#include "pdl.cuh"

#define FS_THREADS 256
#define FS_WARPS (FS_THREADS / 32)
#define TILE 32
#define TLD (TILE + 1)  // padded row of the staged tile: no bank conflicts
#define FULL 0xffffffffu
#define ROWS 4          // rows a warp reduces at once

// The w x w lower diagonal tile at (j0, j0) of the row-major a x a factor,
// staged row by row into T (zero above the diagonal), with the reciprocals
// of its diagonal in D: a tile step then multiplies, and the division
// leaves the warp's serial chain.
__device__ __forceinline__ void stage_tile(const double* __restrict__ Ln,
                                           int a, int j0, int w, double* T,
                                           double* D) {
    for (int t = threadIdx.x; t < w * TILE; t += FS_THREADS) {
        const int i = t / TILE, c = t - i * TILE;
        const double v = c <= i ? Ln[(size_t)(j0 + i) * a + j0 + c] : 0.0;
        T[i * TLD + c] = v;
        if (c == i) D[i] = 1.0 / v;
    }
}

// s[u] = the dot of row i0 + u of the row-major matrix M (ld columns) over
// columns [c0, c0 + w) with x there, for the R rows a warp takes at once
// (rows past nrows give 0): the rows' loads go out together and their
// shuffle trees interleave. Lane 0 ends with the sums, each a fixed-shape
// tree.
template <int R>
__device__ __forceinline__ void warp_rows(const double* __restrict__ M,
                                          size_t ld, int i0, int nrows,
                                          int c0, int w, const double* x,
                                          int lane, double* s) {
#pragma unroll
    for (int u = 0; u < R; ++u)
        s[u] = (u < nrows && lane < w)
                   ? M[(size_t)(i0 + u) * ld + c0 + lane] * x[c0 + lane]
                   : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < R; ++u)
            s[u] += __shfl_down_sync(FULL, s[u], o);
}

__global__ void front_forward_kernel(const double* __restrict__ Lf,
                                     const double* __restrict__ U,
                                     const int64_t* __restrict__ adofs,
                                     const double* __restrict__ r,
                                     double* __restrict__ y,
                                     double* __restrict__ upd, int a, int b) {
    extern __shared__ double sm[];
    double* T = sm;                // TILE x TLD
    double* D = T + TILE * TLD;    // TILE: 1 / the tile's diagonal
    double* x = D + TILE;          // a: the right-hand side, then y
    pdl_wait();
    pdl_trigger();
    const int n = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const double* Ln = Lf + (size_t)n * a * a;
    const double* Un = U + (size_t)n * b * a;
    const int64_t* an = adofs + (size_t)n * a;
    for (int i = tid; i < a; i += FS_THREADS) x[i] = r[an[i]];
    for (int j0 = 0; j0 < a; j0 += TILE) {
        const int w = min(TILE, a - j0);
        stage_tile(Ln, a, j0, w, T, D);
        __syncthreads();
        if (warp == 0) {
            double v = lane < w ? x[j0 + lane] : 0.0;
#pragma unroll 8  // the tile's loads leave the chain of shuffles
            for (int c = 0; c < w; ++c) {
                const double xc = __shfl_sync(FULL, v, c) * D[c];
                if (lane == c) v = xc;
                else if (lane > c && lane < w) v -= T[lane * TLD + c] * xc;
            }
            if (lane < w) x[j0 + lane] = v;
        }
        __syncthreads();
        // x[i] -= Lf[i, j0:j0+w] . x[j0:j0+w] below the tile, a warp per
        // ROWS rows
        for (int i0 = j0 + w + warp * ROWS; i0 < a; i0 += FS_WARPS * ROWS) {
            double s[ROWS];
            warp_rows<ROWS>(Ln, a, i0, a - i0, j0, w, x, lane, s);
            if (lane == 0)
#pragma unroll
                for (int u = 0; u < ROWS; ++u)
                    if (i0 + u < a) x[i0 + u] -= s[u];
        }
    }
    // the last tile's barrier published every entry of x
    double* yn = y + (size_t)n * a;
    for (int i = tid; i < a; i += FS_THREADS) yn[i] = x[i];
    // upd = U y, a warp per ROWS rows of U, 32 columns at a time
    for (int i0 = warp * ROWS; i0 < b; i0 += FS_WARPS * ROWS) {
        double acc[ROWS] = {};
        for (int c0 = 0; c0 < a; c0 += 32) {
            double s[ROWS];
            warp_rows<ROWS>(Un, a, i0, b - i0, c0, min(32, a - c0), x, lane,
                            s);
#pragma unroll
            for (int u = 0; u < ROWS; ++u) acc[u] += s[u];
        }
        if (lane == 0)
#pragma unroll
            for (int u = 0; u < ROWS; ++u)
                if (i0 + u < b) upd[(size_t)n * b + i0 + u] = acc[u];
    }
}

__global__ void front_separator_kernel(const double* __restrict__ upd,
                                       const int64_t* __restrict__ rows,
                                       const int64_t* __restrict__ inc,
                                       double* __restrict__ r, int nr, int Kb,
                                       int64_t pad) {
    pdl_wait();
    pdl_trigger();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nr) return;
    const int64_t* ii = inc + (size_t)i * Kb;
    const int64_t d = rows[i];
    double acc = r[d];
#pragma unroll 4  // independent loads in flight; the subtractions in order
    for (int t = 0; t < Kb; ++t) {
        const int64_t f = ii[t];
        if (f != pad) acc -= upd[f];  // padding is trailing
    }
    r[d] = acc;
}

__global__ void front_backward_kernel(const double* __restrict__ Lf,
                                      const double* __restrict__ U,
                                      const int64_t* __restrict__ adofs,
                                      const int64_t* __restrict__ bdofs,
                                      const double* __restrict__ y,
                                      double* __restrict__ xv,
                                      double* __restrict__ xA, int a, int b,
                                      int n_J) {
    extern __shared__ double sm[];
    double* T = sm;                 // TILE x TLD
    double* D = T + TILE * TLD;     // TILE: 1 / the tile's diagonal
    double* t = D + TILE;           // a: the right-hand side, then xA
    double* xB = t + a;             // b
    pdl_wait();
    pdl_trigger();
    const int n = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const double* Ln = Lf + (size_t)n * a * a;
    const double* Un = U + (size_t)n * b * a;
    const int64_t* an = adofs + (size_t)n * a;
    const int64_t* bn = bdofs + (size_t)n * b;
    // x[bdofs] are separator entries of higher levels: no block of this
    // level writes them (it writes x[adofs], and the dump entry stays 0)
    for (int i = tid; i < b; i += FS_THREADS) xB[i] = xv[bn[i]];
    __syncthreads();
    const double* yn = y + (size_t)n * a;
    for (int i = tid; i < a; i += FS_THREADS) {  // t = y - U^T xB, by columns
        double s = 0.0;
#pragma unroll 8
        for (int k = 0; k < b; ++k) s += Un[(size_t)k * a + i] * xB[k];
        t[i] = yn[i] - s;
    }
    for (int j0 = ((a - 1) / TILE) * TILE; j0 >= 0; j0 -= TILE) {
        const int w = min(TILE, a - j0);
        stage_tile(Ln, a, j0, w, T, D);
        __syncthreads();
        if (warp == 0) {  // the tile's transpose: row c of T gives column c
            double v = lane < w ? t[j0 + lane] : 0.0;
#pragma unroll 8
            for (int c = w - 1; c >= 0; --c) {
                const double xc = __shfl_sync(FULL, v, c) * D[c];
                if (lane == c) v = xc;
                else if (lane < c) v -= T[c * TLD + lane] * xc;
            }
            if (lane < w) t[j0 + lane] = v;
        }
        __syncthreads();
        // t[j] -= sum_i Lf[j0+i, j] t[j0+i] above the tile, a thread per j
        for (int j = tid; j < j0; j += FS_THREADS) {
            double s = 0.0;
#pragma unroll 8
            for (int i = 0; i < w; ++i)
                s += Ln[(size_t)(j0 + i) * a + j] * t[j0 + i];
            t[j] -= s;
        }
    }
    double* xn = xA + (size_t)n * a;
    for (int i = tid; i < a; i += FS_THREADS) {
        const int64_t d = an[i];
        const double v = d < n_J ? t[i] : 0.0;
        xn[i] = v;
        xv[d] = v;
    }
}

static int fit_smem(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Forward: reads Lf, U, adofs, rows, inc; updates r in place; writes y and
// upd.
extern "C" int front_forward_launch(const void* Lf, const void* U,
                                    const void* adofs, const void* rows,
                                    const void* inc, void* r, void* y,
                                    void* upd, int nk, int a, int b, int nr,
                                    int Kb, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = (size_t)(TILE * TLD + TILE + a) * sizeof(double);
    int e = fit_smem((const void*)front_forward_kernel, smem);
    if (!e && nk > 0)
        e = (int)launch_pdl(front_forward_kernel, dim3(nk), dim3(FS_THREADS),
                            smem, s, (const double*)Lf, (const double*)U,
                            (const int64_t*)adofs, (const double*)r,
                            (double*)y, (double*)upd, a, b);
    if (!e && nr > 0)
        e = (int)launch_pdl(front_separator_kernel, dim3((nr + 127) / 128),
                            dim3(128), 0, s, (const double*)upd,
                            (const int64_t*)rows, (const int64_t*)inc,
                            (double*)r, nr, Kb, (int64_t)nk * b);
    return e ? e : (int)cudaGetLastError();
}

// Backward: reads Lf, U, adofs, bdofs, y; updates x at adofs; writes xA.
extern "C" int front_backward_launch(const void* Lf, const void* U,
                                     const void* adofs, const void* bdofs,
                                     const void* y, void* x, void* xA,
                                     int nk, int a, int b, int n_J,
                                     void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = (size_t)(TILE * TLD + TILE + a + b) * sizeof(double);
    int e = fit_smem((const void*)front_backward_kernel, smem);
    if (!e && nk > 0)
        e = (int)launch_pdl(front_backward_kernel, dim3(nk), dim3(FS_THREADS),
                            smem, s, (const double*)Lf, (const double*)U,
                            (const int64_t*)adofs, (const int64_t*)bdofs,
                            (const double*)y, (double*)x, (double*)xA, a, b,
                            n_J);
    return e ? e : (int)cudaGetLastError();
}

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
// Bound on an H100: bytes (the factor and U read once a sweep, 2 flops per
// 8 bytes); at the nested-dissection front sizes the ceil(a/32)-step chain
// of warp solves and barriers, and the launches: every kernel here launches
// as a programmatic dependent (pdl.cuh), so the next level's kernel is
// scheduled while this one runs.
//
// The large form (fronts of f >= 320: every fem3d Q3 front, no fem2d one):
// one block a front reads up to 40 MB of factor (the fem3d L=5 root)
// through one SM, at that SM's share of the bandwidth. The large form
// splits each front into bands of 32 rows (forward: Lf's, then U's) or of
// 32 of Lf's columns (backward), a block a band, so every byte of the
// factor is read once a sweep by the block that owns it and the level's
// fronts run on every SM. The bands of a front wait on each other through
// a ready counter in device memory (release/acquire); see the kernels. Each
// launch takes fresh counters, zero, from a ring the wrapper keeps for the
// stream (zeroed again only when it is used up), so no memset stands
// between two kernels of the programmatic-dependent chain.
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

// ---------------------------------------------------------------------------
// The large form: one front over many blocks (see the note at the top).
// ---------------------------------------------------------------------------

// ld.acquire of a counter another block advances
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
                 : "memory");
    return v;
}

// The block's logical id, from a ticket counter: ids follow the order in
// which blocks start, so a block that waits on a smaller id waits on a
// block that is running or done.
__device__ __forceinline__ int ticket(unsigned* counter, int* slot) {
    if (threadIdx.x == 0) *slot = (int)atomicAdd(counter, 1u);
    __syncthreads();
    const int id = *slot;
    __syncthreads();  // the slot is free for wait_ready
    return id;
}

// Thread 0 waits until *ready >= need, then the block reads the value it
// saw; returns it. Every thread of the block calls it.
__device__ __forceinline__ unsigned wait_ready(const unsigned* ready,
                                               unsigned need, int* slot) {
    if (threadIdx.x == 0) {
        unsigned v;
        while ((v = ld_acquire(ready)) < need) __nanosleep(32);
        *slot = (int)v;
    }
    __syncthreads();
    const unsigned v = (unsigned)*slot;
    __syncthreads();  // the slot is free for the next wait
    return v;
}

// Forward, the large form: [Lf; U] of front n in bands of 32 rows, a block
// a band: Lf's ceil(a/32) bands, then U's ceil(b/32). A band accumulates
// its rows' products with y tile by tile (tile k once band k has published
// it: ready[n] > k), each lane a partial sum over its column of every tile,
// then one shuffle tree a row; an Lf band solves its diagonal tile with one
// warp and publishes y's 32 entries (ready[n] = band + 1); a U band writes
// its rows of upd = U y. A band's logical id, from the ticket, is band nk
// + n: every band of a front waits only on smaller ids. sync[0] is the
// ticket, sync[1 + n] front n's ready count (zero at the start).
__global__ void __launch_bounds__(FS_THREADS)
    front_forward_band_kernel(const double* __restrict__ Lf,
                              const double* __restrict__ U,
                              const int64_t* __restrict__ adofs,
                              const double* __restrict__ r, double* y,
                              double* __restrict__ upd, unsigned* sync,
                              int nk, int a, int b) {
    __shared__ double T[TILE * TLD];
    __shared__ double D[TILE];
    __shared__ double rhs[TILE];
    __shared__ int slot;
    pdl_wait();
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int id = ticket(sync, &slot);
    const int nbL = (a + TILE - 1) / TILE;
    const int band = id / nk, n = id - band * nk;
    const bool isL = band < nbL;
    const int r0 = TILE * (isL ? band : band - nbL);
    const int nrows = min(TILE, (isL ? a : b) - r0);
    const double* M = (isL ? Lf + (size_t)n * a * a : U + (size_t)n * b * a) +
                      (size_t)r0 * a;
    const unsigned* ready = sync + 1 + n;
    const int K = isL ? band : nbL;  // the tiles of y the band needs
    if (isL) stage_tile(Lf + (size_t)n * a * a, a, r0, nrows, T, D);
    const double* yn = y + (size_t)n * a;
    double acc[ROWS] = {};
    unsigned have = 0;
    for (int k = 0; k < K; ++k) {
        const int c = TILE * k + lane;
        double m[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
            const int i = warp * ROWS + u;
            m[u] = i < nrows && c < a ? M[(size_t)i * a + c] : 0.0;
        }
        if ((unsigned)k >= have) have = wait_ready(ready, k + 1, &slot);
        const double xk = c < a ? __ldcg(yn + c) : 0.0;
#pragma unroll
        for (int u = 0; u < ROWS; ++u) acc[u] = fma(m[u], xk, acc[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
            acc[u] += __shfl_xor_sync(FULL, acc[u], o);
    if (!isL) {
        if (lane == 0)
#pragma unroll
            for (int u = 0; u < ROWS; ++u) {
                const int i = warp * ROWS + u;
                if (i < nrows) upd[(size_t)n * b + r0 + i] = acc[u];
            }
        return;
    }
    if (lane == 0)
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
            const int i = warp * ROWS + u;
            if (i < nrows)
                rhs[i] = r[adofs[(size_t)n * a + r0 + i]] - acc[u];
        }
    __syncthreads();
    if (warp == 0) {
        const int w = nrows;
        double v = lane < w ? rhs[lane] : 0.0;
#pragma unroll 8
        for (int c = 0; c < w; ++c) {
            const double xc = __shfl_sync(FULL, v, c) * D[c];
            if (lane == c) v = xc;
            else if (lane > c && lane < w) v -= T[lane * TLD + c] * xc;
        }
        if (lane < w) y[(size_t)n * a + r0 + lane] = v;
        __threadfence();
        __syncwarp();
        if (lane == 0) atomicAdd(sync + 1 + n, 1u);
    }
}

// Backward, the large form: Lf's columns in bands of 32, a block a band,
// from the last band to the first. A band sums its columns of U^T x_B
// (lane = column, warp = a residue of U's rows), then of Lf^T x_A over the
// tiles below its diagonal one as their bands publish them (ready[n] >=
// nbL - k for tile k), folds the eight warps' sums in order, solves its
// transposed diagonal tile with one warp and publishes its 32 unmasked
// entries in xs (ready[n] += 1), writing the masked ones to xA and x.
// Band j's id is (nbL - 1 - j) nk + n, from the ticket.
__global__ void __launch_bounds__(FS_THREADS)
    front_backward_band_kernel(const double* __restrict__ Lf,
                               const double* __restrict__ U,
                               const int64_t* __restrict__ adofs,
                               const int64_t* __restrict__ bdofs,
                               const double* __restrict__ y, double* xv,
                               double* __restrict__ xA, double* xs,
                               unsigned* sync, int nk, int a, int b,
                               int n_J) {
    __shared__ double T[TILE * TLD];
    __shared__ double D[TILE];
    __shared__ double red[FS_WARPS][TILE];
    __shared__ int slot;
    pdl_wait();
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int id = ticket(sync, &slot);
    const int nbL = (a + TILE - 1) / TILE;
    const int jj = id / nk, n = id - jj * nk, j = nbL - 1 - jj;
    const int c0 = TILE * j, w = min(TILE, a - c0);
    const double* Ln = Lf + (size_t)n * a * a;
    const double* Un = U + (size_t)n * b * a;
    const int64_t* bn = bdofs + (size_t)n * b;
    const unsigned* ready = sync + 1 + n;
    stage_tile(Ln, a, c0, w, T, D);
    const int c = c0 + lane;
    double acc = 0.0;
    // x[bdofs] are separator entries of higher levels: no block of this
    // level writes them (it writes x[adofs], and the dump entry stays 0)
#pragma unroll 4
    for (int i = warp; i < b; i += FS_WARPS) {
        const double xb = xv[bn[i]];
        if (lane < w) acc = fma(Un[(size_t)i * a + c], xb, acc);
    }
    unsigned have = 0;
    const double* xn = xs + (size_t)n * a;
    for (int k = nbL - 1; k > j; --k) {
        const int i0 = TILE * k + warp * ROWS;
        double m[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
            m[u] = i0 + u < a && lane < w ? Ln[(size_t)(i0 + u) * a + c] : 0.0;
        const unsigned need = (unsigned)(nbL - k);
        if (need > have) have = wait_ready(ready, need, &slot);
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
            if (i0 + u < a) acc = fma(m[u], __ldcg(xn + i0 + u), acc);
    }
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0) {
        double s = red[0][lane];
#pragma unroll
        for (int g = 1; g < FS_WARPS; ++g) s += red[g][lane];
        double v = lane < w ? y[(size_t)n * a + c] - s : 0.0;
#pragma unroll 8
        for (int q = w - 1; q >= 0; --q) {
            const double xc = __shfl_sync(FULL, v, q) * D[q];
            if (lane == q) v = xc;
            else if (lane < q) v -= T[q * TLD + lane] * xc;
        }
        if (lane < w) {
            xs[(size_t)n * a + c] = v;
            const int64_t d = adofs[(size_t)n * a + c];
            const double vm = d < n_J ? v : 0.0;
            xA[(size_t)n * a + c] = vm;
            xv[d] = vm;
        }
        __threadfence();
        __syncwarp();
        if (lane == 0) atomicAdd(sync + 1 + n, 1u);
    }
}

static int fit_smem(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Forward: reads Lf, U, adofs, rows, inc; updates r in place; writes y and
// upd. form: 1 the one-block form, 2 the large form (the wrapper picks it
// by shape: kernels/front_solve.py:form_of), any other refused; sync: the
// large form's nk + 1 counters, zero.
extern "C" int front_forward_launch(const void* Lf, const void* U,
                                    const void* adofs, const void* rows,
                                    const void* inc, void* r, void* y,
                                    void* upd, void* sync, int nk, int a,
                                    int b, int nr, int Kb, int form,
                                    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (form != 1 && form != 2) return (int)cudaErrorInvalidValue;
    int e = 0;
    if (form == 2) {
        const int nbands = (a + TILE - 1) / TILE + (b + TILE - 1) / TILE;
        if (nk > 0)
            e = (int)launch_pdl(front_forward_band_kernel, dim3(nk * nbands),
                                dim3(FS_THREADS), 0, s, (const double*)Lf,
                                (const double*)U, (const int64_t*)adofs,
                                (const double*)r, (double*)y, (double*)upd,
                                (unsigned*)sync, nk, a, b);
    } else {
        const size_t smem = (size_t)(TILE * TLD + TILE + a) * sizeof(double);
        e = fit_smem((const void*)front_forward_kernel, smem);
        if (!e && nk > 0)
            e = (int)launch_pdl(front_forward_kernel, dim3(nk),
                                dim3(FS_THREADS), smem, s, (const double*)Lf,
                                (const double*)U, (const int64_t*)adofs,
                                (const double*)r, (double*)y, (double*)upd, a,
                                b);
    }
    if (!e && nr > 0)
        e = (int)launch_pdl(front_separator_kernel, dim3((nr + 127) / 128),
                            dim3(128), 0, s, (const double*)upd,
                            (const int64_t*)rows, (const int64_t*)inc,
                            (double*)r, nr, Kb, (int64_t)nk * b);
    return e ? e : (int)cudaGetLastError();
}

// Backward: reads Lf, U, adofs, bdofs, y; updates x at adofs; writes xA.
// form and sync as above; the large form's scratch xs (nk x a doubles, the
// unmasked solution its bands share).
extern "C" int front_backward_launch(const void* Lf, const void* U,
                                     const void* adofs, const void* bdofs,
                                     const void* y, void* x, void* xA,
                                     void* sync, void* xs, int nk, int a,
                                     int b, int n_J, int form, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (form != 1 && form != 2) return (int)cudaErrorInvalidValue;
    int e = 0;
    if (form == 2) {
        if (nk > 0)
            e = (int)launch_pdl(
                front_backward_band_kernel, dim3(nk * ((a + TILE - 1) / TILE)),
                dim3(FS_THREADS), 0, s, (const double*)Lf, (const double*)U,
                (const int64_t*)adofs, (const int64_t*)bdofs, (const double*)y,
                (double*)x, (double*)xA, (double*)xs, (unsigned*)sync, nk, a,
                b, n_J);
        return e ? e : (int)cudaGetLastError();
    }
    const size_t smem = (size_t)(TILE * TLD + TILE + a + b) * sizeof(double);
    e = fit_smem((const void*)front_backward_kernel, smem);
    if (!e && nk > 0)
        e = (int)launch_pdl(front_backward_kernel, dim3(nk), dim3(FS_THREADS),
                            smem, s, (const double*)Lf, (const double*)U,
                            (const int64_t*)adofs, (const int64_t*)bdofs,
                            (const double*)y, (double*)x, (double*)xA, a, b,
                            n_J);
    return e ? e : (int)cudaGetLastError();
}

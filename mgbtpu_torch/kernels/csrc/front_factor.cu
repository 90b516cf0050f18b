// front_factor: batched partial Cholesky of the nested-dissection fronts, f64.
//
// Each front F (f x f, f = a + b, leading dimension ld >= f) holds the
// eliminated block A (a x a), the coupling B (b x a) and the boundary block
// C (b x b):
//   A_s = (A + A^T) / 2,  A_s = Lf Lf^T,  U = B Lf^-T,  S = C - U U^T.
// A front whose A_s is not positive definite (a pivot that is not > 0,
// NaN included) comes back all NaN in Lf, U and S, the reference's
// cholesky semantics.
//
// Replaces the Pallas kernel panel_chol_inv (mgbtpu/ops/pallas_dd.py:446,
// kernel _chol_inv_kernel :386), which factored and inverted the dd front
// panels one (w, w) tile per grid step; the x64 reference runs the same
// fronts through cholesky + triangular_solve + a batched product
// (mgbtpu/ops/ndchol.py:518-522). Hopper has native f64, so the whole
// partial factorization of a front is one block's work.
//
// Bound on an H100: neither bytes nor flops at the nested-dissection front
// sizes (f <= 190 at L=7; a few MFLOP per front), but the serial chain of
// the a eliminated columns. The one-column-at-a-time form this replaces
// spent ~2.3 us a column on block barriers and device-memory round trips.
//
// Design: one block per front, a left-looking factorization in 32-column
// panels. Panel j0 (the A_s rows j0..a-1 and all b rows of B, columns
// j0..j0+31) is staged from F into shared memory with cp.async 16-byte
// copies, symmetrized, and updated by the earlier panels as a tiled
// product over the columns of [Lf; U] already written (read back from L2,
// where this block wrote them). Left-looking keeps the footprint at one
// panel, f x 32 doubles whatever a is; a right-looking form would keep the
// f x f trailing matrix on chip or send it through L2 once per panel. One
// warp factors the diagonal tile in registers, at the width 8, 16 or 32
// that holds it, padded with the identity so that its unrolled steps carry
// no runtime guard (a guard per step serialized the steps' shuffles);
// each step takes its pivot by a shuffle and posts the scaled column in
// shared memory for the lanes below, one __syncwarp and no block barrier a
// step. Each remaining row of the panel (Lf below the tile, then U) is
// solved against the tile by one thread in registers, and the panel is
// written out once. The same panel's U rows, still in shared memory, then
// update S = C - sum over panels of U_J U_J^T, as 32 x 32 tiles of its
// lower triangle, each entry written with its mirror: S is written once
// per panel (once where a <= 32: every fem2d_P2 level but the leaves,
// a = 73, and the L=7 roots, a = 63 and 127) and U is never read back for
// it. Four block barriers a panel, and two a 32-column chunk of the
// update. The products use fma on the plain f64 units; mma.sync (DMMA) is
// not used: at these sizes the chain, not the flops, bounds the kernel.
// The launch bound asks for two blocks an SM (128 registers a thread).
//
// The panel in shared memory is f x 34 doubles: with the rest, a front of
// f > 790 does not fit a block (232,448 bytes). Such a front takes the
// wide form (front_factor_wide_kernel): the same panels in the same order,
// but each panel's rows pass through shared memory RC at a time. The first
// chunk holds the diagonal tile, which is factored into its own buffer
// (T) and serves every later chunk's row solves; each chunk is staged,
// symmetrized, updated by the earlier panels, solved and written out as
// the whole panel is above. S's update then stages the panel's U rows
// back from device memory (L2: just written), 32 rows for a tile's rows
// and 32 for its columns, and runs the same tile products. Every entry is
// computed by the same operations in the same order as in the one-panel
// form, so a front that both forms take comes out with the same bits; the
// wide form takes any f (the L=4 fem3d leaf fronts: f = 855).
#include <cstdint>
#include <cuda_runtime.h>

#include "cpasync.cuh"

#define FF_THREADS 256
#define FF_WARPS (FF_THREADS / 32)
#define TILE 32
#define PS 34     // panel row stride: 32 and the parity shift, kept even
#define TLD 33    // row stride of the 32 x 32 tiles in LT: no bank conflicts
#define WRS 4     // rows a warp takes in a 32 x 32 tile product
#define XS 34     // a warp's staged row stride (even: 16-byte loads)
#define FULL 0xffffffffu
#define RC 256    // the wide form: panel rows a chunk stages

// Row r of the front's stacked factor X = [Lf; U] (both row-major, a wide).
__device__ __forceinline__ const double* xrow(const double* Ln,
                                              const double* Un, int a,
                                              int r) {
    return r < a ? Ln + (size_t)r * a : Un + (size_t)(r - a) * a;
}

// One warp factors the w x w diagonal tile (w <= WT), lane i holding row i
// (prow, its row of the panel) in registers: column k's pivot comes from
// lane k by a shuffle, each lane scales its entry by 1/sqrt(pivot) and
// posts it in col (two buffers in turn, one __syncwarp a step), and the
// lanes below update their rows from the posted column, two entries a
// 16-byte load. Rows and columns past w are the identity, so the steps
// carry no runtime guard. Writes the factor to prow (zeros above the
// diagonal and past w), the tile to T (row-major, TLD, WT x WT with its
// identity padding) and the pivots' reciprocals to D. Returns 1 when a
// pivot is not > 0 (on every lane). The next pivot leaves lane k+1 as soon
// as its own entry is scaled, so the chain from pivot to pivot does not
// wait for the posted column.
template <int WT>
__device__ __forceinline__ int factor_tile(double* prow, int w, int lane,
                                           double* T, double* D,
                                           double* col2) {
    double x[WT];
#pragma unroll
    for (int c = 0; c < WT; ++c)
        x[c] = lane < w ? (c <= lane ? prow[c] : 0.0)
                        : (c == lane ? 1.0 : 0.0);
    int nb = 0;
    double dn = x[0];  // on lane k at step k: the pivot
#pragma unroll
    for (int k = 0; k < WT; ++k) {
        const double d = __shfl_sync(FULL, dn, k);
        nb |= !(d > 0.0);
        const double rinv = rsqrt(d);
        const double l = lane == k ? d * rinv : x[k] * rinv;
        x[k] = l;
        // lane k+1's next pivot from its own entry, ahead of the posted
        // column (the same bits as its update below)
        if (k + 1 < WT) dn = fma(-l, l, x[k + 1]);
        double* col = col2 + (k & 1) * TILE;
        col[lane] = l;
        __syncwarp();
        if (lane == 0) D[k] = rinv;
#pragma unroll
        for (int c = 0; c < WT; c += 2) {  // the pairs past column k
            if (c + 1 <= k) continue;
            const double2 v = *reinterpret_cast<const double2*>(col + c);
            if (c > k && lane >= c) x[c] = fma(-l, v.x, x[c]);
            if (lane > c) x[c + 1] = fma(-l, v.y, x[c + 1]);
        }
    }
    if (lane < w) {
#pragma unroll
        for (int c = 0; c < WT; ++c) prow[c] = x[c];
    }
    if (lane < WT) {
#pragma unroll
        for (int c = 0; c < WT; ++c) T[lane * TLD + c] = x[c];
    }
    return nb;
}

// One row below the tile, y Lt^T = p, in registers by one thread: its
// first w entries (prow) are solved against the tile T; the entries past w
// come out exact zeros (T's identity padding).
template <int WT>
__device__ __forceinline__ void solve_row(double* prow, int w,
                                          const double* T, const double* D) {
    double y[WT];
#pragma unroll
    for (int c = 0; c < WT; ++c) y[c] = c < w ? prow[c] : 0.0;
#pragma unroll
    for (int k = 0; k < WT; ++k) {
        y[k] *= D[k];
#pragma unroll
        for (int c = k + 1; c < WT; ++c)
            y[c] = fma(-y[k], T[c * TLD + k], y[c]);
    }
#pragma unroll
    for (int c = 0; c < WT; ++c) prow[c] = y[c];
}

__global__ void __launch_bounds__(FF_THREADS, 2)
    front_factor_kernel(const double* __restrict__ F, double* Lf, double* U,
                        double* __restrict__ S, int a, int b, int ld) {
    // Lf and U are read back after the block writes them: no __restrict__,
    // so no read goes through the non-coherent path.
    extern __shared__ __align__(16) double sm[];
    const int f = a + b;
    double* P = sm;                        // f x PS: the panel
    double* LT = P + (size_t)f * PS;       // TILE x TLD
    double* XW = LT + TILE * TLD;  // FF_WARPS x WRS x XS; the tile's columns
    double* D = XW + FF_WARPS * WRS * XS;  // 1 / the tile's pivots
    __shared__ int bad;
    const int n = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const double* Fn = F + (size_t)n * ld * ld;
    double* Ln = Lf + (size_t)n * a * a;
    double* Un = U + (size_t)n * b * a;
    double* Sn = S + (size_t)n * b * b;
    const int ldodd = ld & 1, nt = (b + TILE - 1) / TILE;
    if (tid == 0) bad = 0;

    for (int j0 = 0; j0 < a; j0 += TILE) {
        const int w = min(TILE, a - j0), R = f - j0, RA = a - j0;
        // panel row i starts at its source row's parity: 16-byte copies
        const int off0 = odd8(Fn + (size_t)j0 * ld + j0);
#define PIX(i) ((i) * PS + (off0 ^ ((i) & ldodd)))
        const int np = cp_pieces(w, 1);  // the most pieces a row takes
        for (int t = tid; t < R * np; t += FF_THREADS) {
            const int i = t / np, q = t - i * np;
            const int h = off0 ^ (i & ldodd);
            if (q < cp_pieces(w, h))
                cp_piece(P + i * PS + h, Fn + (size_t)(j0 + i) * ld + j0, w,
                         h, q);
        }
        cp_async_wait_all();
        __syncthreads();
        // A_s's lower part: (F[r, c] + F[c, r]) / 2, the F[c, r] by rows
#pragma unroll 4
        for (int t = tid; t < w * RA; t += FF_THREADS) {
            const int c = t / RA, i = t - c * RA;
            if (i >= c) {
                double* x = P + PIX(i) + c;
                *x = (*x + Fn[(size_t)(j0 + c) * ld + j0 + i]) / 2;
            }
        }
        __syncthreads();
        // left-looking update: panel -= X[j0:, :j0] X[j0:j0+w, :j0]^T, 32
        // columns of X at a time: the panel's w rows of them staged
        // transposed (LT), then warp g takes rows 4g.., 4g+32.., lane =
        // panel column, each row group's X rows staged in the warp's XW
        // slice while the next group's are loaded
        for (int k0 = 0; k0 < j0; k0 += TILE) {
            for (int t = tid; t < TILE * TILE; t += FF_THREADS) {
                const int c = t >> 5, k = t & 31;  // lanes along a row
                LT[k * TLD + c] =
                    c < w ? Ln[(size_t)(j0 + c) * a + k0 + k] : 0.0;
            }
            __syncthreads();
            double* xw = XW + warp * WRS * XS;
            double xr[WRS];
#pragma unroll
            for (int u = 0; u < WRS; ++u) {
                const int r = warp * WRS + u;
                xr[u] = r < R ? xrow(Ln, Un, a, j0 + r)[k0 + lane] : 0.0;
            }
            for (int r0 = warp * WRS; r0 < R; r0 += FF_WARPS * WRS) {
#pragma unroll
                for (int u = 0; u < WRS; ++u) xw[u * XS + lane] = xr[u];
                __syncwarp();
#pragma unroll
                for (int u = 0; u < WRS; ++u) {
                    const int r = r0 + FF_WARPS * WRS + u;
                    xr[u] = r < R ? xrow(Ln, Un, a, j0 + r)[k0 + lane] : 0.0;
                }
                double acc[WRS] = {};
#pragma unroll 4
                for (int k = 0; k < TILE; k += 2) {
                    const double b0 = LT[k * TLD + lane];
                    const double b1 = LT[(k + 1) * TLD + lane];
#pragma unroll
                    for (int u = 0; u < WRS; ++u) {
                        const double2 x =
                            *reinterpret_cast<const double2*>(xw + u * XS + k);
                        acc[u] = fma(x.x, b0, acc[u]);
                        acc[u] = fma(x.y, b1, acc[u]);
                    }
                }
#pragma unroll
                for (int u = 0; u < WRS; ++u) {
                    const int i = r0 + u;
                    if (i < R && lane < w) P[PIX(i) + lane] -= acc[u];
                }
                __syncwarp();
            }
            __syncthreads();
        }
        // one warp factors the diagonal tile, at the narrowest width that
        // holds it
        if (warp == 0) {
            double* prow = P + PIX(lane);
            const int nb =
                w <= 8    ? factor_tile<8>(prow, w, lane, LT, D, XW)
                : w <= 16 ? factor_tile<16>(prow, w, lane, LT, D, XW)
                          : factor_tile<32>(prow, w, lane, LT, D, XW);
            if (lane == 0 && nb) bad = 1;
        }
        __syncthreads();
        if (bad) break;  // block-uniform
        // the rows below the tile (Lf's, then U's), a thread a row
        for (int i = w + tid; i < R; i += FF_THREADS) {
            double* prow = P + PIX(i);
            if (w <= 8) solve_row<8>(prow, w, LT, D);
            else if (w <= 16) solve_row<16>(prow, w, LT, D);
            else solve_row<32>(prow, w, LT, D);
        }
        __syncthreads();
        // the panel out, once: Lf rows j0..a-1, then U; zeros right of the
        // tile in its rows (Lf's upper triangle)
        for (int t = tid; t < R * TILE; t += FF_THREADS) {
            const int i = t >> 5, c = t & 31;
            if (c < w) {
                const double v = P[PIX(i) + c];
                if (i < RA) Ln[(size_t)(j0 + i) * a + j0 + c] = v;
                else Un[(size_t)(i - RA) * a + j0 + c] = v;
            }
        }
        const int zw = a - j0 - w;
        for (int t = tid; t < w * zw; t += FF_THREADS) {
            const int i = t / zw, c = t - i * zw;
            Ln[(size_t)(j0 + i) * a + j0 + w + c] = 0.0;
        }
        // S -= U_J U_J^T from this panel's U rows (S = C - U_J U_J^T on the
        // first panel): warp g takes rows WRS*g.. of every 32 x 32 tile of
        // S's lower triangle, lane = column, and writes each entry with its
        // mirror; a thread reads back only entries it wrote itself.
        for (int it = 0; it < nt; ++it) {
            const int r0 = it * TILE + warp * WRS;
            if (r0 >= b) continue;  // warp-uniform
            for (int jt = 0; jt <= it; ++jt) {
                const int c = jt * TILE + lane;
                double base[WRS], mirr[WRS], acc[WRS];
                const double* pr[WRS];
#pragma unroll
                for (int u = 0; u < WRS; ++u) {
                    const int r = r0 + u;
                    const bool on = r < b && c <= r, off = on && c < r;
                    base[u] = !on      ? 0.0
                              : j0 == 0 ? Fn[(size_t)(a + r) * ld + a + c]
                                        : Sn[(size_t)r * b + c];
                    mirr[u] = !off     ? 0.0
                              : j0 == 0 ? Fn[(size_t)(a + c) * ld + a + r]
                                        : Sn[(size_t)c * b + r];
                    acc[u] = 0.0;
                    pr[u] = P + PIX(RA + min(r, b - 1));
                }
                const double* pc = P + PIX(RA + min(c, b - 1));
#pragma unroll 4
                for (int k = 0; k < w; ++k) {
                    const double bc = pc[k];
#pragma unroll
                    for (int u = 0; u < WRS; ++u)
                        acc[u] = fma(pr[u][k], bc, acc[u]);
                }
#pragma unroll
                for (int u = 0; u < WRS; ++u) {
                    const int r = r0 + u;
                    if (r < b && c <= r) {
                        Sn[(size_t)r * b + c] = base[u] - acc[u];
                        if (c < r) Sn[(size_t)c * b + r] = mirr[u] - acc[u];
                    }
                }
            }
        }
        __syncthreads();  // the panel is in L2 for the next one's update
#undef PIX
    }
    if (bad) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        for (int t = tid; t < a * a; t += FF_THREADS) Ln[t] = nan;
        for (int t = tid; t < b * a; t += FF_THREADS) Un[t] = nan;
        for (int t = tid; t < b * b; t += FF_THREADS) Sn[t] = nan;
        return;
    }
}

// The wide form (see the note at the top): one block per front, panels of
// 32 columns as above, each panel's rows RC at a time.
__global__ void __launch_bounds__(FF_THREADS, 2)
    front_factor_wide_kernel(const double* __restrict__ F, double* Lf,
                             double* U, double* __restrict__ S, int a, int b,
                             int ld) {
    extern __shared__ __align__(16) double sm[];
    const int f = a + b;
    double* P = sm;                        // RC x PS: a chunk of the panel
    double* LT = P + (size_t)RC * PS;      // TILE x TLD: the update's rows
    double* T = LT + TILE * TLD;           // TILE x TLD: the factored tile
    double* XW = T + TILE * TLD;  // FF_WARPS x WRS x XS; the tile's columns
    double* D = XW + FF_WARPS * WRS * XS;  // 1 / the tile's pivots
    __shared__ int bad;
    const int n = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const double* Fn = F + (size_t)n * ld * ld;
    double* Ln = Lf + (size_t)n * a * a;
    double* Un = U + (size_t)n * b * a;
    double* Sn = S + (size_t)n * b * b;
    const int ldodd = ld & 1, nt = (b + TILE - 1) / TILE;
    if (tid == 0) bad = 0;

    for (int j0 = 0; j0 < a; j0 += TILE) {
        const int w = min(TILE, a - j0), R = f - j0, RA = a - j0;
        for (int i0 = 0; i0 < R; i0 += RC) {  // panel rows i0 .. i0+nr-1
            const int nr = min(RC, R - i0);
            const int off0 = odd8(Fn + (size_t)(j0 + i0) * ld + j0);
#define PIX(i) ((i) * PS + (off0 ^ ((i) & ldodd)))
            const int np = cp_pieces(w, 1);
            for (int t = tid; t < nr * np; t += FF_THREADS) {
                const int i = t / np, q = t - i * np;
                const int h = off0 ^ (i & ldodd);
                if (q < cp_pieces(w, h))
                    cp_piece(P + i * PS + h,
                             Fn + (size_t)(j0 + i0 + i) * ld + j0, w, h, q);
            }
            cp_async_wait_all();
            __syncthreads();
            // A_s's lower part in the chunk's rows of A
            const int na = min(nr, RA - i0);
#pragma unroll 4
            for (int t = tid; t < w * max(na, 0); t += FF_THREADS) {
                const int c = t / na, i = t - c * na;
                if (i0 + i >= c) {
                    double* x = P + PIX(i) + c;
                    *x = (*x + Fn[(size_t)(j0 + c) * ld + j0 + i0 + i]) / 2;
                }
            }
            __syncthreads();
            for (int k0 = 0; k0 < j0; k0 += TILE) {  // the left-looking update
                for (int t = tid; t < TILE * TILE; t += FF_THREADS) {
                    const int c = t >> 5, k = t & 31;
                    LT[k * TLD + c] =
                        c < w ? Ln[(size_t)(j0 + c) * a + k0 + k] : 0.0;
                }
                __syncthreads();
                double* xw = XW + warp * WRS * XS;
                double xr[WRS];
#pragma unroll
                for (int u = 0; u < WRS; ++u) {
                    const int r = warp * WRS + u;
                    xr[u] = r < nr ? xrow(Ln, Un, a, j0 + i0 + r)[k0 + lane]
                                   : 0.0;
                }
                for (int r0 = warp * WRS; r0 < nr; r0 += FF_WARPS * WRS) {
#pragma unroll
                    for (int u = 0; u < WRS; ++u) xw[u * XS + lane] = xr[u];
                    __syncwarp();
#pragma unroll
                    for (int u = 0; u < WRS; ++u) {
                        const int r = r0 + FF_WARPS * WRS + u;
                        xr[u] = r < nr
                                    ? xrow(Ln, Un, a, j0 + i0 + r)[k0 + lane]
                                    : 0.0;
                    }
                    double acc[WRS] = {};
#pragma unroll 4
                    for (int k = 0; k < TILE; k += 2) {
                        const double b0 = LT[k * TLD + lane];
                        const double b1 = LT[(k + 1) * TLD + lane];
#pragma unroll
                        for (int u = 0; u < WRS; ++u) {
                            const double2 x = *reinterpret_cast<const double2*>(
                                xw + u * XS + k);
                            acc[u] = fma(x.x, b0, acc[u]);
                            acc[u] = fma(x.y, b1, acc[u]);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < WRS; ++u) {
                        const int i = r0 + u;
                        if (i < nr && lane < w) P[PIX(i) + lane] -= acc[u];
                    }
                    __syncwarp();
                }
                __syncthreads();
            }
            if (i0 == 0) {  // the diagonal tile: the chunk's first w rows
                if (warp == 0) {
                    double* prow = P + PIX(lane);
                    const int nb =
                        w <= 8    ? factor_tile<8>(prow, w, lane, T, D, XW)
                        : w <= 16 ? factor_tile<16>(prow, w, lane, T, D, XW)
                                  : factor_tile<32>(prow, w, lane, T, D, XW);
                    if (lane == 0 && nb) bad = 1;
                }
                __syncthreads();
                if (bad) break;  // block-uniform
            }
            for (int i = (i0 == 0 ? w : 0) + tid; i < nr; i += FF_THREADS) {
                double* prow = P + PIX(i);
                if (w <= 8) solve_row<8>(prow, w, T, D);
                else if (w <= 16) solve_row<16>(prow, w, T, D);
                else solve_row<32>(prow, w, T, D);
            }
            __syncthreads();
            for (int t = tid; t < nr * TILE; t += FF_THREADS) {
                const int i = t >> 5, c = t & 31, pi = i0 + i;
                if (c < w) {
                    const double v = P[PIX(i) + c];
                    if (pi < RA) Ln[(size_t)(j0 + pi) * a + j0 + c] = v;
                    else Un[(size_t)(pi - RA) * a + j0 + c] = v;
                }
            }
            if (i0 == 0) {
                const int zw = a - j0 - w;
                for (int t = tid; t < w * zw; t += FF_THREADS) {
                    const int i = t / zw, c = t - i * zw;
                    Ln[(size_t)(j0 + i) * a + j0 + w + c] = 0.0;
                }
            }
            __syncthreads();  // the chunk is out: P is free
#undef PIX
        }
        if (bad) break;
        // S -= U_J U_J^T (S = C - U_J U_J^T on the first panel), as above,
        // from this panel's U rows staged back: UR (tile rows) and UC (tile
        // columns), rows of stride PS
        double* UR = P;
        double* UC = P + TILE * PS;
        for (int it = 0; it < nt; ++it) {
            for (int t = tid; t < TILE * TILE; t += FF_THREADS) {
                const int i = t >> 5, k = t & 31, r = it * TILE + i;
                UR[i * PS + k] =
                    r < b && k < w ? Un[(size_t)r * a + j0 + k] : 0.0;
            }
            const int r0 = it * TILE + warp * WRS;
            for (int jt = 0; jt <= it; ++jt) {
                for (int t = tid; t < TILE * TILE; t += FF_THREADS) {
                    const int i = t >> 5, k = t & 31, r = jt * TILE + i;
                    UC[i * PS + k] =
                        r < b && k < w ? Un[(size_t)r * a + j0 + k] : 0.0;
                }
                __syncthreads();
                if (r0 < b) {  // warp-uniform
                    const int c = jt * TILE + lane;
                    double base[WRS], mirr[WRS], acc[WRS];
                    const double* pr[WRS];
#pragma unroll
                    for (int u = 0; u < WRS; ++u) {
                        const int r = r0 + u;
                        const bool on = r < b && c <= r, off = on && c < r;
                        base[u] = !on      ? 0.0
                                  : j0 == 0 ? Fn[(size_t)(a + r) * ld + a + c]
                                            : Sn[(size_t)r * b + c];
                        mirr[u] = !off     ? 0.0
                                  : j0 == 0 ? Fn[(size_t)(a + c) * ld + a + r]
                                            : Sn[(size_t)c * b + r];
                        acc[u] = 0.0;
                        pr[u] = UR + (warp * WRS + u) * PS;
                    }
                    const double* pc = UC + lane * PS;
#pragma unroll 4
                    for (int k = 0; k < w; ++k) {
                        const double bc = pc[k];
#pragma unroll
                        for (int u = 0; u < WRS; ++u)
                            acc[u] = fma(pr[u][k], bc, acc[u]);
                    }
#pragma unroll
                    for (int u = 0; u < WRS; ++u) {
                        const int r = r0 + u;
                        if (r < b && c <= r) {
                            Sn[(size_t)r * b + c] = base[u] - acc[u];
                            if (c < r)
                                Sn[(size_t)c * b + r] = mirr[u] - acc[u];
                        }
                    }
                }
                __syncthreads();  // UC (and, after the last jt, UR) free
            }
        }
        __syncthreads();  // the panel is in L2 for the next one's update
    }
    if (bad) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        for (int t = tid; t < a * a; t += FF_THREADS) Ln[t] = nan;
        for (int t = tid; t < b * a; t += FF_THREADS) Un[t] = nan;
        for (int t = tid; t < b * b; t += FF_THREADS) Sn[t] = nan;
    }
}

static int fit_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// form: 0 by shape (the one-panel form where the front fits it), 1 the
// one-panel form, 2 the wide form; the one-panel form refuses a front it
// cannot take (cudaErrorInvalidValue).
extern "C" int front_factor_launch(const void* F, void* Lf, void* U, void* S,
                                   int nk, int a, int b, int ld, int form,
                                   void* stream) {
    if (form < 0 || form > 2) return (int)cudaErrorInvalidValue;
    const size_t tail = TILE * TLD + FF_WARPS * WRS * XS + TILE;
    const size_t smem = ((size_t)(a + b) * PS + tail) * sizeof(double);
    const bool fits = smem <= 232448;
    if (form == 1 && !fits) return (int)cudaErrorInvalidValue;
    if (form == 2 || !fits) {
        const size_t wide =
            ((size_t)RC * PS + TILE * TLD + tail) * sizeof(double);
        int e = fit_smem((const void*)front_factor_wide_kernel, wide);
        if (e) return e;
        if (nk > 0)
            front_factor_wide_kernel<<<nk, FF_THREADS, wide,
                                       (cudaStream_t)stream>>>(
                (const double*)F, (double*)Lf, (double*)U, (double*)S, a, b,
                ld);
        return (int)cudaGetLastError();
    }
    int e = fit_smem((const void*)front_factor_kernel, smem);
    if (e) return e;
    if (nk > 0) {
        front_factor_kernel<<<nk, FF_THREADS, smem, (cudaStream_t)stream>>>(
            (const double*)F, (double*)Lf, (double*)U, (double*)S, a, b, ld);
    }
    return (int)cudaGetLastError();
}

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
// f > 790 does not fit a block (232,448 bytes); such fronts, and every
// front of f >= 320, take the large form.
//
// One block a front leaves the card idle on the fem3d Q3 plans: few fronts
// of large a and b a level (the L=5 plan's upper levels hold 1-32 fronts
// of f = 1,394 .. 3,290, up to 8 GFLOP a front, on as many SMs as fronts).
// There the bound is the operations of every front of the level spread over
// the whole card, and the chain of panels. Fronts of f >= 320 (every fem3d
// front; no fem2d front, whose f <= 190) take the large form (below): the
// level's fronts over every block, in 64-column panels, each phase a
// kernel launched as a programmatic dependent; the products on the f64
// tensor cores (mma.sync m16n8k16). It sums in another order than the
// forms above (held to them by tolerance, not bits).
#include <cstdint>
#include <cuda_runtime.h>

#include "cpasync.cuh"
#include "pdl.cuh"

#define FF_THREADS 256
#define FF_WARPS (FF_THREADS / 32)
#define TILE 32
#define PS 34     // panel row stride: 32 and the parity shift, kept even
#define TLD 33    // row stride of the 32 x 32 tiles in LT: no bank conflicts
#define WRS 4     // rows a warp takes in a 32 x 32 tile product
#define XS 34     // a warp's staged row stride (even: 16-byte loads)
#define FULL 0xffffffffu

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

// ---------------------------------------------------------------------------
// The large form: one front over many blocks (see the note at the top).
// ---------------------------------------------------------------------------
#define LB 64     // panel width and tile edge
#define LS 68     // row stride of a staged 64-wide tile: 4 mod 16 doubles, so
                  // an MMA fragment load (8 rows x 4 columns a half warp)
                  // hits 16 distinct bank pairs
#define RS 65     // row stride of the panel solve's rows (odd: a thread a row)
#define LROWS FF_THREADS   // panel rows a block solves, a thread a row

// D += A B on the f64 tensor cores, Hopper's m16n8k16 shape: with g = lane
// / 4 and t = lane % 4, lane holds A[g + 8 (v % 2)][t + 4 (v / 2)] (v < 8),
// B[t + 4 v][g] (v < 4) and D[g + 8 (v / 2)][2 t + v % 2] (v < 4).
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       const double (&b)[4]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "{%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The working matrix W (f x f, lower) of a front in its outputs: W[r][c],
// c <= r, is Lf's entry for r < a, U's for c < a <= r, S's for a <= c.
__device__ __forceinline__ double* wat(double* Ln, double* Un, double* Sn,
                                       int a, int b, int r, int c) {
    return c < a ? (r < a ? Ln + (size_t)r * a + c
                          : Un + (size_t)(r - a) * a + c)
                 : Sn + (size_t)(r - a) * b + (c - a);
}

// The lower tile (I, J), I >= J, of a triangle numbered row by row.
__device__ __forceinline__ void tri_tile(int u, int& I, int& J) {
    I = (int)((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
    while ((I + 1) * (I + 2) / 2 <= u) ++I;
    while (I * (I + 1) / 2 > u) --I;
    J = u - I * (I + 1) / 2;
}

// One row's 32 entries y (y L^T = p against a factored 32 x 32 tile T in
// LT layout with the pivots' reciprocals D), as solve_row does.
__device__ __forceinline__ void solve32(double (&y)[TILE], const double* T,
                                        const double* D) {
#pragma unroll
    for (int k = 0; k < TILE; ++k) {
        y[k] *= D[k];
#pragma unroll
        for (int c = k + 1; c < TILE; ++c)
            y[c] = fma(-y[k], T[c * TLD + k], y[c]);
    }
}

// The large form: a left-looking partial Cholesky in 64-column panels, all
// fronts of a tree level at once, each phase a kernel over every block it
// can fill, launched in turn by the C entry as programmatic dependents
// (pdl.cuh: each waits for the one before):
//   init    W = [sym(A), B] into Lf, U (Lf's upper triangle zero), a 64 x
//           64 tile of F a block (A's transpose staged in shared memory);
//           the first block of a front clears its flag;
//   per panel j0 (w = min(64, a - j0) columns):
//     gemm  the panel's rows j0 .. f-1 less their products with the
//           earlier panels, W[r][J] -= X[r][:j0] X[J][:j0]^T: a 64 x w
//           tile a block on the f64 tensor cores (mma.sync m16n8k16, which
//           runs at twice m8n8k4's rate on an H100), the j0 columns in
//           32-column chunks staged in shared memory by cp.async, two
//           stages, three blocks an SM;
//     diag  a block a front factors the diagonal tile (two 32-column
//           halves, a warp each: factor_tile; the second half's rows
//           solved and updated between them) and writes it to Lf; a pivot
//           that is not > 0 marks the front bad (a flag in device memory
//           that every later kernel reads);
//     panel the panel's rows below the tile (the rest of Lf's, then U's),
//           256 rows a block, a thread a row, solved against the tile in
//           registers (two 32-column halves, as in the forms above);
//   gemm    S = C - U U^T, a lower 64 x 64 tile of S a block, over all a
//           columns, C read from F; the tile's products also give its
//           mirror tile in S's upper triangle, from C's own upper entries
//           (C need not be symmetric: S = C - U U^T entry by entry, as in
//           the forms above).
// A level of one front takes the right-looking order instead: after each
// panel, gemm takes the panel's product off the trailing lower triangle
// (S included, both its triangles: init copies the whole of C there), a 64
// x 64 tile a block, and no gemm runs before a panel or for S: it spreads
// each panel's work over the card, where left-looking would leave a few
// long tiles a panel.
//   final   a block a front: a bad front all NaN.
// Left-looking writes each entry of [Lf; U] and S once and reads the
// earlier panels once a panel; a right-looking order reads and writes the
// whole trailing matrix once a panel, which bounded it by device memory on
// the levels of many fronts. Every sum runs in a fixed order (no atomics
// in any sum), so a repeat call gives the same bits. bad: nk flags, cleared
// by init (a kernel, so the chain has no memset in it).

__global__ void __launch_bounds__(FF_THREADS)
    ff_init_kernel(const double* __restrict__ F, double* Lf, double* U,
                   double* S, unsigned* bad, int a, int b, int ld,
                   int right) {
    __shared__ double Q[LB * (LB + 1)];  // A's transposed tile
    pdl_wait();
    pdl_trigger();
    const int f = a + b, nT = (f + LB - 1) / LB, tid = threadIdx.x;
    const int n = blockIdx.x / (nT * nT), u = blockIdx.x % (nT * nT);
    const int I = u / nT, J = u % nT, r0 = I * LB, c0 = J * LB;
    const double* Fn = F + (size_t)n * ld * ld;
    double* Ln = Lf + (size_t)n * a * a;
    double* Un = U + (size_t)n * b * a;
    double* Sn = S + (size_t)n * b * b;
    if (u == 0 && tid == 0) bad[n] = 0u;
    if (I >= J && r0 < a && c0 < a) {  // a tile of A's lower triangle
        for (int t = tid; t < LB * LB; t += FF_THREADS) {
            const int i = t >> 6, k = t & 63;  // Q[i][k] = F[c0 + i][r0 + k]
            Q[i * (LB + 1) + k] = c0 + i < f && r0 + k < f
                                      ? Fn[(size_t)(c0 + i) * ld + r0 + k]
                                      : 0.0;
        }
        __syncthreads();
    }
    for (int t = tid; t < LB * LB; t += FF_THREADS) {
        const int i = t >> 6, k = t & 63, r = r0 + i, c = c0 + k;
        if (r >= f || c >= f) continue;
        if (r < a) {
            if (c < a)
                Ln[(size_t)r * a + c] =
                    c <= r ? (Fn[(size_t)r * ld + c] + Q[k * (LB + 1) + i]) / 2
                           : 0.0;
        } else if (c < a) {
            Un[(size_t)(r - a) * a + c] = Fn[(size_t)r * ld + c];
        } else if (right) {  // C, whole: the right-looking GEMMs update it
            Sn[(size_t)(r - a) * b + c - a] = Fn[(size_t)r * ld + c];
        }
    }
}

__global__ void __launch_bounds__(FF_THREADS)
    ff_diag_kernel(double* Lf, unsigned* bad, int a, int j0) {
    // the second half's factor_tile reuses T1 and D1 for its LT copy and
    // pivots, which nothing reads after it (48 KB of static shared memory)
    __shared__ __align__(16) double T[LB * LS];
    __shared__ __align__(16) double T1[TILE * TLD];
    __shared__ __align__(16) double col2[2 * TILE];
    __shared__ double D1[TILE];
    __shared__ int nb;
    pdl_wait();
    pdl_trigger();
    const int n = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    if (bad[n]) return;  // block-uniform
    const int w = min(LB, a - j0), w1 = min(TILE, w), w2 = w - w1;
    double* Ln = Lf + (size_t)n * a * a;
    if (tid == 0) nb = 0;
    for (int t = tid; t < LB * LB; t += FF_THREADS) {
        const int i = t >> 6, k = t & 63;
        T[i * LS + k] = i < w && k < w
                            ? (k <= i ? Ln[(size_t)(j0 + i) * a + j0 + k] : 0.0)
                            : (i == k ? 1.0 : 0.0);
    }
    __syncthreads();
    if (warp == 0) {
        const int e = factor_tile<TILE>(T + lane * LS, w1, lane, T1, D1, col2);
        if (lane == 0 && e) nb = 1;
    }
    __syncthreads();
    if (w2 > 0) {
        if (tid < TILE) solve_row<TILE>(T + (TILE + tid) * LS, TILE, T1, D1);
        __syncthreads();
        for (int t = tid; t < TILE * TILE; t += FF_THREADS) {
            const int r = TILE + (t >> 5), c = TILE + (t & 31);
            if (c > r) continue;
            double s = 0.0;
#pragma unroll 8
            for (int k = 0; k < TILE; ++k)
                s = fma(T[r * LS + k], T[c * LS + k], s);
            T[r * LS + c] -= s;
        }
        __syncthreads();
        if (warp == 0) {
            const int e = factor_tile<TILE>(T + (TILE + lane) * LS + TILE, w2,
                                            lane, T1, D1, col2);
            if (lane == 0 && e) nb = 1;
        }
        __syncthreads();
    }
    if (nb) {
        if (tid == 0) bad[n] = 1u;
        return;
    }
    for (int t = tid; t < w * LB; t += FF_THREADS) {
        const int i = t >> 6, k = t & 63;
        if (k <= i) Ln[(size_t)(j0 + i) * a + j0 + k] = T[i * LS + k];
    }
}

__global__ void __launch_bounds__(LROWS, 1)
    ff_panel_kernel(double* Lf, double* U, const unsigned* bad, int a,
                    int b, int j0) {
    extern __shared__ __align__(16) double sm[];
    double* R = sm;                        // LROWS x RS
    double* T1 = R + LROWS * RS;           // TILE x TLD
    double* T2 = T1 + TILE * TLD;
    double* L21 = T2 + TILE * TLD;         // TILE x TLD: [k][c]
    double* D1 = L21 + TILE * TLD;
    double* D2 = D1 + TILE;
    pdl_wait();
    pdl_trigger();
    const int f = a + b, w = min(LB, a - j0), c0 = j0 + w, tid = threadIdx.x;
    const int nr = (f - c0 + LROWS - 1) / LROWS;
    const int n = blockIdx.x / nr, r0 = c0 + (blockIdx.x % nr) * LROWS;
    if (bad[n]) return;
    double* Ln = Lf + (size_t)n * a * a;
    double* Un = U + (size_t)n * b * a;
    for (int t = tid; t < LB * LB; t += LROWS) {  // the tile, LT layout
        const int i = t >> 6, k = t & 63;
        const double v = i < w && k <= i ? Ln[(size_t)(j0 + i) * a + j0 + k]
                                         : (i == k ? 1.0 : 0.0);
        if (i < TILE && k < TILE) {
            T1[i * TLD + k] = v;
            if (i == k) D1[i] = 1.0 / v;
        } else if (i >= TILE && k >= TILE) {
            T2[(i - TILE) * TLD + k - TILE] = v;
            if (i == k) D2[i - TILE] = 1.0 / v;
        } else if (i >= TILE) {
            L21[k * TLD + i - TILE] = v;
        }
    }
    for (int t = tid; t < LROWS * LB; t += LROWS) {
        const int i = t >> 6, k = t & 63, r = r0 + i;
        R[i * RS + k] = r < f && k < w ? xrow(Ln, Un, a, r)[j0 + k] : 0.0;
    }
    __syncthreads();
    {
        double* row = R + tid * RS;
        double y[TILE], z[TILE];
#pragma unroll
        for (int c = 0; c < TILE; ++c) y[c] = row[c];
        solve32(y, T1, D1);
        if (w > TILE) {
#pragma unroll
            for (int c = 0; c < TILE; ++c) z[c] = row[TILE + c];
#pragma unroll
            for (int k = 0; k < TILE; ++k) {
                const double yk = y[k];
#pragma unroll
                for (int c = 0; c < TILE; ++c)
                    z[c] = fma(-yk, L21[k * TLD + c], z[c]);
            }
            solve32(z, T2, D2);
#pragma unroll
            for (int c = 0; c < TILE; ++c) row[TILE + c] = z[c];
        }
#pragma unroll
        for (int c = 0; c < TILE; ++c) row[c] = y[c];
    }
    __syncthreads();
    for (int t = tid; t < LROWS * LB; t += LROWS) {
        const int i = t >> 6, k = t & 63, r = r0 + i;
        if (r < f && k < w)
            *wat(Ln, Un, nullptr, a, b, r, j0 + k) = R[i * RS + k];
    }
}

#define KC 32     // the GEMM's k chunk
#define KS 36     // its row stride: 4 mod 16 doubles, as LS

// X[rows p0 .. p0+63, columns k0 .. k0+KC-1] of [Lf; U] into a LB x KS
// tile with cp.async (zero past f and past K); the caller commits.
__device__ __forceinline__ void stage_k(double* T, const double* Ln,
                                        const double* Un, int a, int f,
                                        int p0, int k0, int K) {
    for (int t = threadIdx.x; t < LB * KC; t += FF_THREADS) {
        const int i = t / KC, k = t % KC, r = p0 + i;
        double* d = T + i * KS + k;
        if (r < f && k0 + k < K) cp_async8(d, xrow(Ln, Un, a, r) + k0 + k);
        else *d = 0.0;
    }
}

// W[r][c] -= sum over k0 <= k < K of X[r][k] X[c][k] on a 64 x 64 tile,
// the sum on the f64 tensor cores in KC-column chunks of X staged in shared
// memory by cp.async, the next chunk's copies in flight while the current
// one's products run (three blocks an SM). mode 0, the panel j0
// (left-looking): rows j0 + 64 (block % per) .., columns j0 .. j0+w-1, k <
// j0 (the earlier panels); mode 1, S: the lower tile (I, J) of rows and
// columns a .., k < a (every panel); mode 2, the trailing triangle after
// the panel j0 (right-looking): its lower tile (I, J) of rows and columns
// j0 + w .., j0 <= k < j0 + w (the panel). Entries with c <= r are
// written, and S's (c, r) with each of S's (r, c), c < r: in mode 1 as C's
// entry less the product (C read from F), in mode 2 as the entry less it.
__global__ void __launch_bounds__(FF_THREADS, 3)
    ff_gemm_kernel(const double* __restrict__ F, double* Lf, double* U,
                   double* S, const unsigned* bad, int a, int b, int ld,
                   int j0, int mode) {
    extern __shared__ __align__(16) double sm[];  // 2 stages x (P, Q)
    pdl_wait();
    pdl_trigger();
    const int f = a + b;
    int n, p0, q0, kb = 0, K, cend = f;
    if (mode == 0) {
        const int per = (f - j0 + LB - 1) / LB;
        n = blockIdx.x / per;
        p0 = j0 + (blockIdx.x % per) * LB;
        q0 = j0;
        K = j0;
        cend = j0 + min(LB, a - j0);
    } else {
        const int base = mode == 1 ? a : j0 + min(LB, a - j0);
        const int t2 = (f - base + LB - 1) / LB, per = t2 * (t2 + 1) / 2;
        int I, J;
        n = blockIdx.x / per;
        tri_tile(blockIdx.x % per, I, J);
        p0 = base + I * LB;
        q0 = base + J * LB;
        kb = mode == 1 ? 0 : j0;
        K = mode == 1 ? a : base;
    }
    if (bad[n]) return;
    double* Ln = Lf + (size_t)n * a * a;
    double* Un = U + (size_t)n * b * a;
    double* Sn = S + (size_t)n * b * b;
    const double* Fn = F + (size_t)n * ld * ld;
    // warp: rows 16 (warp / 2) .. +15, columns 32 (warp % 2) .. +31 (four
    // n8 tiles); k in steps of 16
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const bool same = p0 == q0;
    const int pw = (16 * (warp >> 1) + g) * KS + t4;
    const int qw = (32 * (warp & 1) + g) * KS + t4;
    const int nch = (K - kb + KC - 1) / KC;
    double acc[4][4] = {};
    for (int c = 0; c <= nch; ++c) {
        if (c < nch) {  // chunk c's copies, into stage c % 2
            double* P = sm + (c & 1) * 2 * LB * KS;
            stage_k(P, Ln, Un, a, f, p0, kb + c * KC, K);
            if (!same) stage_k(P + LB * KS, Ln, Un, a, f, q0, kb + c * KC, K);
            cp_async_commit();
        }
        if (c == 0) continue;
        // chunk c - 1: its copies done (the newest group may still fly)
        if (c < nch) cp_async_wait_group<1>();
        else cp_async_wait_group<0>();
        __syncthreads();
        const double* P = sm + ((c - 1) & 1) * 2 * LB * KS;
        const double* Pw = P + pw;
        const double* Qw = (same ? P : P + LB * KS) + qw;
        const int kk = (min(KC, K - kb - (c - 1) * KC) + 15) & ~15;
        for (int k = 0; k < kk; k += 16) {
            double af[8];
#pragma unroll
            for (int v = 0; v < 8; ++v)
                af[v] = Pw[(v & 1) * 8 * KS + k + 4 * (v >> 1)];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                double bf[4];
#pragma unroll
                for (int v = 0; v < 4; ++v) bf[v] = Qw[ni * 8 * KS + k + 4 * v];
                dmma16(acc[ni], af, bf);
            }
        }
        __syncthreads();  // stage (c - 1) % 2 is free for chunk c + 1
    }
#pragma unroll
    for (int v2 = 0; v2 < 2; ++v2) {
        const int r = p0 + 16 * (warp >> 1) + g + 8 * v2;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = q0 + 32 * (warp & 1) + 8 * ni + 2 * t4 + e;
                if (r >= f || c >= cend || c > r) continue;
                const double v = acc[ni][2 * v2 + e];
                if (c < a) {  // Lf or U
                    *wat(Ln, Un, Sn, a, b, r, c) -= v;
                    continue;
                }
                double* lo = Sn + (size_t)(r - a) * b + (c - a);
                double* up = Sn + (size_t)(c - a) * b + (r - a);
                if (mode == 1) {
                    *lo = Fn[(size_t)r * ld + c] - v;
                    if (c < r) *up = Fn[(size_t)c * ld + r] - v;
                } else {
                    *lo -= v;
                    if (c < r) *up -= v;
                }
            }
    }
}

__global__ void __launch_bounds__(FF_THREADS)
    ff_final_kernel(double* Lf, double* U, double* S, const unsigned* bad,
                    int a, int b) {
    pdl_wait();
    pdl_trigger();
    const int n = blockIdx.x, tid = threadIdx.x;
    if (!bad[n]) return;
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    double* Ln = Lf + (size_t)n * a * a;
    double* Un = U + (size_t)n * b * a;
    double* Sn = S + (size_t)n * b * b;
    for (int t = tid; t < a * a; t += FF_THREADS) Ln[t] = nan;
    for (int t = tid; t < b * a; t += FF_THREADS) Un[t] = nan;
    for (int t = tid; t < b * b; t += FF_THREADS) Sn[t] = nan;
}

static int fit_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static int large_launch(const double* F, double* Lf, double* U, double* S,
                        unsigned* bad, int nk, int a, int b, int ld,
                        cudaStream_t s) {
    const int f = a + b, nT = (f + LB - 1) / LB;
    const size_t smem_p =
        (LROWS * RS + 3 * TILE * TLD + 2 * TILE) * sizeof(double);
    const size_t smem_g = 4 * LB * KS * sizeof(double);
    int e = fit_smem((const void*)ff_panel_kernel, smem_p);
    if (!e) e = fit_smem((const void*)ff_gemm_kernel, smem_g);
    // one front: right-looking (each panel's product at once over the
    // trailing triangle, which spreads the level's few, long chains of
    // left-looking tiles over the card); else left-looking
    const bool right = nk == 1;
    if (!e)
        e = (int)launch_pdl(ff_init_kernel, dim3(nk * nT * nT),
                            dim3(FF_THREADS), 0, s, F, Lf, U, S, bad, a, b,
                            ld, (int)right);
    for (int j0 = 0; !e && j0 < a; j0 += LB) {
        const int c0 = j0 + min(LB, a - j0);
        if (j0 > 0 && !right)
            e = (int)launch_pdl(ff_gemm_kernel,
                                dim3(nk * ((f - j0 + LB - 1) / LB)),
                                dim3(FF_THREADS), smem_g, s, F, Lf, U, S,
                                (const unsigned*)bad, a, b, ld, j0, 0);
        if (!e)
            e = (int)launch_pdl(ff_diag_kernel, dim3(nk), dim3(FF_THREADS), 0,
                                s, Lf, bad, a, j0);
        if (!e && c0 < f)
            e = (int)launch_pdl(ff_panel_kernel,
                                dim3(nk * ((f - c0 + LROWS - 1) / LROWS)),
                                dim3(LROWS), smem_p, s, Lf, U,
                                (const unsigned*)bad, a, b, j0);
        if (!e && c0 < f && right) {
            const int t2 = (f - c0 + LB - 1) / LB;
            e = (int)launch_pdl(ff_gemm_kernel, dim3(nk * (t2 * (t2 + 1) / 2)),
                                dim3(FF_THREADS), smem_g, s, F, Lf, U, S,
                                (const unsigned*)bad, a, b, ld, j0, 2);
        }
    }
    const int nS = (b + LB - 1) / LB, per = nS * (nS + 1) / 2;
    if (!e && b > 0 && !right)
        e = (int)launch_pdl(ff_gemm_kernel, dim3(nk * per), dim3(FF_THREADS),
                            smem_g, s, F, Lf, U, S, (const unsigned*)bad, a,
                            b, ld, 0, 1);
    if (!e)
        e = (int)launch_pdl(ff_final_kernel, dim3(nk), dim3(FF_THREADS), 0, s,
                            Lf, U, S, (const unsigned*)bad, a, b);
    return e;
}

// form: 1 the one-panel form, 2 the large form (the wrapper picks it by
// shape: kernels/front_factor.py:form_of); the one-panel form refuses a
// front it cannot take, and any other form is refused
// (cudaErrorInvalidValue). sync: nk unsigned of scratch (the large form's
// bad flags; cleared by its first kernel).
extern "C" int front_factor_launch(const void* F, void* Lf, void* U, void* S,
                                   void* sync, int nk, int a, int b, int ld,
                                   int form, void* stream) {
    if (form != 1 && form != 2) return (int)cudaErrorInvalidValue;
    if (form == 2) {
        if (nk <= 0) return (int)cudaGetLastError();
        const int e = large_launch((const double*)F, (double*)Lf, (double*)U,
                                   (double*)S, (unsigned*)sync, nk, a, b, ld,
                                   (cudaStream_t)stream);
        return e ? e : (int)cudaGetLastError();
    }
    const size_t tail = TILE * TLD + FF_WARPS * WRS * XS + TILE;
    const size_t smem = ((size_t)(a + b) * PS + tail) * sizeof(double);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    int e = fit_smem((const void*)front_factor_kernel, smem);
    if (e) return e;
    if (nk > 0) {
        front_factor_kernel<<<nk, FF_THREADS, smem, (cudaStream_t)stream>>>(
            (const double*)F, (double*)Lf, (double*)U, (double*)S, a, b, ld);
    }
    return (int)cudaGetLastError();
}

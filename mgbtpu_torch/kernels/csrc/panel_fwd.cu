// panel_fwd: forward panel product with the gather fused in, f64.
//
//   out[e*p + q, k] = dz0[e*p + q, k] + sum_c panels[k, e, q, c] * s[cols[e, c]]
//
// Replaces the Pallas kernel fwd_dd (mgbtpu/ops/pallas_dd.py:186), which
// computed the same product in double-float from a gathered (C, N) slab
// that XLA built beforehand; here the s[cols] gather happens in the kernel.
//
// A block takes a group of E consecutive elements (E*p*nD ~ 128 threads).
// It stages, in shared memory, each k's panel slab of the group (E*p*C
// doubles, contiguous in the (nD, N, p, C) layout) with 16-byte cp.async
// copies, and the gathered s[cols[e, :]] once per element (not once per
// node). Then one thread per (element, node, k) output sums its C products
// from shared memory, and the (N*p, nD) output is written with k fastest
// across threads, so the loads and the stores are coalesced. Each sum runs
// in the order of the kernel this one replaced (acc = 0.0, then
// acc + panel * s for c = 0 .. C-1, each product and sum rounded apart
// under --fmad=false, then dz0 + acc), so the outputs keep its bits.
// Bound on an H100: bytes (panels are read once, 8 bytes per 2 flops); at
// fem2d_P2 L=5 the ~2 MB it moves sit in L2 and the call is launch-bound.
//
// That element-group form needs one element's nD slabs in shared memory at
// once, nD*p*C doubles: 328,784 bytes at the fem3d Q3 top level (p = 64,
// nD = 5, C = 128), past the 232,448 a block can have. For such an element
// the wide form (panel_fwd_wide_kernel) takes one element a block, one
// thread per output (p*nD <= 1024), and stages CC columns of all its panel
// rows at a time (panel_chunk.cuh), within WIDE_BUDGET bytes so that two
// blocks share an SM; each thread carries its sum from chunk to chunk, so
// each output is the same left fold over c = 0 .. C-1 and the same bits as
// the element-group form gives where both apply.
//
// Both forms run an element on one block, so a level of few elements with
// many rows leaves the card idle: the spectral levels are one element of
// p = n (1D) or n^2 (2D) nodes, p*nD from 384 to 9,216 rows past the
// 1,024 threads a block may have (spectral2d n = 32: 4 x 1,024 rows of
// C = 1,924). The spread form (panel_fwd_spread_kernel) splits an
// element's rows over blocks of SPREAD_ROWS: N * ceil(p*nD / 32) blocks,
// 128 at spectral2d n = 32. A call of few elements is a dense GEMV over
// the (nD*p, C) view, bound by bytes (63.0 MB, 18.8 us at 3.35 TB/s,
// there); but each output is still the left fold over c = 0 .. C-1 of one
// thread, the same bits as the other forms give, so its critical path is
// C dependent steps on one warp an SM. A block's warp 0 therefore only
// sums, one lane a row, from shared memory; its other warps stage the
// rows (panel_chunk.cuh's layout) SPREAD_STAGES chunks ahead.
// The C entry takes the spread form for p*nD > 1,024 and for levels of
// fewer than SPREAD_MAX_N elements of at least SPREAD_MIN_ROWS rows, the
// element-group form where one element fits it, the wide form otherwise;
// or any form on request, for the card tests. Every fem level the card
// runs keeps its form: fem2d_P2, fem2d_P1 and fem3d have 32 elements or
// more, the fem1d golden mesh 2 elements of 6 rows.
#include <cstdint>
#include <cuda_runtime.h>

#include "cpasync.cuh"
#include "panel_chunk.cuh"

#define THREADS_TARGET 128
#define SMEM_DEFAULT (48 * 1024)
#define SMEM_MAX (227 * 1024)
#define WIDE_BUDGET (112 * 1024)
#define SPREAD_ROWS 32      // spread form: rows a block (its summing warp)
#define SPREAD_WARPS 8      // ... and its warps: one sums, the others stage
#define SPREAD_STAGES 3     // ... and its chunks in flight
#define SPREAD_MAX_N 8      // by shape: levels of fewer elements ...
#define SPREAD_MIN_ROWS 128 // ... with at least this many rows an element

// doubles a k's slab takes in shared memory: room for the parity shift,
// rounded up to an even count so that every slab starts 16-byte aligned
__host__ __device__ __forceinline__ int slab_stride(int E, int p, int C) {
    return (E * p * C + 2) & ~1;
}

__global__ void __launch_bounds__(1024)
panel_fwd_kernel(const double* __restrict__ panels,
                 const int64_t* __restrict__ cols,
                 const double* __restrict__ s,
                 const double* __restrict__ dz0, double* __restrict__ out,
                 int nD, int N, int p, int C, int E) {
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, nt = blockDim.x;
    const int e0 = blockIdx.x * E;
    const int ne = min(E, N - e0);
    const int pc = p * C;
    const int ks = slab_stride(E, p, C);
    const size_t kstride = (size_t)N * pc;
    const double* src0 = panels + (size_t)e0 * pc;
    for (int k = 0; k < nD; ++k) {
        const double* src = src0 + k * kstride;
        cp_run(sh + k * ks + odd8(src), src, ne * pc, t, nt);
    }
    double* sv = sh + nD * ks;                   // s[cols[e, :]], E x C
    const int64_t* ce = cols + (size_t)e0 * C;
    for (int i = t; i < ne * C; i += nt) sv[i] = s[ce[i]];

    const int r = t / nD, k = t - r * nD;        // row e*p + q of the group
    const bool live = r < ne * p;
    const size_t o = (size_t)e0 * p * nD + t;
    const double d = (live && dz0) ? dz0[o] : 0.0;
    cp_async_wait_all();
    __syncthreads();
    if (!live) return;
    const double* src = src0 + k * kstride;
    const double* pk = sh + k * ks + odd8(src) + r * C;
    const double* se = sv + (r / p) * C;
    double acc = 0.0;
#pragma unroll 4
    for (int c = 0; c < C; ++c) acc = acc + pk[c] * se[c];
    out[o] = dz0 ? d + acc : acc;
}

// The wide form: block e takes element e, thread t its output (e*p + q,
// k), t = q*nD + k; its panel row is chunk row t.
__global__ void __launch_bounds__(1024)
panel_fwd_wide_kernel(const double* __restrict__ panels,
                      const int64_t* __restrict__ cols,
                      const double* __restrict__ s,
                      const double* __restrict__ dz0,
                      double* __restrict__ out, int nD, int N, int p, int C,
                      int CC) {
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, nt = blockDim.x;  // nt = p*nD
    const int e = blockIdx.x, ld = CC + 2;
    const size_t kstride = (size_t)N * p * C;
    const double* pe = panels + (size_t)e * p * C;
    double* sv = sh + (size_t)nt * ld;           // s[cols[e, :]], C
    const int64_t* ce = cols + (size_t)e * C;
    for (int i = t; i < C; i += nt) sv[i] = s[ce[i]];
    const size_t o = (size_t)e * nt + t;
    const double d = dz0 ? dz0[o] : 0.0;
    const double* mine = panel_row(pe, kstride, C, nD, t);
    double acc = 0.0;
    for (int c0 = 0; c0 < C; c0 += CC) {
        const int n = min(CC, C - c0);
        cp_panel_chunk(sh, ld, pe, kstride, C, nD, nt, c0, n, t, nt);
        cp_async_wait_all();
        __syncthreads();
        const double* pk = sh + (size_t)t * ld + odd8(mine + c0);
        const double* sc = sv + c0;
#pragma unroll 4
        for (int c = 0; c < n; ++c) acc = acc + pk[c] * sc[c];
        __syncthreads();
    }
    out[o] = dz0 ? d + acc : acc;
}

// The spread form: block (e, y) takes element e's rows r0 = y*SPREAD_ROWS
// .. r0 + nr - 1. Its warp 0 sums them, lane t row r0 + t, from shared
// memory and does nothing else, so that each step of a sum costs a few
// instructions (the sums, 1,924 steps at C = 1,924, are the kernel's
// critical path: one warp an SM). Warps 1 .. SPREAD_WARPS - 1 stage the
// rows, SPREAD_STAGES chunks of CC columns in flight (cp.async; a warp
// copies a row, its lanes over the row's 16-byte pieces), and with warp 0
// gather s[cols[e, :]] while the first chunks arrive.
__global__ void __launch_bounds__(32 * SPREAD_WARPS)
panel_fwd_spread_kernel(const double* __restrict__ panels,
                        const int64_t* __restrict__ cols,
                        const double* __restrict__ s,
                        const double* __restrict__ dz0,
                        double* __restrict__ out, int nD, int N, int p,
                        int C, int CC) {
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int e = blockIdx.x, ld = CC + 2, pn = p * nD;
    const int r0 = blockIdx.y * SPREAD_ROWS, nr = min(SPREAD_ROWS, pn - r0);
    const size_t kstride = (size_t)N * p * C;
    const double* pe = panels + (size_t)e * p * C;
    const int buf = SPREAD_ROWS * ld;            // doubles a stage takes
    double* sv = sh + SPREAD_STAGES * buf;       // s[cols[e, :]], C
    const int64_t* ce = cols + (size_t)e * C;
    const int nch = (C + CC - 1) / CC;
    // a staging warp's share of chunk j into stage j % SPREAD_STAGES,
    // committed as one group (an empty one past the last chunk)
    auto issue = [&](int j) {
        if (j < nch) {
            const int c0 = j * CC, n = min(CC, C - c0);
            double* dst = sh + (j % SPREAD_STAGES) * buf;
            for (int r = warp - 1; r < nr; r += SPREAD_WARPS - 1) {
                const double* src =
                    panel_row(pe, kstride, C, nD, r0 + r) + c0;
                const int h = odd8(src);
                for (int q = lane, np = cp_pieces(n, h); q < np; q += 32)
                    cp_piece(dst + (size_t)r * ld + h, src, n, h, q);
            }
        }
        cp_async_commit();
    };
    if (warp > 0)
        for (int j = 0; j < SPREAD_STAGES - 1; ++j) issue(j);
#pragma unroll 4
    for (int i = t; i < C; i += blockDim.x) sv[i] = s[ce[i]];
    const bool live = warp == 0 && lane < nr;
    const size_t o = (size_t)e * pn + r0 + lane;
    const double d = (live && dz0) ? dz0[o] : 0.0;
    const double* mine =
        panel_row(pe, kstride, C, nD, r0 + (live ? lane : 0));
    double acc = 0.0;
    for (int j = 0; j < nch; ++j) {
        if (warp > 0) {
            issue(j + SPREAD_STAGES - 1);
            cp_async_wait_group<SPREAD_STAGES - 1>();
        }
        __syncthreads();
        if (live) {
            const int c0 = j * CC, n = min(CC, C - c0);
            const double* pk = sh + (j % SPREAD_STAGES) * buf
                               + (size_t)lane * ld + odd8(mine + c0);
            const double* sc = sv + c0;
#pragma unroll 8
            for (int c = 0; c < n; ++c) acc = acc + pk[c] * sc[c];
        }
        __syncthreads();
    }
    if (live) out[o] = dz0 ? d + acc : acc;
}

static size_t group_smem(int nD, int p, int C, int E) {
    return sizeof(double) * ((size_t)nD * slab_stride(E, p, C)
                             + (size_t)E * C);
}

// The form a launch takes: 1 the element-group form, 2 the wide form, 3
// the spread form; `form` 0 picks by shape (the note at the top), 1..3
// asks for one. 0 when the shape is refused.
static int pick_form(int nD, int N, int p, int C, int form) {
    if (C <= 0 || form < 0 || form > 3) return 0;
    const int per = p * nD;
    const bool group = per <= 1024 && group_smem(nD, p, C, 1) <= SMEM_MAX;
    const bool wide = per <= 1024 && chunk_cols(per, C, WIDE_BUDGET, C) > 0;
    const bool spread =
        chunk_cols(SPREAD_STAGES * SPREAD_ROWS, C, WIDE_BUDGET, C) > 0;
    if (form == 0) {
        if (per > 1024 || (N < SPREAD_MAX_N && per >= SPREAD_MIN_ROWS))
            form = 3;
        else
            form = group ? 1 : 2;
    }
    const bool ok[4] = {false, group, wide, spread};
    return ok[form] ? form : 0;
}

static int fit_smem(const void* kernel, size_t bytes) {
    if (bytes <= SMEM_DEFAULT) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The form panel_fwd_launch takes for this shape and request (0: refused).
extern "C" int panel_fwd_form(int nD, int N, int p, int C, int form) {
    return pick_form(nD, N, p, C, form);
}

// form: 0 by shape, 1..3 one form (pick_form); a form that cannot take
// the shape is refused (cudaErrorInvalidValue).
extern "C" int panel_fwd_launch(const void* panels, const void* cols,
                                const void* s, const void* dz0, void* out,
                                int nD, int N, int p, int C, int form,
                                void* stream) {
    if (N <= 0 || nD <= 0 || p <= 0) return (int)cudaGetLastError();
    form = pick_form(nD, N, p, C, form);
    if (form == 0) return (int)cudaErrorInvalidValue;
    const int per = p * nD;                      // rows (outputs) an element
    if (form == 3) {
        const int CC =
            chunk_cols(SPREAD_STAGES * SPREAD_ROWS, C, WIDE_BUDGET, C);
        const size_t bytes =
            sizeof(double) * ((size_t)SPREAD_STAGES * SPREAD_ROWS * (CC + 2)
                              + (size_t)C);
        const int err =
            fit_smem((const void*)panel_fwd_spread_kernel, bytes);
        if (err) return err;
        const dim3 grid(N, (per + SPREAD_ROWS - 1) / SPREAD_ROWS);
        panel_fwd_spread_kernel<<<grid, 32 * SPREAD_WARPS, bytes,
                                  (cudaStream_t)stream>>>(
            (const double*)panels, (const int64_t*)cols, (const double*)s,
            (const double*)dz0, (double*)out, nD, N, p, C, CC);
        return (int)cudaGetLastError();
    }
    if (form == 2) {
        const int CC = chunk_cols(per, C, WIDE_BUDGET, C);
        const size_t bytes =
            sizeof(double) * ((size_t)per * (CC + 2) + (size_t)C);
        const int err = fit_smem((const void*)panel_fwd_wide_kernel, bytes);
        if (err) return err;
        panel_fwd_wide_kernel<<<N, per, bytes, (cudaStream_t)stream>>>(
            (const double*)panels, (const int64_t*)cols, (const double*)s,
            (const double*)dz0, (double*)out, nD, N, p, C, CC);
        return (int)cudaGetLastError();
    }
    int E = per >= THREADS_TARGET ? 1 : THREADS_TARGET / per;
    if (E > N) E = N;
    while (E > 1 && group_smem(nD, p, C, E) > SMEM_DEFAULT) --E;
    const size_t bytes = group_smem(nD, p, C, E);
    const int err = fit_smem((const void*)panel_fwd_kernel, bytes);
    if (err) return err;
    panel_fwd_kernel<<<(N + E - 1) / E, E * per, bytes,
                       (cudaStream_t)stream>>>(
        (const double*)panels, (const int64_t*)cols, (const double*)s,
        (const double*)dz0, (double*)out, nD, N, p, C, E);
    return (int)cudaGetLastError();
}

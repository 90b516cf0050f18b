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
// C = 1,924). There the call is a dense GEMV over the (nD*p, C) view,
// bound by bytes (63.0 MB, 18.8 us at 3.35 TB/s at n = 32), and a left
// fold of C steps on one thread is too long a chain to stream it. The
// spread form (panel_fwd_split_kernel) therefore sums each row in a
// split order of its own: a warp takes a row, lane l folds the column
// pairs (2j, 2j + 1) with j = l, l + SPLIT_LANES, ... in increasing j
// (each product and sum rounded apart, from 0.0), and the lanes' partials
// are joined by a fixed __shfl_xor_sync tree (offsets 16, 8, 4, 2, 1),
// then dz0 + sum. panel_fwd_split_plain (panel_fwd.py) is that order in
// plain PyTorch, with the same constants, and gives the kernel's bits.
// The panel entries are used once, so each lane reads them straight from
// device memory, 16 bytes a load (two 8-byte loads on a row that does not
// start 16-byte aligned: the same values, the same order) that skips L1
// and fetches 256 B into L2 a miss, SPLIT_BATCH loads in flight and the
// next batch issued before the last is folded; the gathered s[cols[e, :]]
// is staged once a block in shared memory, and the first batch is in
// flight while it is. A block takes SPLIT_WARPS rows of one element: N *
// ceil(p*nD / SPLIT_WARPS) blocks, 128 at n = 32 (one an SM), 288 at its
// phase-I rows. On an H100 at 700 W the L2-fetching loads and one row a
// warp in 32-warp blocks took n = 32 from 0.0319 to 0.0249 ms and its
// phase-I rows from 0.1347 to 0.1019 (PERF.md §6).
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
#define SPLIT_LANES 32      // spread form: lanes that fold a row (a warp),
#define SPLIT_VEC 2         // ... each SPLIT_VEC columns a step (16 bytes);
                            // these two set the order (panel_fwd.py's too)
// these two leave the order as it is
#define SPLIT_WARPS 32      // ... warps a block, a row each
#define SPLIT_BATCH 4       // ... 16-byte loads a lane has in a batch
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

// Columns 2j, 2j + 1 of a row (the second 0.0 past C): one 16-byte load
// on a row that starts 16-byte aligned, two 8-byte loads on another.
__device__ __forceinline__ double2 row_pair(const double* row, int j, int C,
                                            bool aligned) {
    const int c = SPLIT_VEC * j;
    if (c + 1 < C)
        return aligned ? ld_stream2(row + c)
                       : make_double2(__ldg(row + c), __ldg(row + c + 1));
    return make_double2(__ldg(row + c), 0.0);
}

// The spread form: block (e, y) takes element e's row y*SPLIT_WARPS + w on
// its warp w; lane l of the warp folds the row's column pairs l, l + 32,
// ... (the note at the top).
// s[cols[e, :]] sits in shared memory, with a 0.0 after it for odd C, so
// that the last pair's second product is 0.0 * 0.0 (an added +0.0 leaves
// a sum that starts at +0.0 as it is, as a skipped product would).
__global__ void __launch_bounds__(32 * SPLIT_WARPS)
panel_fwd_split_kernel(const double* __restrict__ panels,
                       const int64_t* __restrict__ cols,
                       const double* __restrict__ s,
                       const double* __restrict__ dz0,
                       double* __restrict__ out, int nD, int N, int p,
                       int C) {
    static_assert(SPLIT_LANES == 32 && SPLIT_VEC == 2,
                  "a lane of a warp reads one double2 a step");
    extern __shared__ __align__(16) double sv[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.x, pn = p * nD;
    const int np = (C + 1) / 2;                  // column pairs a row
    constexpr int STEP = SPLIT_LANES * SPLIT_BATCH;   // pairs a batch
    const size_t kstride = (size_t)N * p * C;
    const double* pe = panels + (size_t)e * p * C;
    const double2* sv2 = reinterpret_cast<const double2*>(sv);
    auto load = [&](const double* row, bool al, int j0, double2* a) {
#pragma unroll
        for (int u = 0; u < SPLIT_BATCH; ++u) {
            const int j = j0 + u * SPLIT_LANES + lane;
            a[u] = j < np ? row_pair(row, j, C, al) : make_double2(0.0, 0.0);
        }
    };
    auto fold = [&](int j0, const double2* a, double acc) {
#pragma unroll
        for (int u = 0; u < SPLIT_BATCH; ++u) {
            const int j = j0 + u * SPLIT_LANES + lane;
            if (j < np) {
                const double2 w = sv2[j];
                acc = acc + a[u].x * w.x;
                acc = acc + a[u].y * w.y;
            }
        }
        return acc;
    };
    const int r = blockIdx.y * SPLIT_WARPS + warp;
    const double* row = panel_row(pe, kstride, C, nD, r < pn ? r : 0);
    const bool al = ((uintptr_t)row & 15) == 0;
    double2 a[SPLIT_BATCH], b[SPLIT_BATCH];
    if (r < pn) load(row, al, 0, a);             // in flight during the gather
    const int64_t* ce = cols + (size_t)e * C;
    for (int i = threadIdx.x; i < C; i += blockDim.x) sv[i] = s[ce[i]];
    if (threadIdx.x == 0 && (C & 1)) sv[C] = 0.0;
    __syncthreads();
    if (r >= pn) return;
    double acc = 0.0;
    for (int j0 = 0; j0 < np; j0 += 2 * STEP) {
        if (j0 + STEP < np) load(row, al, j0 + STEP, b);
        acc = fold(j0, a, acc);
        if (j0 + STEP >= np) break;
        if (j0 + 2 * STEP < np) load(row, al, j0 + 2 * STEP, a);
        acc = fold(j0 + STEP, b, acc);
    }
#pragma unroll
    for (int o = SPLIT_LANES / 2; o > 0; o >>= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
        const size_t o = (size_t)e * pn + r;
        out[o] = dz0 ? dz0[o] + acc : acc;
    }
}

static size_t split_smem(int C) {
    return sizeof(double) * (size_t)(C + 1);
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
    const bool spread = split_smem(C) <= SMEM_MAX
                        && (per + SPLIT_WARPS - 1) / SPLIT_WARPS <= 65535;
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
        const size_t bytes = split_smem(C);
        const int err = fit_smem((const void*)panel_fwd_split_kernel, bytes);
        if (err) return err;
        const dim3 grid(N, (per + SPLIT_WARPS - 1) / SPLIT_WARPS);
        panel_fwd_split_kernel<<<grid, 32 * SPLIT_WARPS, bytes,
                                 (cudaStream_t)stream>>>(
            (const double*)panels, (const int64_t*)cols, (const double*)s,
            (const double*)dz0, (double*)out, nD, N, p, C);
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

// Deterministic adjoint panel product, in two coalesced phases.
//
//   A:  contrib[e*C + c] = sum_k sum_q panels[k, e, q, c] * Y[e*p + q, k]
//   B:  out[j]           = sum of contrib[f] over inv[j, :], increasing f
//
// Phase A runs one thread per slot (e, c), c fastest, so neighbouring threads
// read neighbouring panel entries; a block stages its elements' p*nD values
// of Y in shared memory and each thread sums in the fixed (k, q) order,
// its loads unrolled so that many are in flight. That staged form runs a
// block on a group of whole elements: a level of one element (the spectral
// levels, N = 1, C up to 1,924 slots over p*nD up to 9,216 rows of 63 MB
// and more of panels) would run on one block of one SM, and an element
// past ADJ_STAGE values of Y not at all. Its spread form runs block (x, e)
// on slots 32x .. 32x + 31 of element e (61 blocks at C = 1,924) and
// passes the element's (k, q) rows through shared memory, ADJ_SPREAD_ROWS
// a stage: one warp sums, a lane a slot, while the others stage the rows
// ahead with cp.async. Each slot's sum runs over the stages in the same
// (k, q) order, from the same 0.0, so both forms give the same bits and
// take any p*nD; its p*nD dependent steps on one warp an SM are the
// critical path at one element. adjoint_launch takes the spread form for
// p*nD > ADJ_STAGE and for levels of fewer than ADJ_SPREAD_MAX_N elements
// of at least ADJ_SPREAD_MIN_C slots; every fem level the card runs keeps
// the staged form. Bound: bytes, the panels read once (2 flops a double).
// Phase B sums each column's slots from the inverse incidence inv (n_J, K),
// padded with N*C at the end, in one of two forms adjoint_launch picks from
// K:
//   K <= ADJ_THREAD_K  one thread per column, slots in increasing order (the
//                      fine levels);
//   larger K           one block of ADJ_COL_THREADS per column (the coarse
//                      levels, hundreds to thousands of slots): thread r sums
//                      slots r, r + ADJ_COL_THREADS, ... in order, then a
//                      fixed shuffle tree per warp and one over the warps'
//                      partials.
// No atomics: every run gives the same bits (an atomicAdd scatter changes
// its summation order from run to run). The thread form adds in the order
// of the one-pass gather it replaces, so its bits are that kernel's. Both
// phases launch as programmatic dependents (pdl.cuh): phase B is scheduled
// while phase A runs and waits for it on the device.
// K3 (panel_adj.cu) runs both phases through adjoint_launch; K4
// (gram_matvec.cu) computes its per-slot contributions in its own fused
// kernel, in phase A's order, and runs phase B alone (adjoint_sum_launch).
// On a mesh, each shard runs phase A (or K4's fused kernel) on its elements
// and the first device runs phase B once over every shard's contributions,
// concatenated in shard order: the level's slots in their order, so the
// same bits as one device (panel_adj.cu's contrib and sum entries).
#pragma once
#include <cstdint>

#include "cpasync.cuh"
#include "pdl.cuh"

#define ADJ_THREADS 128        // phase A threads per block
#define ADJ_STAGE 4096         // phase A: most doubles of Y staged per block
#define ADJ_THREAD_K 32        // phase B: most slots a thread sums alone
#define ADJ_COL_THREADS 256    // phase B: threads per column in block form
#define ADJ_SPREAD_WARPS 8     // phase A spread form: one sums, 7 stage
#define ADJ_SPREAD_ROWS 128    // ... (k, q) rows a stage
#define ADJ_SPREAD_STAGES 4    // ... stages in shared memory (135 KB)
#define ADJ_SPREAD_MAX_N 8     // by shape: levels of fewer elements ...
#define ADJ_SPREAD_MIN_C 64    // ... with at least this many slots each
static_assert(ADJ_SPREAD_ROWS <= 32 * (ADJ_SPREAD_WARPS - 1),
              "a staging warp's lanes copy its rows' values of Y");

// P > 0: p == P at compile time (7, the P2 element), so a thread's loads
// of a row k, and of the next rows, go out together
template <int P>
__global__ void adjoint_contrib_kernel(const double* __restrict__ panels,
                                       const double* __restrict__ Y,
                                       double* __restrict__ contrib, int nD,
                                       int N, int p, int C, int EB) {
    extern __shared__ double sY[];  // EB elements x p*nD
    pdl_wait();
    pdl_trigger();
    if (P > 0) p = P;
    const int pn = p * nD;
    const int e0 = blockIdx.x * EB;
    const int ne = min(EB, N - e0);
    const double* Yb = Y + (size_t)e0 * pn;
    for (int t = threadIdx.x; t < ne * pn; t += blockDim.x) sY[t] = Yb[t];
    __syncthreads();
    const size_t kstride = (size_t)N * p * C;
    for (int t = threadIdx.x; t < ne * C; t += blockDim.x) {
        const int el = t / C, c = t - el * C;
        const double* pe = panels + (size_t)(e0 + el) * p * C + c;
        const double* ye = sY + el * pn;
        double s = 0.0;
#pragma unroll 4
        for (int k = 0; k < nD; ++k) {
#pragma unroll
            for (int q = 0; q < (P > 0 ? P : p); ++q)
                s += pe[k * kstride + (size_t)q * C] * ye[q * nD + k];
        }
        contrib[(size_t)(e0 + el) * C + c] = s;
    }
}

// Phase A, spread form: block (x, e), thread t. Its warp 0 sums: lane l the
// slot c = x*32 + l of element e, from shared memory and nothing else, so
// that each of a sum's p*nD steps costs a few instructions (4,096 steps
// at spectral2d n = 32: the kernel's critical path). Warps 1 ..
// ADJ_SPREAD_WARPS - 1 stage: a stage holds ADJ_SPREAD_ROWS rows i = k*p
// + q of the sum's order, each row's 32 panel entries panels[k, e, q, c]
// (row-major) and then the rows' values of Y, ADJ_SPREAD_STAGES - 1
// stages in flight ahead of the sums (cp.async).
__global__ void __launch_bounds__(32 * ADJ_SPREAD_WARPS)
adjoint_contrib_spread_kernel(const double* __restrict__ panels,
                              const double* __restrict__ Y,
                              double* __restrict__ contrib, int nD, int N,
                              int p, int C) {
    extern __shared__ __align__(16) double sh[];
    pdl_wait();
    pdl_trigger();
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int e = blockIdx.y, c0 = blockIdx.x * 32;
    const int pn = p * nD;
    const int stage = ADJ_SPREAD_ROWS * 33;
    const size_t kstride = (size_t)N * p * C;
    const double* pe = panels + (size_t)e * p * C + c0 + lane;
    const double* ye = Y + (size_t)e * pn;
    const bool mine = c0 + lane < C;            // this lane's slot exists
    const int nst = (pn + ADJ_SPREAD_ROWS - 1) / ADJ_SPREAD_ROWS;
    const int nw = ADJ_SPREAD_WARPS - 1, sw = warp - 1;   // staging warps
    // a staging warp's share of stage j, its rows lo .. hi - 1 ((k, q) and
    // the panel offset stepped along: one division a range), into buffer
    // j % ADJ_SPREAD_STAGES, committed as one group (an empty one past the
    // last stage)
    auto issue = [&](int j) {
        if (j < nst) {
            double* buf = sh + (j % ADJ_SPREAD_STAGES) * stage;
            double* yb = buf + ADJ_SPREAD_ROWS * 32;
            const int i0 = j * ADJ_SPREAD_ROWS;
            const int n = min(ADJ_SPREAD_ROWS, pn - i0);
            const int lo = sw * n / nw, hi = (sw + 1) * n / nw;
            int k = (i0 + lo) / p, q = i0 + lo - k * p;
            size_t off = k * kstride + (size_t)q * C;
            for (int r = lo; r < hi; ++r) {
                if (mine) cp_async8(buf + r * 32 + lane, pe + off);
                off += C;
                if (++q == p) {
                    q = 0;
                    off += kstride - (size_t)p * C;
                }
            }
            if (lo + lane < hi) {
                const int i = i0 + lo + lane, kk = i / p, qq = i - kk * p;
                cp_async8(yb + lo + lane, ye + qq * nD + kk);
            }
        }
        cp_async_commit();
    };
    if (warp > 0)
        for (int j = 0; j < ADJ_SPREAD_STAGES - 1; ++j) issue(j);
    double acc = 0.0;
    for (int j = 0; j < nst; ++j) {
        if (warp > 0) {
            issue(j + ADJ_SPREAD_STAGES - 1);
            cp_async_wait_group<ADJ_SPREAD_STAGES - 1>();
        }
        __syncthreads();
        if (warp == 0) {
            const double* buf = sh + (j % ADJ_SPREAD_STAGES) * stage;
            const double* yb = buf + ADJ_SPREAD_ROWS * 32;
            const int n = min(ADJ_SPREAD_ROWS, pn - j * ADJ_SPREAD_ROWS);
#pragma unroll 8
            for (int r = 0; r < n; ++r) acc += buf[r * 32 + lane] * yb[r];
        }
        __syncthreads();
    }
    if (warp == 0 && mine) contrib[(size_t)e * C + c0 + lane] = acc;
}

__global__ void adjoint_sum_thread_kernel(const double* __restrict__ contrib,
                                          const int64_t* __restrict__ inv,
                                          double* __restrict__ out, int n_J,
                                          int K, int64_t pad) {
    pdl_wait();
    pdl_trigger();
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_J) return;
    const int64_t* ij = inv + (size_t)j * K;
    double acc = 0.0;
#pragma unroll 4  // independent loads in flight; the adds stay in order
    for (int t = 0; t < K; ++t) {
        const int64_t f = ij[t];
        if (f != pad) acc += contrib[f];  // padding is trailing
    }
    out[j] = acc;
}

__device__ __forceinline__ double adj_warp_tree(double v) {
    // lane 0 ends with a fixed-shape tree sum of the warp's 32 values
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__global__ void adjoint_sum_block_kernel(const double* __restrict__ contrib,
                                         const int64_t* __restrict__ inv,
                                         double* __restrict__ out, int K,
                                         int64_t pad) {
    constexpr int WARPS = ADJ_COL_THREADS / 32;
    __shared__ double part[WARPS];
    pdl_wait();
    pdl_trigger();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x;
    const int64_t* ij = inv + (size_t)j * K;
    double acc = 0.0;
#pragma unroll 4
    for (int t = threadIdx.x; t < K; t += ADJ_COL_THREADS) {
        const int64_t f = ij[t];
        if (f != pad) acc += contrib[f];  // padding is trailing
    }
    acc = adj_warp_tree(acc);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        double v = lane < WARPS ? part[lane] : 0.0;
        v = adj_warp_tree(v);
        if (lane == 0) out[j] = v;
    }
}

// Phase B alone: out (n_J,) from the per-slot contributions contrib
// (N*C,), in the form K asks for.
static inline cudaError_t adjoint_sum_launch(const int64_t* inv,
                                             const double* contrib,
                                             double* out, int N, int C,
                                             int n_J, int K,
                                             cudaStream_t stream) {
    if (n_J <= 0) return cudaSuccess;
    const int64_t pad = (int64_t)N * C;
    if (K <= ADJ_THREAD_K)
        return launch_pdl(adjoint_sum_thread_kernel, dim3((n_J + 127) / 128),
                          dim3(128), 0, stream, contrib, inv, out, n_J, K,
                          pad);
    return launch_pdl(adjoint_sum_block_kernel, dim3(n_J),
                      dim3(ADJ_COL_THREADS), 0, stream, contrib, inv, out, K,
                      pad);
}

// The phase-A form a launch takes: 1 staged, 3 spread (2 is K1's wide
// form, which K3 has not); `form` 0 picks by shape (the note at the top),
// 1 or 3 asks for one. 0 when refused.
static inline int adjoint_form(int nD, int N, int p, int C, int form) {
    const int pn = p * nD;
    if (form == 0)
        form = (pn > ADJ_STAGE || (N < ADJ_SPREAD_MAX_N &&
                                   C >= ADJ_SPREAD_MIN_C)) ? 3 : 1;
    if (form == 1) return pn <= ADJ_STAGE ? 1 : 0;
    return form == 3 ? 3 : 0;
}

// Phase A alone: the per-slot contributions contrib (N*C,). Returns the
// first launch error, or cudaErrorInvalidValue when the form refuses the
// shape.
static inline cudaError_t adjoint_contrib_launch(const double* panels,
                                                 const double* Y,
                                                 double* contrib, int nD,
                                                 int N, int p, int C,
                                                 int form,
                                                 cudaStream_t stream) {
    const int pn = p * nD;
    form = adjoint_form(nD, N, p, C, form);
    if (form == 0) return cudaErrorInvalidValue;
    if (N > 0 && C > 0 && form == 3) {
        const size_t bytes =
            sizeof(double) * ADJ_SPREAD_STAGES * ADJ_SPREAD_ROWS * 33;
        cudaError_t e = cudaFuncSetAttribute(
            adjoint_contrib_spread_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return e;
        e = launch_pdl(adjoint_contrib_spread_kernel, dim3((C + 31) / 32, N),
                       dim3(32 * ADJ_SPREAD_WARPS), bytes, stream, panels, Y,
                       contrib, nD, N, p, C);
        if (e != cudaSuccess) return e;
    } else if (N > 0 && C > 0) {
        int EB = ADJ_THREADS / C;
        if (EB > ADJ_STAGE / pn) EB = ADJ_STAGE / pn;
        if (EB < 1) EB = 1;
        cudaError_t e = launch_pdl(
            p == 7 ? adjoint_contrib_kernel<7> : adjoint_contrib_kernel<0>,
            dim3((N + EB - 1) / EB),
            dim3(ADJ_THREADS), (size_t)EB * pn * sizeof(double), stream,
            panels, Y, contrib, nD, N, p, C, EB);
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

// Both phases on one stream; contrib is (N*C,) scratch.
static inline cudaError_t adjoint_launch(const double* panels,
                                         const int64_t* inv, const double* Y,
                                         double* contrib, double* out, int nD,
                                         int N, int p, int C, int n_J, int K,
                                         int form, cudaStream_t stream) {
    const cudaError_t e =
        adjoint_contrib_launch(panels, Y, contrib, nD, N, p, C, form, stream);
    if (e != cudaSuccess) return e;
    return adjoint_sum_launch(inv, contrib, out, N, C, n_J, K, stream);
}

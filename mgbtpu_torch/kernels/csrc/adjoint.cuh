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
// past ADJ_STAGE values of Y not at all. Its spread form splits each
// slot's sum in two levels instead: the rows i = k*p + q, in that order,
// go in slabs (adj_split_slab: ADJ_SPLIT_SLAB rows, ADJ_SPLIT_SLAB_SMALL
// for an element of at most ADJ_SPLIT_SMALL rows, whose few slabs of 128
// rows would leave the card idle); block (x, slab, e) folds its slab's rows
// for slots 2t and 2t + 1 of column tile x on its thread t (from 0.0,
// each product and sum rounded apart) into the slab's partial sums (N x
// slabs x C doubles of scratch, which the L2 holds), and a second kernel
// (adjoint_slab_sum_kernel, launched as a programmatic dependent) folds
// each slot's partials in slab order, from 0.0. The first level reads the
// panels once: 16-byte loads of neighbouring slots that skip L1 and fetch
// 256 B into L2 a miss (at the phase-I shape on an H100 at 700 W these
// took a call from 0.1144 to 0.1046 ms, PERF.md §6),
// ADJ_SPLIT_BATCH rows in flight and the next batch issued before the
// last is folded, the slab's values of Y in shared memory. No atomics:
// panel_adj_contrib_split_plain (panel_adj.py) is that order in plain
// PyTorch and gives the kernel's bits; the staged form's bits differ in
// the last places. Grid at spectral2d n = 32: 8 tiles x 32 slabs (its
// phase-I rows: 16 x 72; spectral1d n = 128: 1 x 12). adjoint_launch
// takes the spread form for p*nD > ADJ_STAGE and for levels of fewer than
// ADJ_SPREAD_MAX_N elements of at least ADJ_SPREAD_MIN_C slots. Bound:
// bytes, the panels read once (2 flops a double).
// The staged form reads a wide element's panels (the fem3d Q3 hex: p = 64,
// C = 128, 320 rows of 1 KB; phase I 512 rows of 1.5 KB) 8 bytes a thread
// with stride C, few loads in flight behind each thread's chain of adds.
// Its bulk form (4) keeps its order and streams the rows instead: one
// element a CTA; lane 0 of warp 0 copies the element's rows i = k*p + q,
// in stages of R consecutive rows (one 1-D TMA bulk copy per k a stage
// touches: row q of slab k is contiguous with row q + 1), through a ring
// of S stages in shared memory (tma.cuh: a full and an empty barrier a
// stage, reused round after round); the other warps fold, consumer thread
// t slot t (and t + T past ADJ_BULK_MAX_T slots), over the rows in (k, q)
// order from 0.0, each product and sum rounded apart: the staged form's
// bits (panel_adj_contrib_rows_plain in panel_adj.py). The ring keeps a
// CTA's next stage in flight with no registers spent on addresses; its
// stages are small (4 to 8 KB, 2 of them: ~20 KB a CTA, 10 or more CTAs
// an SM), which timed fastest at the fem3d shapes on an H100: small
// elements need many CTAs resident, and a level of one wave of CTAs
// (L=4's 512) waits on each CTA's first stage and last fold. It takes an
// even C (a row of C doubles a multiple of 16 bytes, as a bulk copy
// needs) and a 16-byte aligned base; by shape it runs levels of at least
// ADJ_BULK_MIN_N elements of at least ADJ_BULK_MIN_ROWS rows, where it
// timed faster than the staged form at every C (PERF.md §6): the fem3d
// Q3 levels (p = 64). Every fem2d level keeps the staged form.
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
#include "tma.cuh"

#define ADJ_THREADS 128        // phase A threads per block
#define ADJ_STAGE 4096         // phase A: most doubles of Y staged per block
#define ADJ_THREAD_K 32        // phase B: most slots a thread sums alone
#define ADJ_COL_THREADS 256    // phase B: threads per column in block form
// phase A spread form: rows a slab, which set the order (as panel_adj.py's
// SPLIT_SLAB, SPLIT_SLAB_SMALL and SPLIT_SMALL)
#define ADJ_SPLIT_SLAB 128     // rows a slab ...
#define ADJ_SPLIT_SLAB_SMALL 32  // ... and in an element of at most
#define ADJ_SPLIT_SMALL 2048     // ... this many rows
// these three leave the order as it is
#define ADJ_SPLIT_THREADS 128  // ... threads a block, two slots each
#define ADJ_SPLIT_BATCH 16     // ... rows a thread has in a batch
#define ADJ_SUM_BATCH 32       // second level: partials a thread loads at once
#define ADJ_SPREAD_MAX_N 8     // by shape: levels of fewer elements ...
#define ADJ_SPREAD_MIN_C 64    // ... with at least this many slots each
// phase A bulk form: a stage holds ADJ_BULK_STAGE_ROWS rows, or as many as
// make ADJ_BULK_STAGE_MIN to ADJ_BULK_STAGE_MAX bytes, the ring
// ADJ_BULK_STAGES stages; none of them moves the order
// (panel_adj_bulk_tune sets others for a timing run)
#define ADJ_BULK_STAGE_ROWS 16
#define ADJ_BULK_STAGE_MIN 4096
#define ADJ_BULK_STAGE_MAX 8192
#define ADJ_BULK_STAGES 2
#define ADJ_BULK_MAX_T 256     // consumer threads at most (past it 2 slots
#define ADJ_BULK_MAX_C 512     // ... each, to this many slots)
#define ADJ_BULK_MIN_N 8       // by shape: levels of at least this many
#define ADJ_BULK_MIN_ROWS 256  // ... elements of at least this many rows

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

__host__ __device__ __forceinline__ int adj_split_slab(int pn) {
    return pn > ADJ_SPLIT_SMALL ? ADJ_SPLIT_SLAB : ADJ_SPLIT_SLAB_SMALL;
}

// Phase A, spread form, first level: block (x, slab, e), thread t folds
// the slab's rows for slots c = 2*(x*ADJ_SPLIT_THREADS + t) and c + 1 of
// element e into part[(e*slabs + slab)*C + c] (the note at the top). A
// row is read 16 bytes a thread where it starts 16-byte aligned, 8 bytes
// twice otherwise: the same values in the same order.
__global__ void __launch_bounds__(ADJ_SPLIT_THREADS)
adjoint_contrib_split_kernel(const double* __restrict__ panels,
                             const double* __restrict__ Y,
                             double* __restrict__ part, int nD, int N, int p,
                             int C) {
    __shared__ double yv[ADJ_SPLIT_SLAB];
    pdl_wait();
    pdl_trigger();
    const int t = threadIdx.x, e = blockIdx.z, slab = blockIdx.y;
    const int pn = p * nD;
    const int rows = adj_split_slab(pn);
    const int i0 = slab * rows;
    const int n = min(rows, pn - i0);
    const int c = 2 * (blockIdx.x * ADJ_SPLIT_THREADS + t);
    const size_t kstride = (size_t)N * p * C;
    const double* pe = panels + (size_t)e * p * C + c;
    // row i0 + r of the slab at pe + off: (k, q) and off stepped along
    int k = i0 / p, q = i0 - k * p;
    size_t off = k * kstride + (size_t)q * C;
    auto next = [&]() {
        off += C;
        if (++q == p) {
            q = 0;
            off += kstride - (size_t)p * C;
        }
    };
    auto load = [&](int r0, double2* a) {
#pragma unroll
        for (int u = 0; u < ADJ_SPLIT_BATCH; ++u) {
            a[u] = make_double2(0.0, 0.0);
            if (r0 + u < n) {
                const double* row = pe + off;
                if (c + 1 < C)
                    a[u] = ((uintptr_t)row & 15) == 0
                               ? ld_stream2(row)
                               : make_double2(__ldg(row), __ldg(row + 1));
                else if (c < C)
                    a[u].x = __ldg(row);
                next();
            }
        }
    };
    double a0 = 0.0, a1 = 0.0;
    auto fold = [&](int r0, const double2* a) {
#pragma unroll
        for (int u = 0; u < ADJ_SPLIT_BATCH; ++u)
            if (r0 + u < n) {
                const double y = yv[r0 + u];
                a0 = a0 + a[u].x * y;
                a1 = a1 + a[u].y * y;
            }
    };
    double2 a[ADJ_SPLIT_BATCH], b[ADJ_SPLIT_BATCH];
    load(0, a);                                  // in flight during the stage
    for (int r = t; r < n; r += ADJ_SPLIT_THREADS) {
        const int i = i0 + r, kk = i / p, qq = i - kk * p;
        yv[r] = Y[((size_t)e * p + qq) * nD + kk];
    }
    __syncthreads();
    constexpr int STEP = ADJ_SPLIT_BATCH;
    for (int r0 = 0; r0 < n; r0 += 2 * STEP) {
        if (r0 + STEP < n) load(r0 + STEP, b);
        fold(r0, a);
        if (r0 + STEP >= n) break;
        if (r0 + 2 * STEP < n) load(r0 + 2 * STEP, a);
        fold(r0 + STEP, b);
    }
    double* out = part + ((size_t)e * gridDim.y + slab) * C + c;
    if (c + 1 < C) {
        out[0] = a0;
        out[1] = a1;
    } else if (c < C) {
        out[0] = a0;
    }
}

// Phase A, spread form, second level: slot e*C + c is the fold of its
// slabs' partials in slab order, from 0.0.
__global__ void adjoint_slab_sum_kernel(const double* __restrict__ part,
                                        double* __restrict__ contrib, int N,
                                        int C, int slabs) {
    pdl_wait();
    pdl_trigger();
    const size_t f = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= (size_t)N * C) return;
    const size_t e = f / C;
    const double* pp = part + e * slabs * C + (f - e * C);
    double acc = 0.0;
    int sl = 0;
    for (; sl + ADJ_SUM_BATCH <= slabs; sl += ADJ_SUM_BATCH) {
        double v[ADJ_SUM_BATCH];                 // the loads all in flight,
#pragma unroll
        for (int u = 0; u < ADJ_SUM_BATCH; ++u)
            v[u] = pp[(size_t)(sl + u) * C];
#pragma unroll
        for (int u = 0; u < ADJ_SUM_BATCH; ++u) acc = acc + v[u];  // in order
    }
#pragma unroll 4
    for (; sl < slabs; ++sl) acc = acc + pp[(size_t)sl * C];
    contrib[f] = acc;
}

// The bulk form's layout: R rows a stage, S stages (the defaults where
// rows or stages is 0), T consumer threads of spt slots; shared memory:
// 2 S barriers (full, then empty), the element's p*nD values of Y, the
// ring (byte offsets y, ring; total bytes).
struct AdjBulk {
    int R, S, T, spt;
    size_t y, ring, total;
};

__host__ __device__ inline AdjBulk adj_bulk(int nD, int p, int C, int rows,
                                            int stages) {
    AdjBulk b;
    const int row = C * 8;
    b.R = ADJ_BULK_STAGE_ROWS;
    if (b.R * row < ADJ_BULK_STAGE_MIN) b.R = ADJ_BULK_STAGE_MIN / row;
    if (b.R * row > ADJ_BULK_STAGE_MAX) b.R = ADJ_BULK_STAGE_MAX / row;
    if (rows > 0) b.R = rows;
    if (b.R < 1) b.R = 1;
    b.S = stages > 1 ? stages : ADJ_BULK_STAGES;
    b.spt = C > ADJ_BULK_MAX_T ? 2 : 1;
    b.T = ((C + b.spt - 1) / b.spt + 31) & ~31;
    b.y = (size_t)16 * b.S;
    b.ring = b.y + (((size_t)p * nD * 8 + 15) & ~(size_t)15);
    b.total = b.ring + (size_t)b.S * b.R * row;
    return b;
}

// Phase A, bulk form: CTA e folds element e (the note at the top); warp 0
// the producer, the other T threads the consumers, SPT slots each.
template <int SPT>
__global__ void __launch_bounds__(32 + ADJ_BULK_MAX_T)
adjoint_contrib_bulk_kernel(const double* __restrict__ panels,
                            const double* __restrict__ Y,
                            double* __restrict__ contrib, int nD, int N,
                            int p, int C, int R, int S) {
    extern __shared__ __align__(16) unsigned char smb[];
    const int pn = p * nD, e = blockIdx.x, tid = threadIdx.x;
    const int T = blockDim.x - 32;
    const int stages = (pn + R - 1) / R;
    uint64_t* full = (uint64_t*)smb;
    uint64_t* empty = full + S;
    double* sY = (double*)(smb + (size_t)16 * S);
    double* ring = sY + ((pn + 1) & ~1);
    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, T / 32);
        }
        mbar_init_fence();
    }
    __syncthreads();
    pdl_wait();
    pdl_trigger();
    if (tid < 32) {  // the producer: stage j into ring slot j % S
        if (tid == 0) {
            const size_t kstride = (size_t)N * p * C;
            const double* pe = panels + (size_t)e * p * C;
            for (int j = 0; j < stages; ++j) {
                const int s = j % S, i0 = j * R;
                const int i1 = i0 + R < pn ? i0 + R : pn;
                if (j >= S) mbar_wait(empty + s, (j / S - 1) & 1);
                mbar_expect(full + s, (unsigned)(i1 - i0) * C * 8);
                double* dst = ring + (size_t)s * R * C;
                for (int i = i0; i < i1;) {  // one copy a slab k
                    const int k = i / p, q = i - k * p;
                    const int n = i1 - i < p - q ? i1 - i : p - q;
                    bulk_copy(dst + (size_t)(i - i0) * C,
                              pe + k * kstride + (size_t)q * C,
                              (unsigned)n * C * 8, full + s);
                    i += n;
                }
            }
        }
        return;
    }
    const int t = tid - 32;
    const double* Ye = Y + (size_t)e * pn;
    for (int u = t; u < pn; u += T) sY[u] = Ye[u];
    asm volatile("bar.sync 1, %0;\n" ::"r"(T) : "memory");  // consumers
    double acc[SPT];
#pragma unroll
    for (int u = 0; u < SPT; ++u) acc[u] = 0.0;
    int k = 0, q = 0;  // row i = k*p + q
    for (int j = 0; j < stages; ++j) {
        const int s = j % S;
        const int n = pn - j * R < R ? pn - j * R : R;
        mbar_wait(full + s, (j / S) & 1);
        const double* st = ring + (size_t)s * R * C + t;
#pragma unroll 4
        for (int r = 0; r < n; ++r) {
            const double y = sY[q * nD + k];
#pragma unroll
            for (int u = 0; u < SPT; ++u)
                if (t + u * T < C)
                    acc[u] = acc[u] + st[(size_t)r * C + u * T] * y;
            if (++q == p) {
                q = 0;
                ++k;
            }
        }
        __syncwarp();
        if ((t & 31) == 0) mbar_arrive(empty + s);
    }
#pragma unroll
    for (int u = 0; u < SPT; ++u)
        if (t + u * T < C) contrib[(size_t)e * C + t + u * T] = acc[u];
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

// Shapes the bulk form takes: rows of whole 16-byte pieces (C even), at
// most ADJ_BULK_MAX_C slots, the element's Y staged as the staged form's.
__host__ __device__ inline bool adj_bulk_takes(int nD, int N, int p, int C) {
    return N > 0 && C >= 2 && C % 2 == 0 && C <= ADJ_BULK_MAX_C &&
           p * nD <= ADJ_STAGE;
}

// The phase-A form a launch takes: 1 staged, 3 spread, 4 bulk (2 is K1's
// wide form, which K3 has not); `form` 0 picks by shape (the note at the
// top), 1, 3 or 4 asks for one. 0 when refused.
static inline int adjoint_form(int nD, int N, int p, int C, int form) {
    const int pn = p * nD;
    if (form == 0)
        form = (pn > ADJ_STAGE || (N < ADJ_SPREAD_MAX_N &&
                                   C >= ADJ_SPREAD_MIN_C)) ? 3
               : (adj_bulk_takes(nD, N, p, C) && N >= ADJ_BULK_MIN_N &&
                  pn >= ADJ_BULK_MIN_ROWS) ? 4 : 1;
    if (form == 1) return pn <= ADJ_STAGE ? 1 : 0;
    if (form == 4) return adj_bulk_takes(nD, N, p, C) ? 4 : 0;
    if (form != 3) return 0;
    const int rows = adj_split_slab(pn);
    const int slabs = (pn + rows - 1) / rows;
    return slabs <= 65535 && N <= 65535 ? 3 : 0;
}

// The bulk form's rows a stage and stages (panel_adj_bulk_tune; 0: the
// rule's).
static int adj_bulk_rows = 0;
static int adj_bulk_stages = 0;

// Let the bulk kernel take b.total bytes of shared memory, and the SM give
// shared memory all it can (~20 KB a CTA at the fem3d shapes).
template <typename Kern>
static inline cudaError_t adj_bulk_opt_in(Kern kern, const AdjBulk& b) {
    if (b.total > 227 * 1024) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b.total);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

// Phase A alone: the per-slot contributions contrib (N*C,), with `part`
// the spread form's scratch of slab partials, N x slabs x C doubles
// (panel_adj.py sizes it by the same rule; null for the staged form).
// Returns the first launch error, or cudaErrorInvalidValue when the form
// refuses the shape.
static inline cudaError_t adjoint_contrib_launch(const double* panels,
                                                 const double* Y,
                                                 double* contrib,
                                                 double* part, int nD,
                                                 int N, int p, int C,
                                                 int form,
                                                 cudaStream_t stream) {
    const int pn = p * nD;
    const int asked = form;
    form = adjoint_form(nD, N, p, C, form);
    // the bulk copies need a 16-byte aligned base (the staged form, with
    // the same bits, takes the rest by shape)
    if (form == 4 && ((uintptr_t)panels & 15)) form = asked == 0 ? 1 : 0;
    if (form == 0) return cudaErrorInvalidValue;
    if (N > 0 && C > 0 && form == 4) {
        const AdjBulk b = adj_bulk(nD, p, C, adj_bulk_rows,
                                   adj_bulk_stages);
        auto kern = b.spt == 2 ? adjoint_contrib_bulk_kernel<2>
                               : adjoint_contrib_bulk_kernel<1>;
        cudaError_t e = adj_bulk_opt_in(kern, b);
        if (e != cudaSuccess) return e;
        return launch_pdl(kern, dim3(N), dim3(32 + b.T), b.total, stream,
                          panels, Y, contrib, nD, N, p, C, b.R, b.S);
    }
    if (N > 0 && C > 0 && form == 3) {
        if (part == nullptr) return cudaErrorInvalidValue;
        const int rows = adj_split_slab(pn);
        const int slabs = (pn + rows - 1) / rows;
        const int tiles = (C + 2 * ADJ_SPLIT_THREADS - 1)
                          / (2 * ADJ_SPLIT_THREADS);
        cudaError_t e = launch_pdl(adjoint_contrib_split_kernel,
                                   dim3(tiles, slabs, N),
                                   dim3(ADJ_SPLIT_THREADS), 0, stream,
                                   panels, Y, part, nD, N, p, C);
        if (e != cudaSuccess) return e;
        const size_t slots = (size_t)N * C;
        e = launch_pdl(adjoint_slab_sum_kernel, dim3((slots + 255) / 256),
                       dim3(256), 0, stream, (const double*)part, contrib, N,
                       C, slabs);
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

// Both phases on one stream; contrib is (N*C,) scratch, part the spread
// form's (as adjoint_contrib_launch).
static inline cudaError_t adjoint_launch(const double* panels,
                                         const int64_t* inv, const double* Y,
                                         double* contrib, double* part,
                                         double* out, int nD, int N, int p,
                                         int C, int n_J, int K, int form,
                                         cudaStream_t stream) {
    const cudaError_t e = adjoint_contrib_launch(panels, Y, contrib, part,
                                                 nD, N, p, C, form, stream);
    if (e != cudaSuccess) return e;
    return adjoint_sum_launch(inv, contrib, out, N, C, n_J, K, stream);
}

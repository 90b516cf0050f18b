// panel_adj: adjoint panel product scattered into n_J, f64.
//
//   out[j] = sum_{(e, c): cols[e, c] = j} sum_q sum_k panels[k, e, q, c] * Y[e*p + q, k]
//
// Replaces the Pallas kernel adj_contrib (mgbtpu/ops/pallas_dd.py:228),
// which produced the (C, N) per-slot contributions in double-float and left
// the scatter into n_J to XLA. Here the same two steps run as two coalesced
// phases of adjoint.cuh from one entry: per-slot contributions with the
// slots on neighbouring threads, then each column's fixed-order sum over
// its slots, by a thread or a block per column as K asks; phase A splits
// the sums of a level of few elements over many blocks, in slabs of rows,
// and streams a wide element's panel rows (the fem3d Q3 hexes) into shared
// memory by TMA bulk copies through a ring of stages, one element a CTA,
// in the staged form's order (adjoint.cuh). No atomics, so the result has
// the same bits on every run. Bound on an H100: bytes (panels read once, 2
// flops per 8 bytes).
#include <cstdint>
#include <cuda_runtime.h>

#include "adjoint.cuh"

// The phase-A form panel_adj_launch takes for this shape and request
// (adjoint_form; 0: refused).
extern "C" int panel_adj_form(int nD, int N, int p, int C, int form) {
    return adjoint_form(nD, N, p, C, form);
}

// form: 0 by shape, 1 the staged phase A, 3 the spread phase A, 4 the
// bulk phase A; part: the spread form's N x slabs x C doubles of slab
// partials (null for the others).
extern "C" int panel_adj_launch(const void* panels, const void* inv,
                                const void* Y, void* contrib, void* part,
                                void* out, int nD, int N, int p, int C,
                                int n_J, int K, int form, void* stream) {
    cudaError_t e = adjoint_launch(
        (const double*)panels, (const int64_t*)inv, (const double*)Y,
        (double*)contrib, (double*)part, (double*)out, nD, N, p, C, n_J, K,
        form, (cudaStream_t)stream);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Phase A alone, for one shard of a mesh: its per-slot contributions.
extern "C" int panel_adj_contrib_launch(const void* panels, const void* Y,
                                        void* contrib, void* part, int nD,
                                        int N, int p, int C, int form,
                                        void* stream) {
    cudaError_t e = adjoint_contrib_launch(
        (const double*)panels, (const double*)Y, (double*)contrib,
        (double*)part, nD, N, p, C, form, (cudaStream_t)stream);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Phase B alone: out (n_J,) from the contributions of every slot of a
// level (N*C,), e.g. each shard's concatenated on the first device.
extern "C" int panel_adj_sum_launch(const void* inv, const void* contrib,
                                    void* out, int N, int C, int n_J, int K,
                                    void* stream) {
    cudaError_t e = adjoint_sum_launch((const int64_t*)inv,
                                       (const double*)contrib, (double*)out,
                                       N, C, n_J, K, (cudaStream_t)stream);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The bulk form's rows a stage and stages from now on (0: the rule's,
// adj_bulk); neither moves the order. For timing runs
// (tools/k3_form_times.py).
extern "C" void panel_adj_bulk_tune(int rows, int stages) {
    adj_bulk_rows = rows > 0 ? rows : 0;
    adj_bulk_stages = stages > 1 ? stages : 0;
}

// The bulk form's layout at (nD, p, C) on the current card: out[0..4] =
// rows a stage, stages, consumer threads, shared bytes a CTA, and CTAs an
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int panel_adj_bulk_layout(int nD, int p, int C, int* out) {
    const AdjBulk b = adj_bulk(nD, p, C, adj_bulk_rows, adj_bulk_stages);
    auto kern = b.spt == 2 ? adjoint_contrib_bulk_kernel<2>
                           : adjoint_contrib_bulk_kernel<1>;
    cudaError_t e = adj_bulk_opt_in(kern, b);
    int ctas = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern,
                                                          32 + b.T, b.total);
    out[0] = b.R;
    out[1] = b.S;
    out[2] = b.T;
    out[3] = (int)b.total;
    out[4] = ctas;
    return (int)e;
}

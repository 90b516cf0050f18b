// panel_adj: adjoint panel product scattered into n_J, f64.
//
//   out[j] = sum_{(e, c): cols[e, c] = j} sum_q sum_k panels[k, e, q, c] * Y[e*p + q, k]
//
// Replaces the Pallas kernel adj_contrib (mgbtpu/ops/pallas_dd.py:228),
// which produced the (C, N) per-slot contributions in double-float and left
// the scatter into n_J to XLA. Here the same two steps run as two coalesced
// phases of adjoint.cuh from one entry: per-slot contributions with the
// slots on neighbouring threads, then each column's fixed-order sum over
// its slots, by a thread or a block per column as K asks; phase A spreads
// a level of few elements over many blocks (adjoint.cuh). No atomics, so
// the result has the same bits on every run.
// Bound on an H100: bytes (panels read once, 2 flops per 8 bytes).
#include <cstdint>
#include <cuda_runtime.h>

#include "adjoint.cuh"

// The phase-A form panel_adj_launch takes for this shape and request
// (adjoint_form; 0: refused).
extern "C" int panel_adj_form(int nD, int N, int p, int C, int form) {
    return adjoint_form(nD, N, p, C, form);
}

// form: 0 by shape, 1 the staged phase A, 3 the spread phase A.
extern "C" int panel_adj_launch(const void* panels, const void* inv,
                                const void* Y, void* contrib, void* out,
                                int nD, int N, int p, int C, int n_J, int K,
                                int form, void* stream) {
    cudaError_t e = adjoint_launch(
        (const double*)panels, (const int64_t*)inv, (const double*)Y,
        (double*)contrib, (double*)out, nD, N, p, C, n_J, K, form,
        (cudaStream_t)stream);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Phase A alone, for one shard of a mesh: its per-slot contributions.
extern "C" int panel_adj_contrib_launch(const void* panels, const void* Y,
                                        void* contrib, int nD, int N, int p,
                                        int C, int form, void* stream) {
    cudaError_t e = adjoint_contrib_launch(
        (const double*)panels, (const double*)Y, (double*)contrib, nD, N, p,
        C, form, (cudaStream_t)stream);
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

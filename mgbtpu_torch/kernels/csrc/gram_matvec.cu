// gram_matvec: matrix-free Gram-form Hessian apply, fused, f64.
//
//   H v = P^T L L^T P v   with per-node lower factors L (bw*F2 = L L^T):
//   Pv[q, j]  = sum_c panels[j, e, q, c] * v[cols[e, c]]      (gather + forward)
//   B[q, i]   = sum_j L[e*p+q, j, i] * Pv[q, j]                (L^T)
//   W[q, j]   = sum_i L[e*p+q, j, i] * B[q, i]                 (L)
//   out[col]  = sum over the column's slots of sum_{q,k} panels[k, e, q, c] W[q, k]
//
// Replaces the Pallas kernel ymv_contrib (mgbtpu/ops/pallas_dd.py:142),
// which applied the dd node blocks Y directly; the x64 reference runs the
// Lnode form (mgbtpu/solver/levelops.py:304-313), and so does this kernel.
//
// Bound on an H100: bytes (the panels and the factors read once, a few
// flops per 8 bytes); at the L=5 sizes the working set sits in L2 and the
// call is bound by its launches and the latency of its loads.
//
// Design: two kernels. The first takes EB elements a block: it stages their
// panels (for each k the run of EB elements is contiguous) and their node
// factors into shared memory with cp.async, gathers v[cols] once per slot
// (one thread a slot), then forms Pv, L^T Pv and W = L L^T Pv per node from
// shared memory and keeps W there; last, one thread a slot computes the
// slot's contribution from the staged panels and W in phase A's fixed
// (k, q) order (adjoint.cuh). So the panels leave device memory once and W
// never does. The second kernel is phase B of adjoint.cuh, unchanged: each
// column's fixed-order sum over its slots, launched as a programmatic
// dependent. No atomics: every run gives the same bits. The sums run in the
// order of the three-kernel form this replaces, so the bits are its bits.
// EB is the most elements the block's threads and a shared-memory budget
// of two blocks an SM allow, and no more than fills the SMs once.
//
// The first kernel needs one element's panels and factors in shared memory
// at once: 349,280 bytes at the fem3d Q3 top level (p = 64, nD = 5,
// C = 128), past the 232,448 a block can have. For such an element the
// wide form (gram_wide_kernel) takes one element a block: it stages the
// node factors and v[cols] whole, and the panel rows CC columns at a time
// (panel_chunk.cuh), each thread carrying its Pv sums (at most GW_ROWS)
// from chunk to chunk in the same order; then L^T and L as above; then one
// thread a slot sums the slot's contribution in phase A's (k, q) order,
// reading the panels again, coalesced along the slots, from device memory
// (L2: the element's panels were read a moment before). The same sums in
// the same order: the same bits as the first kernel where both apply.
// Phase B follows unchanged. The C entry takes the first kernel whenever
// one element fits it, the wide form otherwise (or either on request, for
// the card tests).
#include <cstdint>
#include <cuda_runtime.h>

#include "adjoint.cuh"
#include "cpasync.cuh"
#include "panel_chunk.cuh"

#define GM_THREADS 128
#define GM_BUDGET (96 * 1024)    // bytes of shared memory a block aims at
#define GM_SMEM_MAX 232448       // the most a block can have on sm_90
#define GW_THREADS 256           // the wide form's threads
#define GW_ROWS 4                // Pv sums a wide-form thread carries
#define GW_BUDGET (112 * 1024)   // the wide form's shared memory: 2 an SM,
                                 // or up to GM_SMEM_MAX for wide factors

// P > 0: p == P at compile time (7, the P2 element)
template <int P>
__global__ void __launch_bounds__(GM_THREADS)
    gram_fused_kernel(const double* __restrict__ panels,
                      const int64_t* __restrict__ cols,
                      const double* __restrict__ Lnode,
                      const double* __restrict__ v,
                      double* __restrict__ contrib, int nD, int N, int p,
                      int C, int EB, int sk) {
    extern __shared__ __align__(16) double sm[];
    if (P > 0) p = P;
    const int pn = p * nD, nn = nD * nD;
    const int e0 = blockIdx.x * EB, ne = min(EB, N - e0);
    const int tid = threadIdx.x;
    const size_t kstride = (size_t)N * p * C;
    const double* pb = panels + (size_t)e0 * p * C;
    const double* lb = Lnode + (size_t)e0 * pn * nD;
    // each staged run sits at its source's parity (cpasync.cuh)
    const int hp = odd8(pb), ks1 = (int)(kstride & 1), hl = odd8(lb);
    double* sP = sm;                          // nD runs of sk doubles
    double* sL = sP + (size_t)nD * sk + hl;   // EB*p node factors
    double* sv = sL - hl + (size_t)EB * pn * nD + 2;  // EB*C: v[cols]
    double* sPv = sv + EB * C;                // EB*pn
    double* sB = sPv + EB * pn;               // EB*pn
    double* sW = sB + EB * pn;                // EB*pn
    pdl_wait();
    pdl_trigger();
    const int run = ne * p * C;
    const int np = cp_pieces(run, 1);
    for (int t = tid; t < nD * np; t += GM_THREADS) {
        const int k = t / np, q = t - k * np;
        const int h = hp ^ (k & ks1);
        if (q < cp_pieces(run, h))
            cp_piece(sP + (size_t)k * sk + h, pb + k * kstride, run, h, q);
    }
    cp_run(sL, lb, ne * pn * nD, tid, GM_THREADS);
    const int64_t* cb = cols + (size_t)e0 * C;
    for (int t = tid; t < ne * C; t += GM_THREADS) sv[t] = v[cb[t]];
    cp_async_wait_all();
    __syncthreads();

    for (int r = tid; r < ne * pn; r += GM_THREADS) {  // Pv
        const int eq = r / nD, j = r - eq * nD;         // eq = el*p + q
        const double* pj = sP + (size_t)j * sk + (hp ^ (j & ks1)) + eq * C;
        const double* ve = sv + (eq / p) * C;
        double acc = 0.0;
        for (int c = 0; c < C; ++c) acc += pj[c] * ve[c];
        sPv[r] = acc;
    }
    __syncthreads();
    for (int r = tid; r < ne * pn; r += GM_THREADS) {  // B = L^T Pv
        const int eq = r / nD, i = r - eq * nD;
        const double* Lq = sL + eq * nn;
        const double* x = sPv + eq * nD;
        double acc = 0.0;
        for (int j = i; j < nD; ++j) acc += Lq[j * nD + i] * x[j];
        sB[r] = acc;
    }
    __syncthreads();
    for (int r = tid; r < ne * pn; r += GM_THREADS) {  // W = L B
        const int eq = r / nD, j = r - eq * nD;
        const double* Lq = sL + eq * nn + j * nD;
        const double* x = sB + eq * nD;
        double acc = 0.0;
        for (int i = 0; i <= j; ++i) acc += Lq[i] * x[i];
        sW[r] = acc;
    }
    __syncthreads();
    for (int t = tid; t < ne * C; t += GM_THREADS) {  // phase A's order
        const int el = t / C, c = t - el * C;
        const double* pe = sP + (size_t)el * p * C + c;
        const double* ye = sW + el * pn;
        double s = 0.0;
#pragma unroll 4
        for (int k = 0; k < nD; ++k) {
            const double* pk = pe + (size_t)k * sk + (hp ^ (k & ks1));
#pragma unroll
            for (int q = 0; q < (P > 0 ? P : p); ++q)
                s += pk[q * C] * ye[q * nD + k];
        }
        contrib[(size_t)(e0 + el) * C + c] = s;
    }
}

// The wide form: block e takes element e; chunk row r = q*nD + j holds
// panels[j, e, q, c0 ..], so thread r's Pv sum reads its own row.
__global__ void __launch_bounds__(GW_THREADS)
    gram_wide_kernel(const double* __restrict__ panels,
                     const int64_t* __restrict__ cols,
                     const double* __restrict__ Lnode,
                     const double* __restrict__ v,
                     double* __restrict__ contrib, int nD, int N, int p,
                     int C, int CC) {
    extern __shared__ __align__(16) double sm[];
    const int pn = p * nD, nn = nD * nD, ld = CC + 2;
    const int e = blockIdx.x, tid = threadIdx.x;
    const size_t kstride = (size_t)N * p * C;
    const double* pe = panels + (size_t)e * p * C;
    const double* lb = Lnode + (size_t)e * pn * nD;
    const int hl = odd8(lb);
    double* sP = sm;                            // pn chunk rows of ld
    double* sL = sP + (size_t)pn * ld + hl;     // the p node factors
    double* sv = sL - hl + (size_t)pn * nD + 2; // C: v[cols]
    double* sPv = sv + C;                       // pn
    double* sB = sPv + pn;                      // pn
    double* sW = sB + pn;                       // pn
    pdl_wait();
    pdl_trigger();
    cp_run(sL, lb, pn * nD, tid, GW_THREADS);
    const int64_t* cb = cols + (size_t)e * C;
    for (int t = tid; t < C; t += GW_THREADS) sv[t] = v[cb[t]];
    double acc[GW_ROWS];
#pragma unroll
    for (int u = 0; u < GW_ROWS; ++u) acc[u] = 0.0;
    for (int c0 = 0; c0 < C; c0 += CC) {  // Pv, a chunk of columns at a time
        const int n = min(CC, C - c0);
        cp_panel_chunk(sP, ld, pe, kstride, C, nD, pn, c0, n, tid,
                       GW_THREADS);
        cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int u = 0; u < GW_ROWS; ++u) {
            const int r = tid + u * GW_THREADS;
            if (r < pn) {
                const double* pj =
                    sP + (size_t)r * ld +
                    odd8(panel_row(pe, kstride, C, nD, r) + c0);
                const double* vc = sv + c0;
                for (int c = 0; c < n; ++c) acc[u] += pj[c] * vc[c];
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < GW_ROWS; ++u) {
        const int r = tid + u * GW_THREADS;
        if (r < pn) sPv[r] = acc[u];
    }
    __syncthreads();
    for (int r = tid; r < pn; r += GW_THREADS) {  // B = L^T Pv
        const int q = r / nD, i = r - q * nD;
        const double* Lq = sL + q * nn;
        const double* x = sPv + q * nD;
        double a = 0.0;
        for (int j = i; j < nD; ++j) a += Lq[j * nD + i] * x[j];
        sB[r] = a;
    }
    __syncthreads();
    for (int r = tid; r < pn; r += GW_THREADS) {  // W = L B
        const int q = r / nD, j = r - q * nD;
        const double* Lq = sL + q * nn + j * nD;
        const double* x = sB + q * nD;
        double a = 0.0;
        for (int i = 0; i <= j; ++i) a += Lq[i] * x[i];
        sW[r] = a;
    }
    __syncthreads();
    for (int c = tid; c < C; c += GW_THREADS) {  // phase A's order
        const double* pc = pe + c;
        double a = 0.0;
        for (int k = 0; k < nD; ++k) {
            const double* pk = pc + k * kstride;
#pragma unroll 8
            for (int q = 0; q < p; ++q) a += pk[(size_t)q * C] * sW[q * nD + k];
        }
        contrib[(size_t)e * C + c] = a;
    }
}

static int fit_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// form: 0 by shape (the first kernel where one element fits it), 1 the
// first kernel, 2 the wide form; a form that cannot take the shape is
// refused (cudaErrorInvalidValue). With out null, the per-slot
// contributions alone (one shard of a mesh: the first device sums every
// shard's with panel_adj_sum_launch).
extern "C" int gram_matvec_launch(const void* panels, const void* cols,
                                  const void* inv, const void* Lnode,
                                  const void* v, void* contrib, void* out,
                                  int nD, int N, int p, int C, int n_J, int K,
                                  int form, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (form < 0 || form > 2) return (int)cudaErrorInvalidValue;
    if (N > 0 && C > 0) {
        const int pn = p * nD;
        // doubles an element stages, and those a block adds (the shifts)
        const size_t per = (size_t)nD * p * C + (size_t)pn * nD + C + 3 * pn;
        const size_t fixed = 2 * (size_t)nD + 4;
        auto smem_of = [&](int eb) {  // the first kernel's, at EB = eb
            const size_t sk = ((size_t)eb * p * C + 2) & ~(size_t)1;
            return (nD * sk + (size_t)eb * pn * nD + 2 +
                    (size_t)eb * (C + 3 * pn)) * sizeof(double);
        };
        const bool fits = smem_of(1) <= GM_SMEM_MAX;
        if (form == 1 && !fits) return (int)cudaErrorInvalidValue;
        if (form == 2 || !fits) {
            if (pn > GW_ROWS * GW_THREADS) return (int)cudaErrorInvalidValue;
            const size_t other = (size_t)pn * nD + 2 + C + 3 * (size_t)pn;
            int CC = chunk_cols(pn, other, GW_BUDGET, C);
            if (CC <= 0) CC = chunk_cols(pn, other, GM_SMEM_MAX, C);
            if (CC <= 0) return (int)cudaErrorInvalidValue;
            const size_t smem =
                ((size_t)pn * (CC + 2) + other) * sizeof(double);
            int e = fit_smem((const void*)gram_wide_kernel, smem);
            if (e) return e;
            cudaError_t err = launch_pdl(
                gram_wide_kernel, dim3(N), dim3(GW_THREADS), smem, s,
                (const double*)panels, (const int64_t*)cols,
                (const double*)Lnode, (const double*)v, (double*)contrib, nD,
                N, p, C, CC);
            if (err != cudaSuccess) return (int)err;
            if (out)
                err = adjoint_sum_launch((const int64_t*)inv,
                                         (const double*)contrib, (double*)out,
                                         N, C, n_J, K, s);
            return (int)(err != cudaSuccess ? err : cudaGetLastError());
        }
        static int sms = 0;
        if (!sms) {
            int dev = 0;
            cudaGetDevice(&dev);
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            if (sms < 1) sms = 1;
        }
        int EB = GM_THREADS / C;
        const int fit = (int)((GM_BUDGET / sizeof(double) - fixed) / per);
        if (EB > fit) EB = fit;
        const int fill = (N + sms - 1) / sms;
        if (EB > fill) EB = fill;
        if (EB < 1) EB = 1;
        const int sk = (EB * p * C + 2) & ~1;
        const size_t smem = smem_of(EB);
        if (smem > GM_SMEM_MAX) return (int)cudaErrorInvalidValue;
        auto kern = p == 7 ? gram_fused_kernel<7> : gram_fused_kernel<0>;
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        cudaError_t e = launch_pdl(
            kern, dim3((N + EB - 1) / EB), dim3(GM_THREADS), smem, s,
            (const double*)panels, (const int64_t*)cols,
            (const double*)Lnode, (const double*)v, (double*)contrib, nD, N,
            p, C, EB, sk);
        if (e != cudaSuccess) return (int)e;
    }
    if (!out) return (int)cudaGetLastError();
    cudaError_t e = adjoint_sum_launch((const int64_t*)inv,
                                       (const double*)contrib, (double*)out,
                                       N, C, n_J, K, s);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

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
#include <cstdint>
#include <cuda_runtime.h>

#include "adjoint.cuh"
#include "cpasync.cuh"

#define GM_THREADS 128
#define GM_BUDGET (96 * 1024)    // bytes of shared memory a block aims at
#define GM_SMEM_MAX 232448       // the most a block can have on sm_90

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

extern "C" int gram_matvec_launch(const void* panels, const void* cols,
                                  const void* inv, const void* Lnode,
                                  const void* v, void* contrib, void* out,
                                  int nD, int N, int p, int C, int n_J, int K,
                                  void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (N > 0 && C > 0) {
        const int pn = p * nD;
        // doubles an element stages, and those a block adds (the shifts)
        const size_t per = (size_t)nD * p * C + (size_t)pn * nD + C + 3 * pn;
        const size_t fixed = 2 * (size_t)nD + 4;
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
        const size_t smem = (nD * (size_t)sk + (size_t)EB * pn * nD + 2 +
                             (size_t)EB * (C + 3 * pn)) * sizeof(double);
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
    cudaError_t e = adjoint_sum_launch((const int64_t*)inv,
                                       (const double*)contrib, (double*)out,
                                       N, C, n_J, K, s);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

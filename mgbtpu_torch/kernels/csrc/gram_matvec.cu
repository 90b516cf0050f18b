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
// C = 128), past the 232,448 a block can have. Such an element takes the
// cluster form (gram_cluster_kernel): one element to a thread-block cluster
// of R CTAs (R = 1, 2, 4 or 8). CTA r owns the element's nodes
// q in [r p / R, (r + 1) p / R) for every slab k; those rows are one
// contiguous run of panels[k, e, q0:q1, :], which it loads into its shared
// memory once, by TMA bulk copies (tma.cuh), one mbarrier a slab, so that
// P v starts on slab k while the later slabs land. Its node factors and
// v[cols] are staged with cp.async beside them. The sums, in an order of
// the form's own (gram_matvec_cluster_plain, gram_matvec.py, is that order
// in plain PyTorch and gives its bits):
//   P v:   row (q, k) on one warp (node q's rows on warp q % warps), lane l
//          folding columns 2j, 2j + 1 for j = l, l + 32, ... in order from
//          0.0, then a fixed shuffle tree (K1's split order,
//          panel_fwd_split_plain);
//   L^T, L: node by node as the first kernel, on the node's warp;
//   phase A: each CTA's partial of slot c over its rows in (k, q) order
//          from 0.0, from shared memory, written into the shared memory of
//          the CTA that owns slot c (the slots split evenly over the
//          ranks; distributed shared memory); after one cluster barrier the
//          owner adds the R partials in rank order 0 .. R-1. (Pushing the
//          partials, not pulling them, takes one cluster barrier where
//          pulling takes two; a barrier arrival at the start, waited on
//          before the first push, makes sure every CTA has started.)
// No atomics: every run gives the same bits. Phase B follows unchanged.
// What bounds it: bytes, the panels read once (327,680 bytes an element at
// the fem3d top level, 786,432 in its phase-I system). A CTA holds its
// slabs from their landing to its exit, and its chain of sums and barriers
// runs while no bytes move for it, so throughput comes from many CTAs an
// SM: R is the largest the card takes (8 at every fem3d shape: 45,312
// bytes a CTA at the top level, five an SM; R = 2 and 4, fewer and larger
// CTAs, and 16, past the portable size, were each slower, PERF.md).
// The C entry takes the first kernel whenever one element fits it, the
// cluster form otherwise (or either on request, for the card tests); it
// refuses the cluster form (cudaErrorInvalidValue) where a CTA's run is not
// 16-byte aligned in device memory or in size, and where the card can hold
// no cluster of the launch.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "adjoint.cuh"
#include "cpasync.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

#define GM_THREADS 128
#define GM_BUDGET (96 * 1024)    // bytes of shared memory a block aims at
#define GM_SMEM_MAX 232448       // the most a block can have on sm_90
#define CL_MAX 8                 // the largest cluster (portable)
#define CL_CHUNK (16 * 1024)     // bytes a bulk copy moves at most

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

// The cluster form's shared memory (byte offsets): nD slabs' barriers,
// nD slabs of `sk` doubles (even, at least the most nodes a rank owns x
// C), then the node factors (shifted to their source's parity), v[cols],
// Pv (then W), B and the partials of the slots the rank owns, R x
// ceil(C / R) (rank r's of slot c at r * ceil(C / R) + c - c0). At the
// fem3d top level (R = 8) that is 45,312 bytes: five CTAs an SM.
struct ClusterLayout {
    int nq, sk;  // the most nodes a rank owns; a slab's stride
    size_t slabs, fac, sv, pv, b, w, part, total;  // byte offsets, size
};

__host__ __device__ inline ClusterLayout cluster_layout(int nD, int p, int C,
                                                        int R) {
    ClusterLayout l;
    l.nq = (p + R - 1) / R;
    l.sk = (l.nq * C + 1) & ~1;
    const int pn = l.nq * nD;
    l.slabs = ((size_t)nD * 8 + 15) & ~(size_t)15;  // past the barriers
    l.fac = l.slabs + (size_t)nD * l.sk * 8;
    l.sv = l.fac + ((size_t)pn * nD + 2) * 8;
    l.pv = l.sv + (size_t)C * 8;
    l.b = l.pv + (size_t)pn * 8;
    l.w = l.pv;  // W over Pv, which B has read
    l.part = l.b + (size_t)pn * 8;
    l.total = l.part + (size_t)R * ((C + R - 1) / R) * 8;
    return l;
}

// Grid N*R, clusters of R: cluster e takes element e, its rank r the nodes
// [r p / R, (r + 1) p / R). The note at the top gives the order.
__global__ void gram_cluster_kernel(const double* __restrict__ panels,
                                    const int64_t* __restrict__ cols,
                                    const double* __restrict__ Lnode,
                                    const double* __restrict__ v,
                                    double* __restrict__ contrib, int nD,
                                    int N, int p, int C, int R) {
    extern __shared__ __align__(16) unsigned char smb[];
    cg::cluster_group cluster = cg::this_cluster();
    const ClusterLayout lay = cluster_layout(nD, p, C, R);
    const int r = (int)cluster.block_rank();
    const int e = blockIdx.x / R, tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, warps = nt >> 5;
    const int q0 = r * p / R, nq = (r + 1) * p / R - q0;
    const int pn = nq * nD, nn = nD * nD;
    const size_t kstride = (size_t)N * p * C;
    uint64_t* bars = (uint64_t*)smb;
    double* sP = (double*)(smb + lay.slabs);
    const double* lb = Lnode + ((size_t)e * p + q0) * nn;
    double* sL = (double*)(smb + lay.fac) + odd8(lb);
    double* sv = (double*)(smb + lay.sv);
    double* sPv = (double*)(smb + lay.pv);
    double* sB = (double*)(smb + lay.b);
    double* sW = (double*)(smb + lay.w);
    double* recv = (double*)(smb + lay.part);
    const int cw = (C + R - 1) / R;  // a rank's row of recv
    // the level's column map is written when its panels are built, by no
    // kernel of a solve: read before pdl_wait() (pdl.cuh), its latency
    // hidden
    const int64_t* cb = cols + (size_t)e * C;
    const int64_t col0 = tid < C ? cb[tid] : 0;
    if (tid == 0) {
        for (int k = 0; k < nD; ++k) mbar_init(bars + k, 1);
        mbar_init_fence();
    }
    __syncthreads();
    // this CTA has started: the others may write its recv once they have
    // waited for every CTA's arrival (below, before the first such write)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    pdl_wait();
    pdl_trigger();
    const unsigned run = (unsigned)nq * C * 8;  // a slab's bytes
    if (warp == 0 && run > 0) {
        const double* src = panels + ((size_t)e * p + q0) * C;
        for (int k = lane; k < nD; k += 32) mbar_expect(bars + k, run);
        __syncwarp();
        const int pieces = (run + CL_CHUNK - 1) / CL_CHUNK;
        for (int t = lane; t < nD * pieces; t += 32) {
            const int k = t / pieces, i = t - k * pieces;
            const unsigned off = (unsigned)i * CL_CHUNK;
            const unsigned n = min((unsigned)CL_CHUNK, run - off);
            bulk_copy((unsigned char*)(sP + (size_t)k * lay.sk) + off,
                      (const unsigned char*)(src + k * kstride) + off, n,
                      bars + k);
        }
    }
    cp_run(sL, lb, pn * nD, tid, nt);
    if (tid < C) cp_async8(sv + tid, v + col0);
    for (int t = tid + nt; t < C; t += nt) cp_async8(sv + t, v + cb[t]);
    cp_async_wait_all();
    __syncthreads();

    const bool pairs = (C & 1) == 0;  // rows start 16-byte aligned
    auto fold = [&](const double* row, double a, int c) {
        if (pairs) {
            const double2 x = *(const double2*)(row + c);
            a = a + x.x * sv[c];
            return a + x.y * sv[c + 1];
        }
        a = a + row[c] * sv[c];
        return c + 1 < C ? a + row[c + 1] * sv[c + 1] : a;
    };
    // node q is warp q % warps's: its Pv rows, then its B and W, so that
    // the warp waits on itself alone until phase A
    for (int k = 0; k < nD; ++k) {  // Pv, slab by slab as they land
        mbar_wait(bars + k, 0);
        const double* sk = sP + (size_t)k * lay.sk;
        // two rows a warp at a time (rows q and q + warps), apart
        for (int q = warp; q < nq; q += 2 * warps) {
            const int q2 = q + warps < nq ? q + warps : q;
            const double* ra = sk + (size_t)q * C;
            const double* rb = sk + (size_t)q2 * C;
            double a = 0.0, b = 0.0;
            for (int c = 2 * lane; c < C; c += 64) {
                a = fold(ra, a, c);
                b = fold(rb, b, c);
            }
            a = adj_warp_tree(a);
            b = adj_warp_tree(b);
            if (lane == 0) {
                sPv[q * nD + k] = a;
                sPv[q2 * nD + k] = b;
            }
        }
    }
    const int mine = warp < nq ? (nq - warp + warps - 1) / warps * nD : 0;
    __syncwarp();
    for (int u = lane; u < mine; u += 32) {  // B = L^T Pv
        const int q = warp + u / nD * warps, i = u % nD;
        const double* Lq = sL + q * nn;
        const double* x = sPv + q * nD;
        double a = 0.0;
        for (int j = i; j < nD; ++j) a += Lq[j * nD + i] * x[j];
        sB[q * nD + i] = a;
    }
    __syncwarp();
    for (int u = lane; u < mine; u += 32) {  // W = L B
        const int q = warp + u / nD * warps, j = u % nD;
        const double* Lq = sL + q * nn + j * nD;
        const double* x = sB + q * nD;
        double a = 0.0;
        for (int i = 0; i <= j; ++i) a += Lq[i] * x[i];
        sW[q * nD + j] = a;
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // this rank's partial of slot c, (k, q) order, into the recv row of
    // the rank that owns c
    for (int c = tid; c < C; c += nt) {
        double a = 0.0;
        for (int k = 0; k < nD; ++k) {
            const double* pk = sP + (size_t)k * lay.sk + c;
#pragma unroll 8
            for (int q = 0; q < nq; ++q) a += pk[(size_t)q * C] * sW[q * nD + k];
        }
        const int o = ((c + 1) * R - 1) / C;  // c in [o C / R, (o + 1) C / R)
        cluster.map_shared_rank(recv, o)[r * cw + c - o * C / R] = a;
    }
    cluster.sync();  // every partial in its owner's recv; none read remotely
    for (int c = r * C / R + tid; c < (r + 1) * C / R; c += nt) {
        const int i = c - r * C / R;
        double a = recv[i];
        for (int rr = 1; rr < R; ++rr) a = a + recv[rr * cw + i];
        contrib[(size_t)e * C + c] = a;
    }
}

static int cluster_threads(int C) {  // a thread a slot, 64 to 256
    const int t = (C + 31) & ~31;
    return t < 64 ? 64 : t > 256 ? 256 : t;
}

// The cluster form may take up to GM_SMEM_MAX bytes a block on the
// current device.
static cudaError_t cluster_opt_in() {
    return cudaFuncSetAttribute(gram_cluster_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                GM_SMEM_MAX);
}

// Clusters of R CTAs of `smem` bytes and `threads` the current card can
// hold at once (cudaOccupancyMaxActiveClusters), 0 where it can hold none
// or refuses the query (more shared memory than a block can have); cached,
// the query costs microseconds.
static int cluster_occupancy(int R, size_t smem, int threads) {
    struct Seen {
        int dev, R, threads;
        size_t smem;
        int n;
    };
    static Seen seen[32];
    static int n_seen = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    for (int i = 0; i < n_seen; ++i)
        if (seen[i].dev == dev && seen[i].R == R && seen[i].smem == smem &&
            seen[i].threads == threads)
            return seen[i].n;
    int clusters = 0;
    if (cluster_opt_in() == cudaSuccess) {
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = R;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(R);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = smem;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        if (cudaOccupancyMaxActiveClusters(
                &clusters, (const void*)gram_cluster_kernel, &cfg) !=
            cudaSuccess)
            clusters = 0;
    }
    cudaGetLastError();  // a refused query leaves no error behind
    if (n_seen < 32) seen[n_seen++] = Seen{dev, R, threads, smem, clusters};
    return clusters;
}

// Every rank's run of a slab, and every slab's and element's start, a
// multiple of 16 bytes (the base address aside).
static bool cluster_aligned(int p, int C, int R) {
    for (int r = 0; r <= R; ++r)  // r = R: an element's and a slab's start
        if ((((size_t)(r * p / R) * C) & 1)) return false;
    return true;
}

// The cluster size the cluster form takes for this shape: `request` (1, 2,
// 4 or 8) or, with 0, the largest the card takes (more, smaller CTAs an
// element: more of them resident an SM, each with a shorter chain of sums;
// R = 8 was the fastest at every fem3d shape timed, PERF.md); 0 where it
// refuses the shape (the base address aside).
static int cluster_size(int nD, int N, int p, int C, int request) {
    if (N < 1 || C < 1 || nD < 1) return 0;
    const int threads = cluster_threads(C);
    auto takes = [&](int R) {  // aligned runs, and the card holds a cluster
        return R <= p && cluster_aligned(p, C, R) &&
               cluster_occupancy(R, cluster_layout(nD, p, C, R).total,
                                 threads) > 0;
    };
    if (request)
        return (request & (request - 1)) == 0 && request <= CL_MAX &&
                       takes(request)
                   ? request
                   : 0;
    for (int R = CL_MAX; R >= 1; R /= 2)
        if (takes(R)) return R;
    return 0;
}

extern "C" int gram_matvec_cluster_size(int nD, int N, int p, int C,
                                        int request) {
    return cluster_size(nD, N, p, C, request);
}

// The clusters of R the card holds at once for this shape's layout.
extern "C" int gram_matvec_cluster_occupancy(int nD, int p, int C, int R) {
    if (R < 1 || R > CL_MAX || R > p) return 0;
    return cluster_occupancy(R, cluster_layout(nD, p, C, R).total,
                             cluster_threads(C));
}

// The first kernel's shared memory at EB = eb elements a block.
static size_t fused_smem(int nD, int p, int C, int eb) {
    const size_t pn = (size_t)p * nD;
    const size_t sk = ((size_t)eb * p * C + 2) & ~(size_t)1;
    return (nD * sk + (size_t)eb * pn * nD + 2 + (size_t)eb * (C + 3 * pn)) *
           sizeof(double);
}

// The form a launch takes (form 0 by shape, or the form asked for): 1 the
// first kernel, 2 the cluster form; 0 where it refuses the shape (the
// cluster form's base address aside).
extern "C" int gram_matvec_form(int nD, int N, int p, int C, int form) {
    const bool fits = fused_smem(nD, p, C, 1) <= GM_SMEM_MAX;
    if (form == 0) form = fits ? 1 : 2;
    if (form == 1) return fits ? 1 : 0;
    return form == 2 && cluster_size(nD, N, p, C, 0) ? 2 : 0;
}

// form: 0 by shape (the first kernel where one element fits it), 1 the
// first kernel, 2 the cluster form, of R CTAs a cluster (0: by shape); a
// form that cannot take the shape is refused (cudaErrorInvalidValue). With
// out null, the per-slot contributions alone (one shard of a mesh: the
// first device sums every shard's with panel_adj_sum_launch).
extern "C" int gram_matvec_launch(const void* panels, const void* cols,
                                  const void* inv, const void* Lnode,
                                  const void* v, void* contrib, void* out,
                                  int nD, int N, int p, int C, int n_J, int K,
                                  int form, int R, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (form < 0 || form > 2) return (int)cudaErrorInvalidValue;
    if (N > 0 && C > 0) {
        const int pn = p * nD;
        // doubles an element stages, and those a block adds (the shifts)
        const size_t per = (size_t)nD * p * C + (size_t)pn * nD + C + 3 * pn;
        const size_t fixed = 2 * (size_t)nD + 4;
        const bool fits = fused_smem(nD, p, C, 1) <= GM_SMEM_MAX;
        if (form == 1 && !fits) return (int)cudaErrorInvalidValue;
        if (form == 2 || !fits) {
            R = cluster_size(nD, N, p, C, R);
            if (R == 0 || ((uintptr_t)panels & 15))
                return (int)cudaErrorInvalidValue;
            const size_t smem = cluster_layout(nD, p, C, R).total;
            cudaError_t err = cluster_opt_in();
            if (err != cudaSuccess) return (int)err;
            cudaLaunchAttribute attr[2];
            attr[0].id = cudaLaunchAttributeClusterDimension;
            attr[0].val.clusterDim.x = R;
            attr[0].val.clusterDim.y = 1;
            attr[0].val.clusterDim.z = 1;
            attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
            attr[1].val.programmaticStreamSerializationAllowed = 1;
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3((unsigned)N * R);
            cfg.blockDim = dim3(cluster_threads(C));
            cfg.dynamicSmemBytes = smem;
            cfg.stream = s;
            cfg.attrs = attr;
            cfg.numAttrs = 2;
            err = cudaLaunchKernelEx(
                &cfg, gram_cluster_kernel, (const double*)panels,
                (const int64_t*)cols, (const double*)Lnode, (const double*)v,
                (double*)contrib, nD, N, p, C, R);
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
        const size_t smem = fused_smem(nD, p, C, EB);
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

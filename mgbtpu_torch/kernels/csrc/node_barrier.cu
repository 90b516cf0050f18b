// node_barrier: the per-node barrier of any piece table, f64, fused with the
// level's weight mask (bw) and linear term (wc).
//
// A table holds up to 16 pieces over up to 32 rows, each a power cone
// (2 <= nz <= 32, alpha spec 0/1/2) or a linear block (nc, ni <= 32), with
// its input rows idx into the row vector y, and an optional select grid sel
// (m, npc): piece k is active at node n where sel[n, k] != 0 (always,
// without a grid). Per node:
//   mode 0: out[n]       = (bw != 0 ? bw T : 0) + sum_k wc[n,k] y[k]
//   mode 1: out[n, :]    = (bw != 0 ? bw T : 0) + wc[n, :]
//   mode 2: out[n, :, :] =  bw != 0 ? bw T : 0
// where T is the piecewise sum of F0, of F1 scattered to the row width, or
// of F2 scattered to its square, exactly as mgbtpu/convex/piecewise.py
// composes them: each entry is a left fold over the pieces in piece order,
// an inactive piece (and an entry outside a piece's rows) contributing an
// exact +0.0, whatever its barrier is there.
//
// Cobarrier form (nc_co = NC > 0; mgbtpu/convex/*.py C0/C1/C2): the pieces
// read rows 0..NC-2 of y and y[NC-1] is the slack, added to each cone's s
// and to each linear row F_i; the slack's gradient entry, cross row/column
// and corner come from the reference's C1/C2. With the box grids (b, R),
// the phase-I box terms of make_feasibility_fs (mgbtpu/solver/mgb.py:928)
// are added over the rows NC.. of y (one per solution component v_i):
//   F0 += -Log(b-u) - Log(b+u) + sum_i [-Log(R-v_i) - Log(R+v_i)]
// with u = y[NC-1], and their gradient and diagonal Hessian.
//
// Replaces the Pallas kernel node_eval (mgbtpu/ops/pallas_dd.py:258), which
// ran vmap(F) of any traced per-node function in double-float; a lone power
// cone in barrier form that power_cone.cu (K2) takes (nz <= 5, <= 12 rows)
// keeps K2. The closed forms are those of power_cone.cuh and linear.cuh:
// the register instances share K2's pc_ helpers; the runtime-width
// instances take the pcw_ and lnw_ helpers there, mirrors of the pc_ and
// ln_ ones that must change with them (see those headers).
//
// Layout: two kernels per (mode, form), form 0 the barrier, 1 the
// cobarrier, 2 the cobarrier with the box. One thread per node, in blocks
// of 32 nodes (64 above 8,448 nodes, 16 where the rows would pass 48 KB of
// shared memory; past that, halved until the block fits the opt-in 227 KB).
// The block stages its nodes' y, wc (mode 0), sel and every piece's A, b,
// p, mu in shared memory with coalesced cp.async copies. The loop over the
// pieces is a runtime loop that switches, per piece, to the instance of its
// shape (instance codes below; node_barrier.py's instance() picks them).
// The register kernels hold a power cone on <NZ, SPEC> (nz <= 5), a linear
// block on <NC, NI> for the shapes the port's constructors build and a
// runtime-width linear instance for the rest up to 4 x 5; each keeps its
// small arrays in registers, indexed only by unrolled loops. A table with a
// piece past those (a cone of nz = 6..32, a linear block past 4 x 5) runs
// in the wide kernels, where every piece takes a runtime-width instance: a
// cone (cone<0, SPEC>) or a linear block that holds its one vector (z, then
// u = q / r or gz; F, then 1 / F or 1 / F^2) in a per-thread scratch row
// in shared memory and makes every entry of Hz where it is used, with the
// register instances' sums in their order, so their bits. (One kernel with
// both kinds spilled registers in its mode-2 form, on an H100 with CUDA
// 12.9; apart, the register kernels are the code they were, with the
// registers they had.) The table
// goes by reference as a __grid_constant__ parameter, so no kernel has a
// stack frame. Modes 1 and 2 build each node's row or ny x ny block in
// shared memory (odd stride: a warp's threads write distinct banks): filled
// with +0.0, piece 0 writes its entries, each later piece adds its entries
// and adds +0.0 to the entries an earlier piece wrote outside its own
// (which turns a -0.0 into +0.0, as the reference's sum does); the box
// terms come last. The block then stores its rows contiguous, applying bw
// (and wc) on the way out. The row masks are 32-bit: ny <= 32 rows, and
// the slack row of the cobarrier form is row NC - 1 <= 31.
// Bound on an H100: bytes (a few hundred flops per node against the
// ~(pieces' grids + 2 ny + ny^2) doubles it moves) for the register
// instances; the runtime-width cone's A' Hz A takes ~3 nz^4 flops a node.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cpasync.cuh"
#include "linear.cuh"
#include "power_cone.cuh"

#define NB_MAXP 16
#define NB_MAXD 32
#define NB_MAXZ 5           // register-resident cones
#define NB_MAXW 32          // runtime-width cones and wide linear blocks
#define NB_SMEM (48 * 1024)
#define NB_SMEM_MAX 232448  // the opt-in maximum of a block on an H100

// Instance codes: a power cone (nz <= 5, spec) is (nz - 2) * 3 + spec; the
// linear shapes the constructors build (obstacle nc = 2, torsion nc = 1, each
// on one row) follow (on an H100, 3-16 % faster on the obstacle's calls than
// the runtime-width instance; see PERF.md); every other linear block up to
// nc = 4, ni = 5 takes the runtime-width instance. The wide kernels' codes
// follow: the runtime-width cone by spec (any nz up to 32), then the wide
// linear block (nc, ni up to 32).
#define NB_LIN_1x1 12
#define NB_LIN_2x1 13
#define NB_LIN_ANY 14
#define NB_CONE_WIDE 15
#define NB_LIN_WIDE 18

// The table as node_barrier.py fills it (a ctypes mirror; the layout is
// checked when the library loads).
struct NBPiece {
    const double* A;   // power: (m, nz*nz); linear: (m, nc*ni)
    const double* b;   // (m, nz) / (m, nc)
    const double* p;   // power only: (m,)
    const double* mu;  // power only: (m,)
    int kind;          // 0 power cone, 1 linear block
    int nz;            // power: nz; linear: nc
    int ni;            // inputs read: power nz, linear ni
    int spec;          // power: alpha specialisation 0/1/2
    int idx[NB_MAXD];
    int inst;          // instance code (node_barrier.instance)
};

struct NBTable {
    NBPiece pc[NB_MAXP];
    const double* y;     // (m, ny)
    const double* sel;   // (m, npc) or null
    const double* bw;    // (m,)
    const double* wc;    // (m, ny)
    const double* boxb;  // (m,) or null
    const double* boxR;  // (m,) or null
    double* out;
    double floor;
    int npc, mode, m, ny, nc_co;
};

// The kernel's parameter, derived from the table by the C entry.
struct NBKPiece {
    const double *A, *b, *p, *mu;
    int inst, nc, ni;
    unsigned rows;  // output rows the piece writes: idx (+ the slack row)
    unsigned keep;  // bit j: idx[j] is the last occurrence of its row
    int sA, sb, sp, smu;  // staged regions (doubles into shared memory)
    int idx[NB_MAXD];
};

struct NBKTable {
    NBKPiece pc[NB_MAXP];
    const double *y, *sel, *bw, *wc, *boxb, *boxR;
    double* out;
    double floor;
    int npc, m, ny, nin;
    int sy, swc, ssel, sbw, sout;
    int sscr, scrs;  // the wide instances' scratch rows and their stride
};

// doubles a staged region of B rows of w takes: room for the parity shift,
// rounded up to even so that the next region starts 16-byte aligned
static __host__ __device__ __forceinline__ int region(int B, int w) {
    return (B * w + 2) & ~1;
}

// the output row of a node in shared memory: an odd stride
static __host__ __device__ __forceinline__ int out_stride(int mode, int ny) {
    return (mode == 1 ? ny : ny * ny) | 1;
}

// Where the run that starts at src is staged (shifted to its parity).
static __device__ __forceinline__ double* staged(double* sh, int off,
                                                 const double* src) {
    return sh + off + odd8(src);
}

static __device__ __forceinline__ void stage(double* sh, int off,
                                             const double* src, int n, int t,
                                             int nt) {
    cp_run(staged(sh, off, src), src, n, t, nt);
}

// A piece's value h at a shared entry: piece 0 writes it, a later piece
// adds it to the running left fold.
static __device__ __forceinline__ void put(double* e, double h, bool first) {
    *e = first ? h : *e + h;
}

// Where the node's shared row/block holds an earlier piece's entry (rows in
// prev) that the current piece leaves alone (rows in cur, 0 when inactive):
// that piece's exact +0.0 is added.
template <int MODE>
static __device__ __forceinline__ void add_zeros(double* o, unsigned prev,
                                                 unsigned cur, int ny) {
    for (unsigned ra = prev; ra; ra &= ra - 1) {
        const int a = __ffs(ra) - 1;
        if (MODE == 1) {
            if (!(cur >> a & 1)) o[a] = o[a] + 0.0;
            continue;
        }
        const unsigned skip = (cur >> a & 1) ? cur : 0u;
        for (unsigned rc = prev & ~skip; rc; rc &= rc - 1) {
            const int c = __ffs(rc) - 1;
            o[a * ny + c] = o[a * ny + c] + 0.0;
        }
    }
}

struct NodeCtx {
    double* sh;
    int n0, t, ny, nin;
    const double* y;
    double slack, floor;
    double* o;
    double* scr;  // the thread's scratch row (wide instances)
    bool first;
};

template <int SPEC, int MODE, bool CO>
static __device__ __forceinline__ double cone_wide(const NBKPiece& P,
                                                   const NodeCtx& c);

// A power cone on <NZ, SPEC>: mode 0 returns F0; modes 1/2 put its entries.
// (NZ = 0: the runtime-width cone of the wide kernels, cone_wide below.)
template <int NZ, int SPEC, int MODE, bool CO>
static __device__ __forceinline__ double cone(const NBKPiece& P,
                                              const NodeCtx& c) {
    if constexpr (NZ == 0) {
        return cone_wide<SPEC, MODE, CO>(P, c);
    } else {
        int idx[NZ];
#pragma unroll
        for (int j = 0; j < NZ; ++j) idx[j] = P.idx[j];
        const double* A =
            staged(c.sh, P.sA, P.A + (size_t)c.n0 * NZ * NZ) + c.t * NZ * NZ;
        const double* b =
            staged(c.sh, P.sb, P.b + (size_t)c.n0 * NZ) + c.t * NZ;
        const double pn = staged(c.sh, P.sp, P.p + c.n0)[c.t];
        const double mu = staged(c.sh, P.smu, P.mu + c.n0)[c.t];
        double Ar[PC_MAXNZ][PC_MAXNZ], z[PC_MAXNZ];
        pc_affine<NZ>(A, b, c.y, idx, NZ, Ar, z);
        if (CO) z[NZ - 1] = z[NZ - 1] + c.slack;
        const double alpha = 2.0 / pn;
        if (MODE == 0)
            return pc_value<NZ, SPEC>(z, NZ, alpha, mu, SPEC, c.floor);
        const unsigned keep = P.keep;
        if (MODE == 1) {
            double gz[PC_MAXNZ], g[PC_MAXNZ];
            pc_grad<NZ, SPEC>(z, NZ, alpha, mu, SPEC, c.floor, gz);
            pc_at_g<NZ>(Ar, gz, NZ, g);
#pragma unroll
            for (int j = 0; j < NZ; ++j)
                if (keep >> j & 1) put(c.o + idx[j], g[j], c.first);
            if (CO) put(c.o + c.nin, gz[NZ - 1], c.first);
            return 0.0;
        }
        double Hz[PC_MAXNZ][PC_MAXNZ];
        pc_hess<NZ, SPEC>(z, NZ, alpha, mu, SPEC, c.floor, Hz);
        const int ny = c.ny;
        if (CO) {  // the cross column first: Hz's last column dies early
            const int nin = c.nin;
#pragma unroll
            for (int i = 0; i < NZ; ++i) {
                double acc = Ar[0][i] * Hz[0][NZ - 1];
#pragma unroll
                for (int k = 1; k < NZ; ++k)
                    acc = acc + Ar[k][i] * Hz[k][NZ - 1];
                if (keep >> i & 1) {
                    put(c.o + idx[i] * ny + nin, acc, c.first);
                    put(c.o + nin * ny + idx[i], acc, c.first);
                }
            }
            put(c.o + nin * ny + nin, Hz[NZ - 1][NZ - 1], c.first);
        }
        // each entry of A' Hz A goes to shared memory as it is made, so that
        // no more than Ar, Hz and a few sums are live at once
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
            for (int j = 0; j < NZ; ++j)
                if ((keep >> i) & (keep >> j) & 1)
                    put(c.o + idx[i] * ny + idx[j],
                        pc_at_h_a_ij<NZ>(Ar, Hz, i, j), c.first);
        return 0.0;
    }
}

// The runtime-width cone (nz = 6 and up): the closed forms of cone<NZ> in
// the same order (power_cone.cuh's pc_ helpers at NZ = 0 and their pcw_
// mirrors), z and then gz or u in the thread's scratch row c.scr. The grids
// (A, b, p, mu) are the node's, wherever they lie; idx holds the piece's nz
// input rows and keep(i) says whether idx[i] is the last occurrence of its
// row. cone_wide (the wide kernels) reads them where they are staged, the
// table kernels where they lie in global memory.
template <int SPEC, int MODE, bool CO, class Keep>
static __device__ __forceinline__ double cone_rt(const double* A,
                                                 const double* b, double pn,
                                                 double mu, const int* idx,
                                                 int nz, Keep keep,
                                                 const NodeCtx& c) {
    const int nq = nz - 1;
    double* z = c.scr;
    pcw_affine(A, b, c.y, idx, nz, z);
    if (CO) z[nq] = z[nq] + c.slack;
    const double alpha = 2.0 / pn;
    if (MODE == 0) return pc_value<0, SPEC>(z, nz, alpha, mu, SPEC, c.floor);
    if (MODE == 1) {
        pc_grad<0, SPEC>(z, nz, alpha, mu, SPEC, c.floor, z);  // z -> gz
        for (int i = 0; i < nz; ++i)
            if (keep(i)) put(c.o + idx[i], pcw_at_g(A, z, nz, i), c.first);
        if (CO) put(c.o + c.nin, z[nq], c.first);
        return 0.0;
    }
    const PcwHess h = pcw_hess(z, nz, alpha, mu, SPEC, c.floor);
    const int ny = c.ny;
    if (CO) {
        const int nin = c.nin;
        for (int i = 0; i < nz; ++i) {
            if (!keep(i)) continue;
            double acc = A[i] * pcw_hz(h, z, 0, nq);
            for (int k = 1; k < nz; ++k)
                acc = acc + A[k * nz + i] * pcw_hz(h, z, k, nq);
            put(c.o + idx[i] * ny + nin, acc, c.first);
            put(c.o + nin * ny + idx[i], acc, c.first);
        }
        put(c.o + nin * ny + nin, h.H_ss, c.first);
    }
    for (int i = 0; i < nz; ++i) {
        if (!keep(i)) continue;
        for (int j = 0; j < nz; ++j)
            if (keep(j))
                put(c.o + idx[i] * ny + idx[j],
                    pcw_at_h_a_ij(A, h, z, nz, i, j), c.first);
    }
    return 0.0;
}

// keep(i) of the parameter kernels: bit i of the piece's 32-bit mask
struct MaskKeep {
    unsigned m;
    __device__ __forceinline__ bool operator()(int i) const {
        return m >> i & 1;
    }
};

template <int SPEC, int MODE, bool CO>
static __device__ __forceinline__ double cone_wide(const NBKPiece& P,
                                                   const NodeCtx& c) {
    const int nz = P.nc;
    return cone_rt<SPEC, MODE, CO>(
        staged(c.sh, P.sA, P.A + (size_t)c.n0 * nz * nz) + c.t * nz * nz,
        staged(c.sh, P.sb, P.b + (size_t)c.n0 * nz) + c.t * nz,
        staged(c.sh, P.sp, P.p + c.n0)[c.t],
        staged(c.sh, P.smu, P.mu + c.n0)[c.t], P.idx, nz, MaskKeep{P.keep},
        c);
}

// A linear block on <NC, NI> (0, 0: the runtime width).
template <int NC, int NI, int MODE, bool CO>
static __device__ __forceinline__ double linear(const NBKPiece& P,
                                                const NodeCtx& c) {
    constexpr int MC = LnRows<NC>::M, MI = LnCols<NI>::M;
    const int nc = NC > 0 ? NC : P.nc, ni = NI > 0 ? NI : P.ni;
    int idx[MI];
#pragma unroll
    for (int j = 0; j < MI; ++j) idx[j] = j < ni ? P.idx[j] : 0;
    const double* A = staged(c.sh, P.sA, P.A + (size_t)c.n0 * nc * ni)
                      + c.t * nc * ni;
    const double* b = staged(c.sh, P.sb, P.b + (size_t)c.n0 * nc) + c.t * nc;
    double Ar[LN_MAXC][LN_MAXI], F[LN_MAXC];
    ln_affine<NC, NI>(A, b, c.y, idx, nc, ni, Ar, F);
    if (CO) {
#pragma unroll
        for (int i = 0; i < MC; ++i)
            if (i < nc) F[i] = F[i] + c.slack;
    }
    if (MODE == 0) return ln_value<NC>(F, nc, c.floor);
    const unsigned keep = P.keep;
    if (MODE == 1) {
        double g[LN_MAXI], gl;
        ln_grad<NC, NI>(Ar, F, nc, ni, g, &gl);
#pragma unroll
        for (int j = 0; j < MI; ++j)
            if (j < ni && (keep >> j & 1)) put(c.o + idx[j], g[j], c.first);
        if (CO) put(c.o + c.nin, gl, c.first);
        return 0.0;
    }
    double H[LN_MAXI][LN_MAXI], cr[LN_MAXI], cn;
    ln_hess<NC, NI, CO>(Ar, F, nc, ni, H, cr, &cn);
    const int ny = c.ny;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        if (i >= ni || !(keep >> i & 1)) continue;
#pragma unroll
        for (int j = 0; j < MI; ++j)
            if (j < ni && (keep >> j & 1))
                put(c.o + idx[i] * ny + idx[j], H[i][j], c.first);
    }
    if (CO) {
        const int nin = c.nin;
#pragma unroll
        for (int i = 0; i < MI; ++i)
            if (i < ni && (keep >> i & 1)) {
                put(c.o + idx[i] * ny + nin, cr[i], c.first);
                put(c.o + nin * ny + idx[i], cr[i], c.first);
            }
        put(c.o + nin * ny + nin, cn, c.first);
    }
    return 0.0;
}

// The wide linear block (nc or ni past 4 x 5): the closed forms of
// linear<NC, NI> in the same order (linear.cuh's lnw_ helpers), F and then
// 1 / F or 1 / F^2 in the thread's scratch row; the grids, idx and keep as
// cone_rt takes them.
template <int MODE, bool CO, class Keep>
static __device__ __forceinline__ double linear_rt(const double* A,
                                                   const double* b,
                                                   const int* idx, int nc,
                                                   int ni, Keep keep,
                                                   const NodeCtx& c) {
    double* F = c.scr;
    lnw_affine(A, b, c.y, idx, nc, ni, F);
    if (CO)
        for (int i = 0; i < nc; ++i) F[i] = F[i] + c.slack;
    if (MODE == 0) return lnw_value(F, nc, c.floor);
    if (MODE == 1) {
        const double gl = lnw_inv(F, nc);
        for (int i = 0; i < ni; ++i)
            if (keep(i)) put(c.o + idx[i], lnw_grad(A, F, nc, ni, i), c.first);
        if (CO) put(c.o + c.nin, gl, c.first);
        return 0.0;
    }
    const double cn = lnw_inv2<CO>(F, nc);
    const int ny = c.ny;
    for (int i = 0; i < ni; ++i) {
        if (!keep(i)) continue;
        for (int j = 0; j < ni; ++j)
            if (keep(j))
                put(c.o + idx[i] * ny + idx[j],
                    lnw_hess_ij(A, F, nc, ni, i, j), c.first);
    }
    if (CO) {
        const int nin = c.nin;
        for (int i = 0; i < ni; ++i)
            if (keep(i)) {
                const double cr = lnw_cross(A, F, nc, ni, i);
                put(c.o + idx[i] * ny + nin, cr, c.first);
                put(c.o + nin * ny + idx[i], cr, c.first);
            }
        put(c.o + nin * ny + nin, cn, c.first);
    }
    return 0.0;
}

template <int MODE, bool CO>
static __device__ __forceinline__ double linear_wide(const NBKPiece& P,
                                                     const NodeCtx& c) {
    const int nc = P.nc, ni = P.ni;
    return linear_rt<MODE, CO>(
        staged(c.sh, P.sA, P.A + (size_t)c.n0 * nc * ni) + c.t * nc * ni,
        staged(c.sh, P.sb, P.b + (size_t)c.n0 * nc) + c.t * nc, P.idx, nc,
        ni, MaskKeep{P.keep}, c);
}

#define NB_CONE_CASES(Z)                                          \
    case (Z - 2) * 3 + 0: return cone<Z, 0, MODE, CO>(P, c);     \
    case (Z - 2) * 3 + 1: return cone<Z, 1, MODE, CO>(P, c);     \
    case (Z - 2) * 3 + 2: return cone<Z, 2, MODE, CO>(P, c);

template <int MODE, bool CO>
static __device__ __forceinline__ double eval_piece(const NBKPiece& P,
                                                    const NodeCtx& c) {
    switch (P.inst) {
        NB_CONE_CASES(2)
        NB_CONE_CASES(3)
        NB_CONE_CASES(4)
        NB_CONE_CASES(5)
        case NB_LIN_1x1: return linear<1, 1, MODE, CO>(P, c);
        case NB_LIN_2x1: return linear<2, 1, MODE, CO>(P, c);
        default: return linear<0, 0, MODE, CO>(P, c);
    }
}

// The wide kernels' pieces: the runtime-width cone by spec and the wide
// linear block (which take every width, each with the bits of the register
// instance of its shape).
template <int MODE, bool CO>
static __device__ __forceinline__ double eval_wide(const NBKPiece& P,
                                                   const NodeCtx& c) {
    switch (P.inst) {
        case NB_CONE_WIDE + 0: return cone<0, 0, MODE, CO>(P, c);
        case NB_CONE_WIDE + 1: return cone<0, 1, MODE, CO>(P, c);
        case NB_CONE_WIDE + 2: return cone<0, 2, MODE, CO>(P, c);
        default: return linear_wide<MODE, CO>(P, c);
    }
}

// FORM: 0 barrier, 1 cobarrier, 2 cobarrier + box; WIDE: a table with a
// piece past the register instances, every piece in a runtime-width one
template <int MODE, int FORM, bool WIDE>
static __device__ __forceinline__ void node_barrier_body(const NBKTable& tb) {
    constexpr bool CO = FORM > 0, BOX = FORM == 2;
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, B = blockDim.x;
    const int n0 = blockIdx.x * B;
    const int nb = min(B, tb.m - n0);
    const int ny = tb.ny, npc = tb.npc, nin = tb.nin;

    stage(sh, tb.sy, tb.y + (size_t)n0 * ny, nb * ny, t, B);
    if (MODE == 0) stage(sh, tb.swc, tb.wc + (size_t)n0 * ny, nb * ny, t, B);
    if (tb.sel) stage(sh, tb.ssel, tb.sel + (size_t)n0 * npc, nb * npc, t, B);
    for (int k = 0; k < npc; ++k) {
        const NBKPiece& P = tb.pc[k];
        const int wb = P.nc, wa = P.nc * P.ni;
        stage(sh, P.sA, P.A + (size_t)n0 * wa, nb * wa, t, B);
        stage(sh, P.sb, P.b + (size_t)n0 * wb, nb * wb, t, B);
        if (P.p) {
            stage(sh, P.sp, P.p + n0, nb, t, B);
            stage(sh, P.smu, P.mu + n0, nb, t, B);
        }
    }
    const int n = n0 + t;
    const bool live = t < nb;
    double bw = 0.0, bb = 0.0, R = 0.0;
    if (live) {
        bw = tb.bw[n];
        if (BOX) {
            bb = tb.boxb[n];
            R = tb.boxR[n];
        }
    }
    const int sos = out_stride(MODE, ny);
    double* o = sh + tb.sout + t * sos;
    if (MODE > 0) {
        sh[tb.sbw + t] = bw;
        const int w = MODE == 1 ? ny : ny * ny;
        if (live)
            for (int i = 0; i < w; ++i) o[i] = 0.0;
    }
    cp_async_wait_all();
    __syncthreads();

    if (live) {
        NodeCtx c;
        c.sh = sh;
        c.n0 = n0;
        c.t = t;
        c.ny = ny;
        c.nin = nin;
        c.y = staged(sh, tb.sy, tb.y + (size_t)n0 * ny) + t * ny;
        c.slack = CO ? c.y[nin] : 0.0;
        c.floor = tb.floor;
        c.o = o;
        if constexpr (WIDE) c.scr = sh + tb.sscr + t * tb.scrs;
        const double* sel =
            tb.sel ? staged(sh, tb.ssel, tb.sel + (size_t)n0 * npc) + t * npc
                   : nullptr;
        double T = 0.0;
        unsigned prev = 0;
        for (int k = 0; k < npc; ++k) {
            const NBKPiece& P = tb.pc[k];
            const bool act = sel == nullptr || sel[k] != 0.0;
            if (MODE > 0 && k > 0)
                add_zeros<MODE>(o, prev, act ? P.rows : 0u, ny);
            c.first = k == 0;
            double v = 0.0;
            if constexpr (WIDE) {
                if (act) v = eval_wide<MODE, CO>(P, c);
            } else {
                if (act) v = eval_piece<MODE, CO>(P, c);
            }
            if (MODE == 0) {
                const double e = act ? v : 0.0;
                T = k == 0 ? e : T + e;
            }
            prev |= P.rows;
        }
        const double* y = c.y;
        const double slack = c.slack;
        if (MODE == 0) {
            if (BOX) {
                double sv = 0.0;
                for (int i = nin + 1; i < ny; ++i) {
                    const double ti = -log_barrier(R - y[i], tb.floor)
                                      - log_barrier(R + y[i], tb.floor);
                    sv = i == nin + 1 ? ti : sv + ti;
                }
                T = T - log_barrier(bb - slack, tb.floor)
                    - log_barrier(bb + slack, tb.floor) + sv;
            }
            const double* w =
                staged(sh, tb.swc, tb.wc + (size_t)n0 * ny) + t * ny;
            double lin = w[0] * y[0];
            for (int k = 1; k < ny; ++k) lin = lin + w[k] * y[k];
            tb.out[n] = (bw != 0.0 ? bw * T : 0.0) + lin;
        } else if (BOX && MODE == 1) {
            o[nin] = o[nin] + (1.0 / (bb - slack) - 1.0 / (bb + slack));
            for (int a = nin + 1; a < ny; ++a)
                o[a] = 1.0 / (R - y[a]) - 1.0 / (R + y[a]);
        } else if (BOX) {
            const double ibm = 1.0 / (bb - slack), ibp = 1.0 / (bb + slack);
            o[nin * ny + nin] = o[nin * ny + nin] + (ibm * ibm + ibp * ibp);
            for (int a = nin + 1; a < ny; ++a) {
                const double ivm = 1.0 / (R - y[a]), ivp = 1.0 / (R + y[a]);
                o[a * ny + a] = ivm * ivm + ivp * ivp;
            }
        }
    }
    if (MODE == 0) return;
    __syncthreads();
    // the block's nb rows of w doubles, contiguous in global memory
    const int w = MODE == 1 ? ny : ny * ny;
    const double* so = sh + tb.sout;
    const double* sbw = sh + tb.sbw;
    double* dst = tb.out + (size_t)n0 * w;
    const double* wc = tb.wc + (size_t)n0 * w;
    int row = t / w, x = t - row * w;
    const int dq = B / w, dr = B - dq * w;
    for (int i = t; i < nb * w; i += B) {
        const double bwr = sbw[row];
        double v = bwr != 0.0 ? bwr * so[row * sos + x] : 0.0;
        if (MODE == 1) v = v + wc[i];
        dst[i] = v;
        row += dq;
        x += dr;
        if (x >= w) {
            x -= w;
            ++row;
        }
    }
}

// The register kernels, one per (mode, form)
template <int MODE, int FORM>
__global__ void __launch_bounds__(64)
    node_barrier_kernel(const __grid_constant__ NBKTable tb) {
    node_barrier_body<MODE, FORM, false>(tb);
}

// The wide kernels: at least one block an SM lets ptxas keep their loops'
// values in registers (with the bound of the register kernels it spilled
// 16-24 bytes in three of them, on an H100 with CUDA 12.9)
template <int MODE, int FORM>
__global__ void __launch_bounds__(64, 1)
    node_barrier_wide_kernel(const __grid_constant__ NBKTable tb) {
    node_barrier_body<MODE, FORM, true>(tb);
}

// ---- the table kernels: any number of pieces and rows, any widths ---------
//
// A table past the parameter kernels' limits (more than 16 pieces, more
// than 32 rows, or a cone or linear block wider than 32) does not fit the
// 4 KB __grid_constant__ parameter. node_barrier.py writes it to a device
// buffer: npc NBTPiece records, then the pieces' input rows as one int
// list. Every piece takes the runtime-width instance of its kind (cone_rt,
// linear_rt), reading its grids, the node's rows and its scratch row from
// global memory. A block first derives, in shared memory, each piece's
// output rows and the union of the earlier pieces' rows as arrays of
// 32-bit words (ceil(ny / 32) each), and for each input row whether it is
// the last occurrence of its row; these take the place of the parameter
// kernels' 32-bit masks in add_zeros and keep. A node's row (mode 1) or
// ny x ny block (mode 2) is built in shared memory where 8 or more nodes'
// blocks fit the opt-in 227 KB, and stored as the parameter kernels store
// it; otherwise in the output itself, in global memory, where the node's
// thread then applies bw (and wc) in place. Same left folds, same bits.

struct NBTPiece {
    const double *A, *b, *p, *mu;
    int inst, nc, ni;
    int idx;  // offset of the piece's ni input rows in the int list
};

struct NBTKTable {
    const NBTPiece* pc;
    const int* ints;       // the input rows of every piece
    const double *y, *sel, *bw, *wc, *boxb, *boxR;
    double* out;
    double* scr;           // (m, scrs) scratch rows
    double floor;
    int npc, m, ny, nin, nw, scrs, nidx;
    int sos;               // shared row stride, 0: rows built in global
};

// add_zeros over word masks (cur null: the piece is inactive)
template <int MODE>
static __device__ __forceinline__ void add_zeros_w(double* o,
                                                   const unsigned* prev,
                                                   const unsigned* cur,
                                                   int nw, int ny) {
    for (int wa = 0; wa < nw; ++wa)
        for (unsigned ra = prev[wa]; ra; ra &= ra - 1) {
            const int a = wa * 32 + __ffs(ra) - 1;
            const bool in = cur != nullptr && (cur[wa] >> (a & 31) & 1);
            if (MODE == 1) {
                if (!in) o[a] = o[a] + 0.0;
                continue;
            }
            for (int wb = 0; wb < nw; ++wb) {
                const unsigned skip = in ? cur[wb] : 0u;
                for (unsigned rc = prev[wb] & ~skip; rc; rc &= rc - 1) {
                    const int cc = wb * 32 + __ffs(rc) - 1;
                    o[a * ny + cc] = o[a * ny + cc] + 0.0;
                }
            }
        }
}

// keep(i) of the table kernels: a flag per input row
struct FlagKeep {
    const unsigned char* k;
    __device__ __forceinline__ bool operator()(int i) const { return k[i]; }
};

template <int MODE, bool CO>
static __device__ __forceinline__ double eval_table(const NBTPiece& P,
                                                    const unsigned char* keep,
                                                    const int* idx, int n,
                                                    const NodeCtx& c) {
    const int nc = P.nc, ni = P.ni;
    const double* A = P.A + (size_t)n * nc * ni;
    const double* b = P.b + (size_t)n * nc;
    const FlagKeep k{keep};
    switch (P.inst) {
        case NB_CONE_WIDE + 0:
            return cone_rt<0, MODE, CO>(A, b, P.p[n], P.mu[n], idx, nc, k, c);
        case NB_CONE_WIDE + 1:
            return cone_rt<1, MODE, CO>(A, b, P.p[n], P.mu[n], idx, nc, k, c);
        case NB_CONE_WIDE + 2:
            return cone_rt<2, MODE, CO>(A, b, P.p[n], P.mu[n], idx, nc, k, c);
        default: return linear_rt<MODE, CO>(A, b, idx, nc, ni, k, c);
    }
}

template <int MODE, int FORM>
__global__ void __launch_bounds__(64, 1)
    node_barrier_table_kernel(const __grid_constant__ NBTKTable tb) {
    constexpr bool CO = FORM > 0, BOX = FORM == 2;
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, B = blockDim.x;
    const int n0 = blockIdx.x * B;
    const int nb = min(B, tb.m - n0);
    const int ny = tb.ny, npc = tb.npc, nin = tb.nin, nw = tb.nw;
    const int w = MODE == 1 ? ny : ny * ny;
    // shared: [B rows of sos doubles, B bw] [rows, prev: npc x nw words]
    // [keep: a flag per input row]
    const int sd = tb.sos ? B * tb.sos + B : 0;
    unsigned* rows = reinterpret_cast<unsigned*>(sh + sd);
    unsigned* prev = rows + npc * nw;
    unsigned char* keep = reinterpret_cast<unsigned char*>(prev + npc * nw);
    if (MODE > 0) {
        for (int k = t; k < npc; k += B) {
            const NBTPiece& P = tb.pc[k];
            const int* idx = tb.ints + P.idx;
            unsigned* r = rows + k * nw;
            for (int i = 0; i < nw; ++i) r[i] = 0u;
            if (CO) r[nin >> 5] |= 1u << (nin & 31);
            for (int i = 0; i < P.ni; ++i) {
                r[idx[i] >> 5] |= 1u << (idx[i] & 31);
                bool last = true;
                for (int l = i + 1; l < P.ni; ++l)
                    last = last && idx[l] != idx[i];
                keep[P.idx + i] = last;
            }
        }
        __syncthreads();
        for (int i = t; i < nw; i += B) {
            unsigned acc = 0u;
            for (int k = 0; k < npc; ++k) {
                prev[k * nw + i] = acc;
                acc |= rows[k * nw + i];
            }
        }
    }
    const int n = n0 + t;
    const bool live = t < nb;
    double bw = 0.0;
    double* o = nullptr;
    if (live) bw = tb.bw[n];
    if (MODE > 0) {
        o = tb.sos ? sh + t * tb.sos : tb.out + (size_t)n * w;
        if (tb.sos) sh[B * tb.sos + t] = bw;
        if (live)
            for (int i = 0; i < w; ++i) o[i] = 0.0;
    }
    __syncthreads();

    if (live) {
        NodeCtx c;
        c.sh = sh;
        c.n0 = n0;
        c.t = t;
        c.ny = ny;
        c.nin = nin;
        c.y = tb.y + (size_t)n * ny;
        c.slack = CO ? c.y[nin] : 0.0;
        c.floor = tb.floor;
        c.o = o;
        c.scr = tb.scr + (size_t)n * tb.scrs;
        const double* sel = tb.sel ? tb.sel + (size_t)n * npc : nullptr;
        double T = 0.0;
        for (int k = 0; k < npc; ++k) {
            const NBTPiece& P = tb.pc[k];
            const bool act = sel == nullptr || sel[k] != 0.0;
            if (MODE > 0 && k > 0)
                add_zeros_w<MODE>(o, prev + k * nw, act ? rows + k * nw
                                                        : nullptr, nw, ny);
            c.first = k == 0;
            double v = 0.0;
            if (act)
                v = eval_table<MODE, CO>(P, keep + P.idx, tb.ints + P.idx, n,
                                         c);
            if (MODE == 0) {
                const double e = act ? v : 0.0;
                T = k == 0 ? e : T + e;
            }
        }
        const double* y = c.y;
        const double slack = c.slack;
        double bb = 0.0, R = 0.0;
        if (BOX) {
            bb = tb.boxb[n];
            R = tb.boxR[n];
        }
        if (MODE == 0) {
            if (BOX) {
                double sv = 0.0;
                for (int i = nin + 1; i < ny; ++i) {
                    const double ti = -log_barrier(R - y[i], tb.floor)
                                      - log_barrier(R + y[i], tb.floor);
                    sv = i == nin + 1 ? ti : sv + ti;
                }
                T = T - log_barrier(bb - slack, tb.floor)
                    - log_barrier(bb + slack, tb.floor) + sv;
            }
            const double* wr = tb.wc + (size_t)n * ny;
            double lin = wr[0] * y[0];
            for (int k = 1; k < ny; ++k) lin = lin + wr[k] * y[k];
            tb.out[n] = (bw != 0.0 ? bw * T : 0.0) + lin;
        } else if (BOX && MODE == 1) {
            o[nin] = o[nin] + (1.0 / (bb - slack) - 1.0 / (bb + slack));
            for (int a = nin + 1; a < ny; ++a)
                o[a] = 1.0 / (R - y[a]) - 1.0 / (R + y[a]);
        } else if (BOX) {
            const double ibm = 1.0 / (bb - slack), ibp = 1.0 / (bb + slack);
            o[nin * ny + nin] = o[nin * ny + nin] + (ibm * ibm + ibp * ibp);
            for (int a = nin + 1; a < ny; ++a) {
                const double ivm = 1.0 / (R - y[a]), ivp = 1.0 / (R + y[a]);
                o[a * ny + a] = ivm * ivm + ivp * ivp;
            }
        }
        if (MODE > 0 && !tb.sos) {  // in place, in global memory
            const double* wr = tb.wc + (size_t)n * w;
            for (int i = 0; i < w; ++i) {
                double v = bw != 0.0 ? bw * o[i] : 0.0;
                if (MODE == 1) v = v + wr[i];
                o[i] = v;
            }
        }
    }
    if (MODE == 0 || !tb.sos) return;
    __syncthreads();
    // the block's nb rows of w doubles, contiguous in global memory
    const int sos = tb.sos;
    const double* sbw = sh + B * sos;
    double* dst = tb.out + (size_t)n0 * w;
    const double* wc = tb.wc + (size_t)n0 * w;
    int row = t / w, x = t - row * w;
    const int dq = B / w, dr = B - dq * w;
    for (int i = t; i < nb * w; i += B) {
        const double bwr = sbw[row];
        double v = bwr != 0.0 ? bwr * sh[row * sos + x] : 0.0;
        if (MODE == 1) v = v + wc[i];
        dst[i] = v;
        row += dq;
        x += dr;
        if (x >= w) {
            x -= w;
            ++row;
        }
    }
}

// The instance code of a piece shape, -1 outside the kernel's limits: a
// register instance where one takes the shape, else a runtime-width one.
static int instance_code(int kind, int width, int ni, int spec) {
    if (kind == 0) {
        if (width < 2 || width > NB_MAXW || ni != width || spec < 0 || spec > 2)
            return -1;
        return width <= NB_MAXZ ? (width - 2) * 3 + spec : NB_CONE_WIDE + spec;
    }
    if (kind != 1 || width < 1 || width > NB_MAXW || ni < 1 || ni > NB_MAXW)
        return -1;
    if (ni == 1 && width == 1) return NB_LIN_1x1;
    if (ni == 1 && width == 2) return NB_LIN_2x1;
    return width <= LN_MAXC && ni <= LN_MAXI ? NB_LIN_ANY : NB_LIN_WIDE;
}

// A table with a piece past the register instances runs in the wide
// kernels, where every piece takes its runtime-width instance.
static int wide_code(int kind, int spec) {
    return kind == 0 ? NB_CONE_WIDE + spec : NB_LIN_WIDE;
}

// The doubles of a wide kernel's scratch row (0 in the others): the
// widest vector (nz of a cone, nc of a linear block), at an odd stride.
static int scratch_stride(const NBKTable& k) {
    int w = 0;
    for (int j = 0; j < k.npc; ++j)
        if (k.pc[j].inst >= NB_CONE_WIDE) w = w > k.pc[j].nc ? w : k.pc[j].nc;
    return w ? w | 1 : 0;
}

static int smem_doubles(const NBKTable& k, int mode, int B) {
    int n = region(B, k.ny);
    if (mode == 0) n += region(B, k.ny);
    if (k.sel) n += region(B, k.npc);
    for (int j = 0; j < k.npc; ++j) {
        const NBKPiece& P = k.pc[j];
        n += region(B, P.nc * P.ni) + region(B, P.nc);
        if (P.p) n += 2 * region(B, 1);
    }
    if (mode > 0) n += region(B, 1) + B * out_stride(mode, k.ny);
    return n + B * scratch_stride(k);
}

// Lays the staged regions out for blocks of B nodes.
static void layout(NBKTable& k, int mode, int B) {
    int off = 0;
    auto take = [&](int w) {
        const int at = off;
        off += region(B, w);
        return at;
    };
    k.sy = take(k.ny);
    k.swc = mode == 0 ? take(k.ny) : 0;
    k.ssel = k.sel ? take(k.npc) : 0;
    for (int j = 0; j < k.npc; ++j) {
        NBKPiece& P = k.pc[j];
        P.sA = take(P.nc * P.ni);
        P.sb = take(P.nc);
        P.sp = P.p ? take(1) : 0;
        P.smu = P.p ? take(1) : 0;
    }
    k.sbw = mode > 0 ? take(1) : 0;
    k.sout = off;
    k.scrs = scratch_stride(k);
    k.sscr = off + (mode > 0 ? B * out_stride(mode, k.ny) : 0);
}

// A block past 48 KB of shared memory needs the kernel's opt-in.
template <int MODE, int FORM, bool WIDE>
static cudaError_t launch(dim3 grid, int B, size_t smem, cudaStream_t st,
                          const NBKTable& k) {
    void (*kernel)(const NBKTable) = WIDE
        ? node_barrier_wide_kernel<MODE, FORM>
        : node_barrier_kernel<MODE, FORM>;
    if (smem > NB_SMEM) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<grid, B, smem, st>>>(k);
    return cudaGetLastError();
}

template <int MODE, bool WIDE>
static cudaError_t launch_form(int form, dim3 grid, int B, size_t smem,
                               cudaStream_t st, const NBKTable& k) {
    switch (form) {
        case 0: return launch<MODE, 0, WIDE>(grid, B, smem, st, k);
        case 1: return launch<MODE, 1, WIDE>(grid, B, smem, st, k);
        default: return launch<MODE, 2, WIDE>(grid, B, smem, st, k);
    }
}

template <bool WIDE>
static cudaError_t launch_mode(int mode, int form, dim3 grid, int B,
                               size_t smem, cudaStream_t st,
                               const NBKTable& k) {
    switch (mode) {
        case 0: return launch_form<0, WIDE>(form, grid, B, smem, st, k);
        case 1: return launch_form<1, WIDE>(form, grid, B, smem, st, k);
        default: return launch_form<2, WIDE>(form, grid, B, smem, st, k);
    }
}

// Nodes a block of the last launch (the tests read it where the block's
// rows push it below 16).
static int nb_last_block = 0;
static int nb_last_global = 0;

extern "C" int node_barrier_last_block(void) { return nb_last_block; }

extern "C" int node_barrier_launch(const NBTable* in, void* stream) {
    const NBTable& t = *in;
    if (t.m <= 0) return (int)cudaGetLastError();
    const bool box = t.boxb != nullptr;
    if (t.mode < 0 || t.mode > 2 || t.npc < 1 || t.npc > NB_MAXP || t.ny < 1
        || t.ny > NB_MAXD || (t.nc_co != 0 && (t.nc_co < 2 || t.nc_co > t.ny))
        || (box && (t.nc_co == 0 || t.nc_co >= t.ny || t.boxR == nullptr))
        || (!box && t.nc_co != 0 && t.nc_co != t.ny))
        return (int)cudaErrorInvalidValue;
    const int form = t.nc_co == 0 ? 0 : (box ? 2 : 1);
    NBKTable k = {};
    k.y = t.y;
    k.sel = t.sel;
    k.bw = t.bw;
    k.wc = t.wc;
    k.boxb = t.boxb;
    k.boxR = t.boxR;
    k.out = t.out;
    k.floor = t.floor;
    k.npc = t.npc;
    k.m = t.m;
    k.ny = t.ny;
    k.nin = t.nc_co ? t.nc_co - 1 : t.ny;
    bool wide = false;
    for (int j = 0; j < t.npc; ++j) {
        const NBPiece& P = t.pc[j];
        const int code = instance_code(P.kind, P.nz, P.ni, P.spec);
        if (code < 0) return (int)cudaErrorInvalidValue;
        wide = wide || code >= NB_CONE_WIDE;
    }
    for (int j = 0; j < t.npc; ++j) {
        const NBPiece& P = t.pc[j];
        NBKPiece& Q = k.pc[j];
        const int code = wide ? wide_code(P.kind, P.spec)
                              : instance_code(P.kind, P.nz, P.ni, P.spec);
        if (code != P.inst) return (int)cudaErrorInvalidValue;
        Q.A = P.A;
        Q.b = P.b;
        Q.p = P.kind == 0 ? P.p : nullptr;
        Q.mu = P.kind == 0 ? P.mu : nullptr;
        Q.inst = code;
        Q.nc = P.nz;
        Q.ni = P.ni;
        Q.rows = t.nc_co ? 1u << k.nin : 0u;  // nin <= 31 in this form
        for (int i = 0; i < P.ni; ++i) {
            if (P.idx[i] < 0 || P.idx[i] >= k.nin)
                return (int)cudaErrorInvalidValue;
            Q.idx[i] = P.idx[i];
            Q.rows |= 1u << P.idx[i];
            bool last = true;
            for (int l = i + 1; l < P.ni; ++l)
                last = last && P.idx[l] != P.idx[i];
            if (last) Q.keep |= 1u << i;
        }
    }
    // 32 nodes a block spread fem2d_P2 L=5's 3,584 nodes over 112 SMs;
    // a table past 48 KB at 16 nodes halves them until the block fits
    int B = t.m <= 8448 ? 32 : 64;
    while (B > 16 && sizeof(double) * smem_doubles(k, t.mode, B) > NB_SMEM)
        B /= 2;
    while (B > 1 && sizeof(double) * smem_doubles(k, t.mode, B) > NB_SMEM_MAX)
        B /= 2;
    const size_t smem = sizeof(double) * smem_doubles(k, t.mode, B);
    if (smem > NB_SMEM_MAX) return (int)cudaErrorInvalidValue;
    layout(k, t.mode, B);
    nb_last_block = B;
    nb_last_global = 0;
    const dim3 grid((t.m + B - 1) / B);
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(wide ? launch_mode<true>(t.mode, form, grid, B, smem, st, k)
                      : launch_mode<false>(t.mode, form, grid, B, smem, st,
                                           k));
}

template <int MODE>
static cudaError_t launch_table(int form, dim3 grid, int B, size_t smem,
                                cudaStream_t st, const NBTKTable& k) {
    void (*kernel)(const NBTKTable) =
        form == 0   ? node_barrier_table_kernel<MODE, 0>
        : form == 1 ? node_barrier_table_kernel<MODE, 1>
                    : node_barrier_table_kernel<MODE, 2>;
    if (smem > NB_SMEM) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<grid, B, smem, st>>>(k);
    return cudaGetLastError();
}

// Launch of a table kernel. ``host`` is the table as node_barrier.py wrote
// it (checked here: instance codes, widths, input rows, the scratch
// stride), ``dev`` its copy on the device; nidx is the length of the int
// list after the npc records.
extern "C" int node_barrier_table_launch(
    const NBTPiece* host, const NBTPiece* dev, int npc, int nidx,
    const double* y, const double* sel, const double* bw, const double* wc,
    const double* boxb, const double* boxR, double* out, double* scr,
    double floor, int mode, int m, int ny, int nc_co, int scrs,
    void* stream) {
    if (m <= 0) return (int)cudaGetLastError();
    const bool box = boxb != nullptr;
    if (mode < 0 || mode > 2 || npc < 1 || ny < 1 || nidx < 1
        || (nc_co != 0 && (nc_co < 2 || nc_co > ny))
        || (box && (nc_co == 0 || nc_co >= ny || boxR == nullptr))
        || (!box && nc_co != 0 && nc_co != ny))
        return (int)cudaErrorInvalidValue;
    const int nin = nc_co ? nc_co - 1 : ny;
    const int* ints = reinterpret_cast<const int*>(host + npc);
    int used = 0;
    for (int j = 0; j < npc; ++j) {
        const NBTPiece& P = host[j];
        const bool cone = P.inst >= NB_CONE_WIDE && P.inst < NB_LIN_WIDE;
        if ((cone ? P.nc < 2 || P.ni != P.nc || !P.p || !P.mu
                  : P.inst != NB_LIN_WIDE || P.nc < 1 || P.ni < 1)
            || !P.A || !P.b || P.idx != used || (P.nc | 1) > scrs)
            return (int)cudaErrorInvalidValue;
        for (int i = 0; i < P.ni; ++i)
            if (ints[used + i] < 0 || ints[used + i] >= nin)
                return (int)cudaErrorInvalidValue;
        used += P.ni;
    }
    if (used != nidx) return (int)cudaErrorInvalidValue;
    NBTKTable k = {};
    k.pc = dev;
    k.ints = reinterpret_cast<const int*>(dev + npc);
    k.y = y;
    k.sel = sel;
    k.bw = bw;
    k.wc = wc;
    k.boxb = boxb;
    k.boxR = boxR;
    k.out = out;
    k.scr = scr;
    k.floor = floor;
    k.npc = npc;
    k.m = m;
    k.ny = ny;
    k.nin = nin;
    k.nw = (ny + 31) / 32;
    k.scrs = scrs;
    k.nidx = nidx;
    const size_t masks = mode ? (2 * sizeof(unsigned) * npc * k.nw + nidx
                                 + 7) & ~(size_t)7 : 0;
    int B = 32;
    k.sos = 0;
    if (mode > 0) {
        const int sos = (mode == 1 ? ny : ny * ny) | 1;
        while (B > 8 && sizeof(double) * (size_t)B * (sos + 1) + masks
                            > NB_SMEM_MAX)
            B /= 2;
        if (sizeof(double) * (size_t)B * (sos + 1) + masks <= NB_SMEM_MAX)
            k.sos = sos;
        else
            B = 32;
    }
    const size_t smem =
        (k.sos ? sizeof(double) * (size_t)B * (k.sos + 1) : 0) + masks;
    if (smem > NB_SMEM_MAX) return (int)cudaErrorInvalidValue;
    nb_last_block = B;
    nb_last_global = mode > 0 && !k.sos;
    const int form = nc_co == 0 ? 0 : (box ? 2 : 1);
    const dim3 grid((m + B - 1) / B);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case 0: return (int)launch_table<0>(form, grid, B, smem, st, k);
        case 1: return (int)launch_table<1>(form, grid, B, smem, st, k);
        default: return (int)launch_table<2>(form, grid, B, smem, st, k);
    }
}

// Rows built in global memory by the last table launch (1) or in shared
// memory (0).
extern "C" int node_barrier_last_in_global(void) { return nb_last_global; }

// The table's layout as this library sees it, for the ctypes mirror's
// check: its size, and by field number the offsets of pc (0), y (1) and
// nc_co (2) in NBTable, sizeof(NBPiece) (3) and the offsets of idx (4) and
// inst (5) in NBPiece, sizeof(NBTPiece) (6) and the offsets of inst (7) and
// idx (8) in NBTPiece.
extern "C" int node_barrier_table_size(void) { return (int)sizeof(NBTable); }

extern "C" int node_barrier_table_offset(int field) {
    switch (field) {
        case 0: return (int)offsetof(NBTable, pc);
        case 1: return (int)offsetof(NBTable, y);
        case 2: return (int)offsetof(NBTable, nc_co);
        case 3: return (int)sizeof(NBPiece);
        case 4: return (int)offsetof(NBPiece, idx);
        case 5: return (int)offsetof(NBPiece, inst);
        case 6: return (int)sizeof(NBTPiece);
        case 7: return (int)offsetof(NBTPiece, inst);
        case 8: return (int)offsetof(NBTPiece, idx);
        default: return -1;
    }
}

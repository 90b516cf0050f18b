// node_barrier: the per-node barrier of any piece table, f64, fused with the
// level's weight mask (bw) and linear term (wc).
//
// A table holds pieces over the ny rows of y, each a power cone (nz >= 2,
// alpha spec 0/1/2) or a linear block (nc, ni >= 1), with its input rows
// idx into the row vector y, and an optional select grid sel
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
// Replaces the Pallas kernel node_eval (mgbtpu/ops/pallas_dd.py:258, its
// pallas_call at :353), which ran vmap(F) of any traced per-node function
// in double-float; a lone power cone in barrier form that power_cone.cu
// (K2) takes (nz <= 5, <= 12 rows) keeps K2. The closed forms are those of
// power_cone.cuh and linear.cuh: the register instances share K2's pc_
// helpers; the runtime-width instances take the pcw_ and lnw_ helpers
// there (see those headers).
//
// Layout: three kernels per (mode, form), form 0 the barrier, 1 the
// cobarrier, 2 the cobarrier with the box.
// - The register kernels (node_barrier_kernel) take a table of up to 16
//   pieces over up to 32 rows whose pieces all have register instances: a
//   power cone on <NZ, SPEC> (nz <= 5), a linear block on <NC, NI> for the
//   shapes the port's constructors build, a runtime-width linear instance
//   for the rest up to 4 x 5; each keeps its small arrays in registers,
//   indexed only by unrolled loops. One thread per node, in blocks of 32
//   nodes (64 above 8,448 nodes, 16 where the rows would pass 48 KB of
//   shared memory; past that, halved until the block fits the opt-in
//   227 KB). The block stages its nodes' y, wc (mode 0), sel and every
//   piece's A, b, p, mu in shared memory with coalesced cp.async copies;
//   the loop over the pieces switches, per piece, to the instance of its
//   shape (instance codes below; node_barrier.py's instance() picks them).
//   The table goes by reference as a __grid_constant__ parameter, so no
//   kernel has a stack frame. Modes 1 and 2 build each node's row or
//   ny x ny block in shared memory (odd stride: a warp's threads write
//   distinct banks): filled with +0.0, piece 0 writes its entries, each
//   later piece adds its entries and adds +0.0 to the entries an earlier
//   piece wrote outside its own (which turns a -0.0 into +0.0, as the
//   reference's sum does); the box terms come last. The block then stores
//   its rows contiguous, applying bw (and wc) on the way out. The row masks
//   are 32-bit: ny <= 32 rows, and the slack row of the cobarrier form is
//   row NC - 1 <= 31. Bound on an H100: bytes (a few hundred flops per
//   node against the ~(pieces' grids + 2 ny + ny^2) doubles it moves).
// - The group kernels take every other table: the wide kernels
//   (node_barrier_wide_kernel) a table within the register kernels' limits
//   with a wider piece (a cone of nz = 6..32, a linear block past 4 x 5),
//   the table kernels (node_barrier_table_kernel) a table past those
//   limits, from a device buffer. Every piece takes its runtime-width
//   instance; a node runs on a group of threads, and a cone's Hessian is a
//   Gram product in an order of its own, held bit for bit to
//   node_barrier.py's node_barrier_gram_plain. See their note below.
// (One kernel with both kinds of instance spilled registers in its mode-2
// form, on an H100 with CUDA 12.9; apart, the register kernels are the
// code they were, with the registers they had.)
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <vector>

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
    bool first;
};

// A power cone on <NZ, SPEC>: mode 0 returns F0; modes 1/2 put its entries.
template <int NZ, int SPEC, int MODE, bool CO>
static __device__ __forceinline__ double cone(const NBKPiece& P,
                                              const NodeCtx& c) {
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

// FORM: 0 barrier, 1 cobarrier, 2 cobarrier + box
template <int MODE, int FORM>
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
            if (act) v = eval_piece<MODE, CO>(P, c);
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
    node_barrier_body<MODE, FORM>(tb);
}

// ---- the group kernels: the wide and the table kernels --------------------
//
// A table with a piece past the register instances (a cone of nz > 5, a
// linear block past 4 x 5) runs in the wide kernels; a table past the
// parameter kernels' limits (more than 16 pieces, more than 32 rows or a
// width past 32) in the table kernels, which read the table from a device
// buffer (node_barrier.py writes it: npc NBTPiece records, then the pieces'
// input rows as one int list). Both run one body, group_body, in which
// every piece takes its runtime-width instance (cone_grp, linear_grp).
//
// A node runs on a group of G lanes (a power of two; group_lg), about two
// entries a lane: in mode 2 the largest power of two up to nz (nz + 1) / 4
// of the table's widest cone, at most 128 (8 lanes at nz = 7, 64 at
// nz = 17, 128 at nz = 33), in modes 0 and 1 up to nz / 2, at most 32; one
// lane a node in a table without a cone or with cones of nz <= 3 (mode 2)
// or 2 (modes 0 and 1). A block holds 128 / G nodes (one lane a node: 32,
// or 64 above 8,448 nodes), fewer where shared memory asks (group_plan),
// and the kernels keep to 80 registers, so that 6 blocks of 128 fit an
// SM: a node's phases are short chains, and the SM hides their latency
// with the other blocks. A group within a warp waits on the warp's
// barrier, one lane on none, a wider group on the block's.
//
// A block copies the pieces' records and input rows into shared memory,
// then stages its nodes' y rows, sel and every piece's grids (A, b, p, mu)
// with coalesced cp.async copies (all pieces at once where they fit, else
// piece by piece, and past the opt-in 227 KB for one node's piece read
// where they lie), and while those are in flight derives each piece's row
// masks and keep flags and fills the output rows with +0.0. A node's
// vectors (y[idx] gathered, z, then gz, and w; F, then 1/F or iF2) and
// scalars sit in shared memory. Its output row or ny x ny block is built
// in shared memory where one node's fits beside its grids (ny up to about
// 160; in mode 2 only the rows some piece writes, the rest made on the way
// out), else in the output itself (last_in_global). The pieces are a loop
// that every thread of the block runs; a lane whose node is inactive or
// past the last node skips the work but not the barriers.
//
// Within a piece, every entry of a vector or matrix is one lane's, and
// every sum is that lane's left fold: the affine map z_i (F_i), the entries
// of A' gz (the gradients) and of a linear block's Hessian keep the order
// of the register instances, so modes 0 and 1 and the linear blocks keep
// their bits; the scalars (|q|^2, the value, the gradient's and Hessian's
// closed forms) are lane 0's. A cone's Hessian is the Gram form of
// power_cone.cuh: w_i a lane each (pcw_w_i), then the upper triangle in
// 2 x 2 tiles, row by row over the lanes, four folds side by side
// (pcw_gram_tile, pcw_h), each entry stored at (i, j) and (j, i). The
// fold over the pieces is the register kernels': a piece's entries go
// through idx (keep: the last occurrence of a repeated row), a later piece
// adds +0.0 to the entries of earlier pieces' rows it leaves alone
// (add_zeros_grp: a -0.0 turns +0.0), the box terms come last, bw and wc
// are applied on the way out.
//
// Bound on an H100: bytes. At nz = 33 over 65 rows a node moves ~5,400
// doubles (its 33 x 33 A in, its 65 x 65 block out, ~43 KB) and the Gram
// form does ~nz^3 ~ 45 k f64 operations (~1 a byte; the H100's CUDA cores
// do ~10 f64 operations a byte of its HBM rate), where the reference
// order's fold, one thread a node, took ~3 nz^4 = 3.6 M. So the tensor
// cores are not needed: the layout spreads each node's entries over its
// lanes and keeps every operand in shared memory, so that a block's time
// is its copies in and out.

#define NB_GROUP_THREADS 128   // threads a block of the group kernels
#define NB_GROUP_MAX 128       // lanes a node, mode 2 (at most)
#define NB_GROUP_MAX01 32      // lanes a node, modes 0 and 1

struct NBTPiece {
    const double *A, *b, *p, *mu;
    int inst, nc, ni;
    int idx;  // offset of the piece's ni input rows in the int list
};

// The group kernels' parameter, filled by the C entries (group_plan lays
// shared memory out).
struct NBGTable {
    const NBTPiece* pc;  // a table kernel's records on the device, or null:
    const int* ints;     // in the parameter (NBWTable); their input rows
    const double *y, *sel, *bw, *wc, *boxb, *boxR;
    double* out;
    double floor;
    int npc, m, ny, nin, nw, nidx;
    int lg;     // log2 of the lanes a node
    int npb;    // nodes a block
    int stage;  // the grids: 2 staged at once, 1 piece by piece, 0 in place
    int sos;    // stride of a node's output in shared memory; 0: the output
    int nlive;  // mode 2: the rows a piece writes (kept in shared memory)
    int maxw;   // the widest vector (a cone's nz, a linear block's nc, ni)
    int vs;     // stride of a node's vectors: v, w (maxw each), 4 scalars
    int sy, ssel, svec, sbw, sout, sgrid, smask;  // shared regions
                                                  // (doubles)
};

// The group kernels' parameter: the table whole, by value (a table
// kernel's past NB_INLINE_P pieces or NB_INLINE_I input rows in a device
// buffer).
#define NB_INLINE_P 32
#define NB_INLINE_I 512
struct NBWTable {
    NBGTable k;
    NBTPiece pc[NB_INLINE_P];
    int ints[NB_INLINE_I];
};
static_assert(sizeof(NBWTable) <= 4096, "the wide table passes 4 KB");

// A group's node: its lane, its rows and vectors.
struct Grp {
    int lane, G, ny, nin;
    unsigned mask;  // the group's lanes in its warp (G <= 32)
    const int* slot;  // mode 2 in shared memory: row r's place, else null
    const double* y;
    double slack, floor;
    double* o;  // the output row or block (shared memory or the output)
    double* v;  // z or F, then u, gz, 1/F or iF2
    double* w;  // the cone's w
    double* s;  // the cone's two_ir, cv, H_ss, inv_r
    bool first;
};

static __device__ __forceinline__ bool row_bit(const unsigned* r, int a) {
    return r[a >> 5] >> (a & 31) & 1u;
}

// Row r of a node's ny x ny block: in shared memory only the rows a piece
// writes are kept, in order (slot); in the output every row.
static __device__ __forceinline__ double* orow(const Grp& g, int r) {
    return g.o + (g.slot ? g.slot[r] : r) * g.ny;
}

// add_zeros over word masks (cur null: the piece is inactive), the node's
// rows shared over its lanes
template <int MODE>
static __device__ __forceinline__ void add_zeros_grp(const Grp& g,
                                                     const unsigned* prev,
                                                     const unsigned* cur,
                                                     int nw) {
    for (int a = g.lane; a < g.ny; a += g.G) {
        if (!row_bit(prev, a)) continue;
        const bool in = cur != nullptr && row_bit(cur, a);
        if (MODE == 1) {
            if (!in) g.o[a] = g.o[a] + 0.0;
            continue;
        }
        for (int wb = 0; wb < nw; ++wb) {
            const unsigned skip = in ? cur[wb] : 0u;
            for (unsigned rc = prev[wb] & ~skip; rc; rc &= rc - 1) {
                const int c = wb * 32 + __ffs(rc) - 1;
                double* e = orow(g, a) + c;
                *e = *e + 0.0;
            }
        }
    }
}

// A barrier for the G lanes of a node: none for one lane, the group's
// lanes of its warp (mask) for a group within a warp, else the block's.
// Every lane of the block calls it (the lanes of a node whose piece is
// inactive too).
static __device__ __forceinline__ void grp_sync(int G, unsigned mask) {
    if (G > 32)
        __syncthreads();
    else if (G > 1)
        __syncwarp(mask);
}

// yg[j] = y[idx[j]], j < n, over the lanes (the affine maps' operand, so
// that a fold's terms read no index first)
static __device__ __forceinline__ void gather(const Grp& g, bool act,
                                              const int* idx, int n) {
    if (act)
        for (int j = g.lane; j < n; j += g.G) g.w[j] = g.y[idx[j]];
    grp_sync(g.G, g.mask);
}

// The runtime-width cone over the group: mode 0 returns F0 (lane 0's);
// modes 1/2 put its entries. Every lane of the block calls it.
template <int SPEC, int MODE, bool CO>
static __device__ __forceinline__ double cone_grp(
    const Grp& g, bool act, const double* A, const double* b, double pn,
    double mu, const int* idx, const unsigned char* keep, int nz) {
    const int nq = nz - 1, lane = g.lane, G = g.G;
    double* z = g.v;
    gather(g, act, idx, nz);
    if (act)
        for (int i = lane; i < nz; i += G) {
            const double zi = pcw_affine_i(A, b, g.w, nz, i);
            z[i] = CO && i == nq ? zi + g.slack : zi;
        }
    grp_sync(G, g.mask);
    const double alpha = 2.0 / pn;
    if (MODE == 0) {
        double val = 0.0;
        if (act && lane == 0)
            val = pc_value<0, SPEC>(z, nz, alpha, mu, SPEC, g.floor);
        grp_sync(G, g.mask);
        return val;
    }
    if (MODE == 1) {
        if (act && lane == 0) {
            pc_grad<0, SPEC>(z, nz, alpha, mu, SPEC, g.floor, z);  // z -> gz
            if (CO) put(g.o + g.nin, z[nq], g.first);
        }
        grp_sync(G, g.mask);
        if (act)
            for (int i = lane; i < nz; i += G)
                if (keep[i])
                    put(g.o + idx[i], pcw_at_g_i(A, z, nz, i), g.first);
        grp_sync(G, g.mask);
        return 0.0;
    }
    const int nin = g.nin;
    if (act && lane == 0) {
        const PcwHess h = pcw_hess(z, nz, alpha, mu, SPEC, g.floor);
        g.s[0] = h.two_ir;
        g.s[1] = h.cv;
        g.s[2] = h.H_ss;
        g.s[3] = h.inv_r;
        if (CO) put(orow(g, nin) + nin, h.H_ss, g.first);
    }
    grp_sync(G, g.mask);
    PcwHess h = {};
    if (act) {
        h.two_ir = g.s[0];
        h.cv = g.s[1];
        h.H_ss = g.s[2];
        h.inv_r = g.s[3];
    }
    const double* a = A + nq * nz;  // row nq of A
    if (act)
        for (int i = lane; i < nz; i += G) {
            const double wi = pcw_w_i(A, z, h.inv_r, nz, i);
            g.w[i] = wi;
            if (CO && keep[i]) {  // cr_i = cv w_i + H_ss a_i
                const double cr = h.cv * wi + h.H_ss * a[i];
                put(orow(g, idx[i]) + nin, cr, g.first);
                put(orow(g, nin) + idx[i], cr, g.first);
            }
        }
    grp_sync(G, g.mask);
    if (act) {  // the 2 x 2 tiles (I, J), I <= J, row by row, G apart
        const int nt = (nz + 1) >> 1;
        int I = 0, J = lane;
        for (;;) {
            while (I < nt && J >= nt) {
                J += I + 1 - nt;
                ++I;
            }
            if (I >= nt) break;
            const int i0 = 2 * I, j0 = 2 * J;
            const int i1 = min(i0 + 1, nq), j1 = min(j0 + 1, nq);
            double gt[4];
            pcw_gram_tile(A, nz, i0, i1, j0, j1, gt);
            const int ii[2] = {i0, i1}, jj[2] = {j0, j1};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = ii[e >> 1], j = jj[e & 1];
                if ((e >> 1 && i0 + 1 > nq) || (e & 1 && j0 + 1 > nq)
                    || i > j || !keep[i] || !keep[j])
                    continue;
                const double hij =
                    pcw_h(gt[e], g.w[i], g.w[j], a[i], a[j], h);
                put(orow(g, idx[i]) + idx[j], hij, g.first);
                if (i != j) put(orow(g, idx[j]) + idx[i], hij, g.first);
            }
            J += G;
        }
    }
    grp_sync(G, g.mask);
    return 0.0;
}

// The runtime-width linear block over the group (linear.cuh's lnw_
// helpers): as cone_grp.
template <int MODE, bool CO>
static __device__ __forceinline__ double linear_grp(
    const Grp& g, bool act, const double* A, const double* b, const int* idx,
    const unsigned char* keep, int nc, int ni) {
    const int G = g.G;
    double* F = g.v;
    gather(g, act, idx, ni);
    if (act)
        for (int i = g.lane; i < nc; i += G) {
            const double Fi = lnw_affine_i(A, b, g.w, ni, i);
            F[i] = CO ? Fi + g.slack : Fi;
        }
    grp_sync(G, g.mask);
    if (MODE == 0) {
        double val = 0.0;
        if (act && g.lane == 0) val = lnw_value(F, nc, g.floor);
        grp_sync(G, g.mask);
        return val;
    }
    if (MODE == 1) {
        if (act && g.lane == 0) {
            const double gl = lnw_inv(F, nc);  // F -> 1 / F
            if (CO) put(g.o + g.nin, gl, g.first);
        }
        grp_sync(G, g.mask);
        if (act)
            for (int i = g.lane; i < ni; i += G)
                if (keep[i])
                    put(g.o + idx[i], lnw_grad(A, F, nc, ni, i), g.first);
        grp_sync(G, g.mask);
        return 0.0;
    }
    const int nin = g.nin;
    if (act && g.lane == 0) {
        const double cn = lnw_inv2<CO>(F, nc);  // F -> iF2
        if (CO) put(orow(g, nin) + nin, cn, g.first);
    }
    grp_sync(G, g.mask);
    if (act)  // the ni x ni entries, then (cobarrier) the ni cross entries
        for (int e = g.lane; e < ni * ni + (CO ? ni : 0); e += G) {
            if (e < ni * ni) {
                const int i = e / ni, j = e - i * ni;
                if (keep[i] && keep[j])
                    put(orow(g, idx[i]) + idx[j],
                        lnw_hess_ij(A, F, nc, ni, i, j), g.first);
            } else if (keep[e - ni * ni]) {
                const int i = e - ni * ni;
                const double cr = lnw_cross(A, F, nc, ni, i);
                put(orow(g, idx[i]) + nin, cr, g.first);
                put(orow(g, nin) + idx[i], cr, g.first);
            }
        }
    grp_sync(G, g.mask);
    return 0.0;
}

static __host__ __device__ __forceinline__ bool is_cone(int inst) {
    return inst < NB_LIN_WIDE;
}

// Stages piece P's grids for the block's nb nodes at off; returns the
// offset past them (regions of npb nodes).
static __device__ __forceinline__ int stage_piece(double* sh, int off,
                                                  const NBTPiece& P, int n0,
                                                  int nb, int npb, int t,
                                                  int B) {
    const int wa = P.nc * P.ni;
    stage(sh, off, P.A + (size_t)n0 * wa, nb * wa, t, B);
    off += region(npb, wa);
    stage(sh, off, P.b + (size_t)n0 * P.nc, nb * P.nc, t, B);
    off += region(npb, P.nc);
    if (is_cone(P.inst)) {
        stage(sh, off, P.p + n0, nb, t, B);
        off += region(npb, 1);
        stage(sh, off, P.mu + n0, nb, t, B);
        off += region(npb, 1);
    }
    return off;
}

// A phase-I component row's diagonal entry: 1/(R - v)^2 + 1/(R + v)^2
static __device__ __forceinline__ double box_diag(double R, double v) {
    const double ivm = 1.0 / (R - v), ivp = 1.0 / (R + v);
    return ivm * ivm + ivp * ivp;
}

template <int MODE, int FORM>
static __device__ __forceinline__ void group_body(const NBGTable& k,
                                                  const NBTPiece* pcs,
                                                  const int* ints) {
    constexpr bool CO = FORM > 0, BOX = FORM == 2;
    extern __shared__ __align__(16) double sh[];
    const int t = threadIdx.x, B = blockDim.x, G = 1 << k.lg, npb = k.npb;
    const int tn = t >> k.lg, lane = t & (G - 1);
    const int n0 = blockIdx.x * npb;
    const int nb = min(npb, k.m - n0);
    const int n = n0 + tn;
    const bool live = tn < nb;
    const int ny = k.ny, npc = k.npc, nin = k.nin, nw = k.nw;
    const int w = MODE == 1 ? ny : ny * ny;
    // mode 2 in shared memory: only the rows a piece writes, in order
    // (where some row is left out)
    const bool compact = MODE == 2 && k.sos && k.nlive < k.ny;
    // shared: the pieces' records and input rows; in modes 1 and 2 each
    // piece's output rows and the union of the earlier pieces' (nw words
    // each), and for each input row whether it is the last occurrence of
    // its row; in a compact block each row's place (slot)
    NBTPiece* rec = reinterpret_cast<NBTPiece*>(sh + k.smask);
    int* sidx = reinterpret_cast<int*>(rec + npc);
    unsigned* rows = reinterpret_cast<unsigned*>(sidx + k.nidx);
    unsigned* prev = rows + npc * nw;
    unsigned char* keep = reinterpret_cast<unsigned char*>(prev + npc * nw);
    int* slot = reinterpret_cast<int*>(keep + ((k.nidx + 3) & ~3));
    {
        constexpr int W = sizeof(NBTPiece) / sizeof(double);
        const double* src = reinterpret_cast<const double*>(pcs);
        double* dst = reinterpret_cast<double*>(rec);
        for (int i = t; i < npc * W; i += B) dst[i] = src[i];
    }
    for (int i = t; i < k.nidx; i += B) sidx[i] = ints[i];
    stage(sh, k.sy, k.y + (size_t)n0 * ny, nb * ny, t, B);
    if (k.sel) stage(sh, k.ssel, k.sel + (size_t)n0 * npc, nb * npc, t, B);
    __syncthreads();
    // the grids' copies first, so that their latency runs under the rest
    if (k.stage == 2)
        for (int j = 0, off = k.sgrid; j < npc; ++j)
            off = stage_piece(sh, off, rec[j], n0, nb, npb, t, B);
    double* o = nullptr;
    if (MODE > 0) {
        if (k.sos) {
            for (int e = t; e < nb * k.sos; e += B) sh[k.sout + e] = 0.0;
            if (live && lane == 0) sh[k.sbw + tn] = k.bw[n];
        }
        if (live) {
            o = k.sos ? sh + k.sout + tn * k.sos : k.out + (size_t)n * w;
            if (!k.sos)
                for (int e = lane; e < w; e += G) o[e] = 0.0;
        }
    }
    if (MODE > 0) {
        for (int q = t; q < npc * nw; q += B) {  // word q % nw of piece q / nw
            const int j = q / nw, wq = q - j * nw;
            const int* idx = sidx + rec[j].idx;
            unsigned r = CO && nin >> 5 == wq ? 1u << (nin & 31) : 0u;
            for (int i = 0; i < rec[j].ni; ++i)
                r |= idx[i] >> 5 == wq ? 1u << (idx[i] & 31) : 0u;
            rows[q] = r;
        }
        for (int q = t; q < k.nidx; q += B) {  // input q of piece lo
            int lo = 0, hi = npc;
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (rec[mid].idx <= q)
                    lo = mid;
                else
                    hi = mid;
            }
            const int end = rec[lo].idx + rec[lo].ni, v = sidx[q];
            bool last = true;
            for (int l = q + 1; l < end; ++l) last &= sidx[l] != v;
            keep[q] = last;
        }
        __syncthreads();
        for (int i = t; i < nw; i += B) {
            unsigned acc = 0u;
            for (int j = 0; j < npc; ++j) {
                prev[j * nw + i] = acc;
                acc |= rows[j * nw + i];
            }
        }
    }
    cp_async_wait_all();
    __syncthreads();
    if (compact) {  // row r's place: its rank among the rows written
        const unsigned* last = prev + (npc - 1) * nw;
        const unsigned* lrow = rows + (npc - 1) * nw;
        for (int r = t; r < ny; r += B) {
            const int wr = r >> 5;
            const unsigned u = last[wr] | lrow[wr];
            int rank = __popc(u & ((1u << (r & 31)) - 1));
            for (int q = 0; q < wr; ++q) rank += __popc(last[q] | lrow[q]);
            slot[r] = u >> (r & 31) & 1u ? rank : -1;
        }
        __syncthreads();
    }

    Grp g;
    g.lane = lane;
    g.G = G;
    g.mask = G >= 32 ? ~0u : ((1u << G) - 1) << ((t & 31) & ~(G - 1));
    g.ny = ny;
    g.nin = nin;
    g.y = staged(sh, k.sy, k.y + (size_t)n0 * ny) + tn * ny;
    g.slack = CO && live ? g.y[nin] : 0.0;
    g.floor = k.floor;
    g.o = o;
    g.slot = compact ? slot : nullptr;
    g.v = sh + k.svec + tn * k.vs;
    g.w = g.v + k.maxw;
    g.s = g.w + k.maxw;
    const double* ssel =
        k.sel ? staged(sh, k.ssel, k.sel + (size_t)n0 * npc) + tn * npc
              : nullptr;
    double T = 0.0;
    int off = k.sgrid;
    for (int j = 0; j < npc; ++j) {
        const NBTPiece P = rec[j];
        const bool cone = is_cone(P.inst);
        if (k.stage < 2) off = k.sgrid;
        if (k.stage == 1) {  // once every lane is done with the last piece
            if (j > 0) __syncthreads();
            stage_piece(sh, off, P, n0, nb, npb, t, B);
            cp_async_wait_all();
            __syncthreads();
        }
        const int wa = P.nc * P.ni;
        const double *A, *b;
        double pn = 0.0, mu = 0.0;
        if (k.stage) {
            A = staged(sh, off, P.A + (size_t)n0 * wa) + tn * wa;
            off += region(npb, wa);
            b = staged(sh, off, P.b + (size_t)n0 * P.nc) + tn * P.nc;
            off += region(npb, P.nc);
            if (cone) {
                if (live) pn = staged(sh, off, P.p + n0)[tn];
                off += region(npb, 1);
                if (live) mu = staged(sh, off, P.mu + n0)[tn];
                off += region(npb, 1);
            }
        } else {
            A = P.A + (size_t)n * wa;
            b = P.b + (size_t)n * P.nc;
            if (cone && live) {
                pn = P.p[n];
                mu = P.mu[n];
            }
        }
        const bool act = live && (ssel == nullptr || ssel[j] != 0.0);
        if (MODE > 0 && j > 0 && live)
            add_zeros_grp<MODE>(g, prev + j * nw,
                                act ? rows + j * nw : nullptr, nw);
        g.first = j == 0;
        const int* idx = sidx + P.idx;
        const unsigned char* kp = keep + P.idx;
        double v;
        switch (P.inst) {
            case NB_CONE_WIDE + 0:
                v = cone_grp<0, MODE, CO>(g, act, A, b, pn, mu, idx, kp, P.nc);
                break;
            case NB_CONE_WIDE + 1:
                v = cone_grp<1, MODE, CO>(g, act, A, b, pn, mu, idx, kp, P.nc);
                break;
            case NB_CONE_WIDE + 2:
                v = cone_grp<2, MODE, CO>(g, act, A, b, pn, mu, idx, kp, P.nc);
                break;
            default:
                v = linear_grp<MODE, CO>(g, act, A, b, idx, kp, P.nc, P.ni);
        }
        if (MODE == 0) {
            const double e = act ? v : 0.0;
            T = j == 0 ? e : T + e;
        }
    }
    const double* y = g.y;
    const double slack = g.slack;
    if (MODE == 0) {
        if (live && lane == 0) {
            const double bw = k.bw[n];
            if (BOX) {
                const double bb = k.boxb[n], R = k.boxR[n];
                double sv = 0.0;
                for (int i = nin + 1; i < ny; ++i) {
                    const double ti = -log_barrier(R - y[i], k.floor)
                                      - log_barrier(R + y[i], k.floor);
                    sv = i == nin + 1 ? ti : sv + ti;
                }
                T = T - log_barrier(bb - slack, k.floor)
                    - log_barrier(bb + slack, k.floor) + sv;
            }
            const double* wr = k.wc + (size_t)n * ny;
            double lin = wr[0] * y[0];
            for (int i = 1; i < ny; ++i) lin = lin + wr[i] * y[i];
            k.out[n] = (bw != 0.0 ? bw * T : 0.0) + lin;
        }
        return;
    }
    if (BOX && live) {  // the slack's entry on lane 0, the rows over all
        const double bb = k.boxb[n], R = k.boxR[n];
        if (MODE == 1) {
            if (lane == 0)
                o[nin] = o[nin] + (1.0 / (bb - slack) - 1.0 / (bb + slack));
            for (int a = nin + 1 + lane; a < ny; a += G)
                o[a] = 1.0 / (R - y[a]) - 1.0 / (R + y[a]);
        } else {
            if (lane == 0) {
                const double ibm = 1.0 / (bb - slack);
                const double ibp = 1.0 / (bb + slack);
                double* e = orow(g, nin) + nin;
                *e = *e + (ibm * ibm + ibp * ibp);
            }
            if (!compact)  // (else made on the way out)
                for (int a = nin + 1 + lane; a < ny; a += G)
                    o[a * ny + a] = box_diag(R, y[a]);
        }
    }
    __syncthreads();
    if (!k.sos) {  // in place, in the output
        if (live) {
            const double bw = k.bw[n];
            const double* wr = k.wc + (size_t)n * w;
            for (int e = lane; e < w; e += G) {
                double x = bw != 0.0 ? bw * o[e] : 0.0;
                if (MODE == 1) x = x + wr[e];
                o[e] = x;
            }
        }
        return;
    }
    // the block's nb rows of w doubles, contiguous in global memory
    const int sos = k.sos;
    const double* so = sh + k.sout;
    const double* sbw = sh + k.sbw;
    double* dst = k.out + (size_t)n0 * w;
    const double* wc = k.wc + (size_t)n0 * w;
    int row = t / w, x = t - row * w;
    const int dq = B / w, dr = B - dq * w;
    if (!compact) {
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
        return;
    }
    // entry (r, c) of node row: a written row from shared memory, a
    // phase-I component row's diagonal made here, every other entry +0.0
    int r = x / ny, c = x - r * ny;
    const int rq = dr / ny, rr = dr - rq * ny;
    const double* y0 = staged(sh, k.sy, k.y + (size_t)n0 * ny);
    for (int i = t; i < nb * w; i += B) {
        const double bwr = sbw[row];
        const int sr = slot[r];
        double v = 0.0;
        if (sr >= 0)
            v = so[row * sos + sr * ny + c];
        else if (BOX && r == c && r > nin)
            v = box_diag(k.boxR[n0 + row], y0[row * ny + r]);
        dst[i] = bwr != 0.0 ? bwr * v : 0.0;
        row += dq;
        r += rq;
        c += rr;
        if (c >= ny) {
            c -= ny;
            ++r;
        }
        if (r >= ny) {
            r -= ny;
            ++row;
        }
    }
}

// The wide kernels: the table in their parameter
template <int MODE, int FORM>
__global__ void __launch_bounds__(NB_GROUP_THREADS, 6)
    node_barrier_wide_kernel(const __grid_constant__ NBWTable tb) {
    group_body<MODE, FORM>(tb.k, tb.pc, tb.ints);
}

// The table kernels: the table in their parameter where it fits, else in
// a device buffer (k.pc)
template <int MODE, int FORM>
__global__ void __launch_bounds__(NB_GROUP_THREADS, 6)
    node_barrier_table_kernel(const __grid_constant__ NBWTable tb) {
    const bool dev = tb.k.pc != nullptr;
    group_body<MODE, FORM>(tb.k, dev ? tb.k.pc : tb.pc,
                           dev ? tb.k.ints : tb.ints);
}

// ---- host ------------------------------------------------------------------

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
    return n;
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
}

// log2 of the lanes a node (see the group kernels' note): about two
// entries a lane, of the nz (nz + 1) / 2 of a Hessian's triangle in mode 2
// and of the nz of z and A'g in modes 0 and 1; nz is the table's widest
// cone, 0 without one.
static int group_lg(int mode, int nz) {
    const int want = mode == 2 ? nz * (nz + 1) / 4 : nz / 2;
    const int most = mode == 2 ? NB_GROUP_MAX : NB_GROUP_MAX01;
    int lg = 0;
    while ((2 << lg) <= want && (2 << lg) <= most) ++lg;
    return lg;
}

// The shared doubles of the group kernels' layout at npb nodes a block,
// grids staged as ``stage`` says and rows at stride sos (0: in the
// output); sets the regions' offsets in k.
static long group_layout(NBGTable& k, const NBTPiece* pc, int mode, int npb,
                         int stage, int sos) {
    auto even = [](long x) { return (x + 1) & ~1L; };
    long all = 0, most = 0;
    for (int j = 0; j < k.npc; ++j) {
        const long g = region(npb, pc[j].nc * pc[j].ni)
                       + region(npb, pc[j].nc)
                       + (is_cone(pc[j].inst) ? 2 * region(npb, 1) : 0);
        all += g;
        most = g > most ? g : most;
    }
    long off = region(npb, k.ny);
    k.sy = 0;
    k.ssel = (int)off;
    off += k.sel ? region(npb, k.npc) : 0;
    k.svec = (int)off;
    off += even((long)npb * k.vs);
    k.sbw = (int)off;
    off += sos ? even(npb) : 0;
    k.sout = (int)off;
    off += sos ? even((long)npb * sos) : 0;
    k.sgrid = (int)off;
    off += stage == 2 ? all : stage == 1 ? most : 0;
    k.smask = (int)off;
    off += (sizeof(NBTPiece) * k.npc + sizeof(int) * k.nidx
            + (mode > 0 ? 2L * sizeof(unsigned) * k.npc * k.nw
                              + ((k.nidx + 3) & ~3)
                        : 0)
            + (mode == 2 && sos ? sizeof(int) * (long)k.ny : 0) + 7) / 8;
    k.npb = npb;
    k.stage = stage;
    k.sos = sos;
    return off;
}

// The group kernels' layout of a table (pc its records, ints their input
// rows, in host memory): the lanes a node, then the first of these that
// fits the opt-in 227 KB, each at the most nodes a block that fits: the
// rows in shared memory with the grids staged at once, piece by piece; the
// rows in the output with the grids staged at once, piece by piece; the
// grids read in place, the rows in shared memory, in the output. In mode 2
// shared memory holds only the rows some piece writes (nlive). Returns the
// shared bytes, 0 if none fits.
static size_t group_plan(NBGTable& k, const NBTPiece* pc, const int* ints,
                         int mode) {
    int nz = 0;
    k.maxw = 1;
    for (int j = 0; j < k.npc; ++j) {
        if (is_cone(pc[j].inst) && pc[j].nc > nz) nz = pc[j].nc;
        const int wv = pc[j].nc > pc[j].ni ? pc[j].nc : pc[j].ni;
        if (wv > k.maxw) k.maxw = wv;
    }
    k.vs = 2 * k.maxw + 4;
    k.lg = group_lg(mode, nz);
    const int G = 1 << k.lg;
    const int npb0 = G > 1 ? (NB_GROUP_THREADS / G > 1 ? NB_GROUP_THREADS / G
                                                        : 1)
                           : (k.m > 8448 ? 64 : 32);
    std::vector<char> written(k.ny, 0);
    if (k.nin < k.ny) written[k.nin] = 1;  // the cobarrier's slack row
    for (int i = 0; i < k.nidx; ++i) written[ints[i]] = 1;
    k.nlive = 0;
    for (char c : written) k.nlive += c;
    const long w = mode == 1 ? k.ny : (long)k.nlive * k.ny;
    const int sos = mode > 0 && w < NB_SMEM_MAX ? (int)(w | 1) : 0;
    static const int plans[6][2] = {{1, 2}, {1, 1}, {0, 2},
                                    {0, 1}, {1, 0}, {0, 0}};
    for (const auto& pl : plans) {
        if (pl[0] && !sos) continue;
        for (int npb = npb0; npb >= 1; npb /= 2) {
            const long d = group_layout(k, pc, mode, npb, pl[1],
                                        pl[0] ? sos : 0);
            if (8 * d <= NB_SMEM_MAX) return 8 * (size_t)d;
        }
    }
    return 0;
}

// The kernels by [mode][form]
#define NB_BY_FORM(K, M) {K<M, 0>, K<M, 1>, K<M, 2>}
#define NB_BY_MODE(K) {NB_BY_FORM(K, 0), NB_BY_FORM(K, 1), NB_BY_FORM(K, 2)}
static void (*const REGISTER_KERNELS[3][3])(const NBKTable) =
    NB_BY_MODE(node_barrier_kernel);
static void (*const WIDE_KERNELS[3][3])(const NBWTable) =
    NB_BY_MODE(node_barrier_wide_kernel);
static void (*const TABLE_KERNELS[3][3])(const NBWTable) =
    NB_BY_MODE(node_barrier_table_kernel);

// A block past 48 KB of shared memory needs the kernel's opt-in.
template <class T>
static cudaError_t run(void (*kernel)(const T), int blocks, int threads,
                       size_t smem, cudaStream_t st, const T& arg) {
    if (smem > NB_SMEM) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<blocks, threads, smem, st>>>(arg);
    return cudaGetLastError();
}

// What the last launch laid out: nodes a block, lanes a node, whether a
// table kernel built its rows in the output (the tests read them).
static int nb_last_block = 0;
static int nb_last_group = 0;
static int nb_last_global = 0;

extern "C" int node_barrier_last_block(void) { return nb_last_block; }
extern "C" int node_barrier_last_group(void) { return nb_last_group; }

// Rows built in global memory by the last launch of a group kernel (1) or
// in shared memory (0).
extern "C" int node_barrier_last_in_global(void) { return nb_last_global; }

// Launches a group kernel on the table k whose records and input rows (in
// host memory) are pc and ints: kernel[mode][form] of the family.
template <class T>
static int launch_group(void (*const kernel[3][3])(const T), NBGTable& k,
                        const NBTPiece* pc, const int* ints, int mode,
                        int form, cudaStream_t st, const T& arg) {
    const size_t smem = group_plan(k, pc, ints, mode);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    nb_last_block = k.npb;
    nb_last_group = 1 << k.lg;
    nb_last_global = mode > 0 && !k.sos;
    return (int)run(kernel[mode][form], (k.m + k.npb - 1) / k.npb,
                    k.npb << k.lg, smem, st, arg);
}

// The common part of a group kernel's table.
static void group_table(NBGTable& k, const double* y, const double* sel,
                        const double* bw, const double* wc,
                        const double* boxb, const double* boxR, double* out,
                        double floor, int npc, int nidx, int m, int ny,
                        int nin) {
    k.y = y;
    k.sel = sel;
    k.bw = bw;
    k.wc = wc;
    k.boxb = boxb;
    k.boxR = boxR;
    k.out = out;
    k.floor = floor;
    k.npc = npc;
    k.nidx = nidx;
    k.m = m;
    k.ny = ny;
    k.nin = nin;
    k.nw = (ny + 31) / 32;
}

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
    const int nin = t.nc_co ? t.nc_co - 1 : t.ny;
    const cudaStream_t st = (cudaStream_t)stream;
    bool wide = false;
    for (int j = 0; j < t.npc; ++j) {
        const NBPiece& P = t.pc[j];
        const int code = instance_code(P.kind, P.nz, P.ni, P.spec);
        if (code < 0) return (int)cudaErrorInvalidValue;
        wide = wide || code >= NB_CONE_WIDE;
        for (int i = 0; i < P.ni; ++i)
            if (P.idx[i] < 0 || P.idx[i] >= nin)
                return (int)cudaErrorInvalidValue;
    }
    for (int j = 0; j < t.npc; ++j) {
        const NBPiece& P = t.pc[j];
        if (P.inst != (wide ? wide_code(P.kind, P.spec)
                            : instance_code(P.kind, P.nz, P.ni, P.spec)))
            return (int)cudaErrorInvalidValue;
    }
    if (wide) {  // the records and input rows go in the parameter
        NBWTable W = {};
        int used = 0;
        for (int j = 0; j < t.npc; ++j) {
            const NBPiece& P = t.pc[j];
            W.pc[j] = NBTPiece{P.A, P.b, P.kind == 0 ? P.p : nullptr,
                               P.kind == 0 ? P.mu : nullptr, P.inst, P.nz,
                               P.ni, used};
            for (int i = 0; i < P.ni; ++i) W.ints[used + i] = P.idx[i];
            used += P.ni;
        }
        group_table(W.k, t.y, t.sel, t.bw, t.wc, t.boxb, t.boxR, t.out,
                    t.floor, t.npc, used, t.m, t.ny, nin);
        return launch_group(WIDE_KERNELS, W.k, W.pc, W.ints, t.mode, form,
                            st, W);
    }
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
    k.nin = nin;
    for (int j = 0; j < t.npc; ++j) {
        const NBPiece& P = t.pc[j];
        NBKPiece& Q = k.pc[j];
        Q.A = P.A;
        Q.b = P.b;
        Q.p = P.kind == 0 ? P.p : nullptr;
        Q.mu = P.kind == 0 ? P.mu : nullptr;
        Q.inst = P.inst;
        Q.nc = P.nz;
        Q.ni = P.ni;
        Q.rows = t.nc_co ? 1u << nin : 0u;  // nin <= 31 in this form
        for (int i = 0; i < P.ni; ++i) {
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
    nb_last_group = 1;
    nb_last_global = 0;
    return (int)run(REGISTER_KERNELS[t.mode][form], (t.m + B - 1) / B, B,
                    smem, st, k);
}

// Launch of a table kernel. ``host`` is the table as node_barrier.py wrote
// it (checked here: instance codes, widths, input rows), ``dev`` its copy
// on the device; nidx is the length of the int list after the npc records.
extern "C" int node_barrier_table_launch(
    const NBTPiece* host, const NBTPiece* dev, int npc, int nidx,
    const double* y, const double* sel, const double* bw, const double* wc,
    const double* boxb, const double* boxR, double* out, double floor,
    int mode, int m, int ny, int nc_co, void* stream) {
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
        const bool cone = P.inst >= NB_CONE_WIDE && is_cone(P.inst);
        if ((cone ? P.nc < 2 || P.ni != P.nc || !P.p || !P.mu
                  : P.inst != NB_LIN_WIDE || P.nc < 1 || P.ni < 1)
            || !P.A || !P.b || P.idx != used)
            return (int)cudaErrorInvalidValue;
        for (int i = 0; i < P.ni; ++i)
            if (ints[used + i] < 0 || ints[used + i] >= nin)
                return (int)cudaErrorInvalidValue;
        used += P.ni;
    }
    if (used != nidx) return (int)cudaErrorInvalidValue;
    NBWTable W = {};
    if (npc <= NB_INLINE_P && nidx <= NB_INLINE_I) {  // in the parameter
        for (int j = 0; j < npc; ++j) W.pc[j] = host[j];
        for (int i = 0; i < nidx; ++i) W.ints[i] = ints[i];
    } else {
        W.k.pc = dev;
        W.k.ints = reinterpret_cast<const int*>(dev + npc);
    }
    group_table(W.k, y, sel, bw, wc, boxb, boxR, out, floor, npc, nidx, m,
                ny, nin);
    const int form = nc_co == 0 ? 0 : (box ? 2 : 1);
    return launch_group(TABLE_KERNELS, W.k, host, ints, mode, form,
                        (cudaStream_t)stream, W);
}

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

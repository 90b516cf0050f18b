// node_barrier: the per-node barrier of any piece table, f64, fused with the
// level's weight mask (bw) and linear term (wc).
//
// A table holds up to 4 pieces, each a power cone (nz <= 5, alpha spec
// 0/1/2) or a linear block (nc <= 4, ni <= 5), with its input rows idx into
// the row vector y, and an optional select grid sel (m, npc): piece k is
// active at node n where sel[n, k] != 0 (always, without a grid). Per node:
//   mode 0: out[n]       = (bw != 0 ? bw T : 0) + sum_k wc[n,k] y[k]
//   mode 1: out[n, :]    = (bw != 0 ? bw T : 0) + wc[n, :]
//   mode 2: out[n, :, :] =  bw != 0 ? bw T : 0
// where T is the piecewise sum of F0, of F1 scattered to the row width, or
// of F2 scattered to its square, exactly as mgbtpu/convex/piecewise.py
// composes them: each entry is a left fold over the pieces in piece order,
// an inactive piece (and an entry outside a piece's rows) contributing an
// exact 0, whatever its barrier is there.
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
// cone in barrier form keeps power_cone.cu (K2). The closed forms are those
// of power_cone.cuh and linear.cuh, so the cone's arithmetic exists once.
// One thread per node, the pieces' small results in registers/local memory,
// the output written straight to global memory; nD <= 12 rows.
// Bound on an H100: bytes (a few hundred flops per node against the
// ~(pieces' grids + 2 nD + nD^2) doubles it moves).
#include <cstdint>
#include <cuda_runtime.h>

#include "linear.cuh"
#include "power_cone.cuh"

#define NB_MAXP 4
#define NB_MAXD 12
#define NB_MAXZ 5

struct NBPiece {
    const double* A;   // power: (m, nz*nz); linear: (m, nc*ni)
    const double* b;   // (m, nz) / (m, nc)
    const double* p;   // power only: (m,)
    const double* mu;  // power only: (m,)
    int kind;          // 0 power cone, 1 linear block
    int nz;            // power: nz; linear: nc
    int ni;            // inputs read: power nz, linear ni
    int spec;          // power: alpha specialisation 0/1/2
    int idx[NB_MAXZ];
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

// One piece's small results at node n: mode 0 the value v; mode 1 the
// gradient g over its inputs (+ gl, the slack entry); mode 2 the Hessian H
// (+ cr, cn, the slack's cross column and corner).
__device__ __forceinline__ void eval_piece(const NBPiece& P, int n,
                                           const double* y, bool co,
                                           double slack, int mode,
                                           double floor, double* v, double* g,
                                           double* gl,
                                           double H[NB_MAXZ][NB_MAXZ],
                                           double* cr, double* cn) {
    if (P.kind == 0) {
        const int nz = P.nz;
        double Ar[PC_MAXNZ][PC_MAXNZ], z[PC_MAXNZ];
        pc_affine(P.A + (size_t)n * nz * nz, P.b + (size_t)n * nz, y, P.idx,
                  nz, Ar, z);
        if (co) z[nz - 1] = z[nz - 1] + slack;
        const double mu = P.mu[n];
        const double alpha = 2.0 / P.p[n];
        if (mode == 0) {
            *v = pc_value(z, nz, alpha, mu, P.spec, floor);
        } else if (mode == 1) {
            double gz[PC_MAXNZ];
            pc_grad(z, nz, alpha, mu, P.spec, floor, gz);
            pc_at_g(Ar, gz, nz, g);
            *gl = gz[nz - 1];
        } else {
            double Hz[PC_MAXNZ][PC_MAXNZ];
            pc_hess(z, nz, alpha, mu, P.spec, floor, Hz);
            pc_at_h_a(Ar, Hz, nz, H);
            if (co) {
                for (int i = 0; i < nz; ++i) {
                    double acc = Ar[0][i] * Hz[0][nz - 1];
                    for (int k = 1; k < nz; ++k) acc = acc + Ar[k][i] * Hz[k][nz - 1];
                    cr[i] = acc;
                }
                *cn = Hz[nz - 1][nz - 1];
            }
        }
        return;
    }
    const int nc = P.nz, ni = P.ni;
    double Ar[LN_MAXC][LN_MAXI], F[LN_MAXC];
    ln_affine(P.A + (size_t)n * nc * ni, P.b + (size_t)n * nc, y, P.idx, nc,
              ni, Ar, F);
    if (co)
        for (int i = 0; i < nc; ++i) F[i] = F[i] + slack;
    if (mode == 0)
        *v = ln_value(F, nc, floor);
    else if (mode == 1)
        ln_grad(Ar, F, nc, ni, g, gl);
    else
        ln_hess(Ar, F, nc, ni, co, H, cr, cn);
}

__global__ void node_barrier_kernel(const NBTable t) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= t.m) return;
    const int ny = t.ny, npc = t.npc, mode = t.mode;
    const bool co = t.nc_co > 0;
    const int nin = co ? t.nc_co - 1 : ny;  // rows the pieces read
    const double* y = t.y + (size_t)n * ny;
    const double* wc = t.wc + (size_t)n * ny;
    const double slack = co ? y[nin] : 0.0;
    const double bw = t.bw[n];
    const bool box = t.boxb != nullptr;
    const double bb = box ? t.boxb[n] : 0.0, R = box ? t.boxR[n] : 0.0;

    bool act[NB_MAXP];
    int pos[NB_MAXP][NB_MAXD];  // row -> position in the piece's idx, or -1
    double v[NB_MAXP], gl[NB_MAXP], cn[NB_MAXP];
    double g[NB_MAXP][NB_MAXZ], cr[NB_MAXP][NB_MAXZ];
    double H[NB_MAXP][NB_MAXZ][NB_MAXZ];
    for (int k = 0; k < npc; ++k) {
        const NBPiece& P = t.pc[k];
        act[k] = t.sel == nullptr || t.sel[(size_t)n * npc + k] != 0.0;
        for (int a = 0; a < nin; ++a) pos[k][a] = -1;
        for (int j = 0; j < P.ni; ++j) pos[k][P.idx[j]] = j;
        if (act[k])
            eval_piece(P, n, y, co, slack, mode, t.floor, &v[k], g[k], &gl[k],
                       H[k], cr[k], &cn[k]);
    }

    if (mode == 0) {
        double T = 0.0;
        for (int k = 0; k < npc; ++k) {
            const double c = act[k] ? v[k] : 0.0;
            T = k == 0 ? c : T + c;
        }
        if (box) {
            double sv = 0.0;
            for (int i = t.nc_co; i < ny; ++i) {
                const double ti = -log_barrier(R - y[i], t.floor)
                                  - log_barrier(R + y[i], t.floor);
                sv = i == t.nc_co ? ti : sv + ti;
            }
            T = T - log_barrier(bb - slack, t.floor)
                - log_barrier(bb + slack, t.floor) + sv;
        }
        double lin = wc[0] * y[0];
        for (int k = 1; k < ny; ++k) lin = lin + wc[k] * y[k];
        t.out[n] = (bw != 0.0 ? bw * T : 0.0) + lin;
        return;
    }

    if (mode == 1) {
        double* o = t.out + (size_t)n * ny;
        for (int a = 0; a < ny; ++a) {
            double T = 0.0;
            if (a < nin) {
                for (int k = 0; k < npc; ++k) {
                    const double c = (act[k] && pos[k][a] >= 0) ? g[k][pos[k][a]] : 0.0;
                    T = k == 0 ? c : T + c;
                }
            } else if (a == nin) {  // the slack (co form)
                for (int k = 0; k < npc; ++k) {
                    const double c = act[k] ? gl[k] : 0.0;
                    T = k == 0 ? c : T + c;
                }
                if (box) T = T + (1.0 / (bb - slack) - 1.0 / (bb + slack));
            } else {  // a box row v_i
                T = 1.0 / (R - y[a]) - 1.0 / (R + y[a]);
            }
            o[a] = (bw != 0.0 ? bw * T : 0.0) + wc[a];
        }
        return;
    }

    double* o = t.out + (size_t)n * ny * ny;
    for (int a = 0; a < ny; ++a)
        for (int c = 0; c < ny; ++c) {
            double T = 0.0;
            if (a <= nin && c <= nin) {  // a == nin only in the co form
                for (int k = 0; k < npc; ++k) {
                    const int pa = a < nin ? pos[k][a] : -2;
                    const int pc = c < nin ? pos[k][c] : -2;
                    double e = 0.0;
                    if (act[k]) {
                        if (pa >= 0 && pc >= 0) e = H[k][pa][pc];
                        else if (pa >= 0 && pc == -2) e = cr[k][pa];
                        else if (pa == -2 && pc >= 0) e = cr[k][pc];
                        else if (pa == -2 && pc == -2) e = cn[k];
                    }
                    T = k == 0 ? e : T + e;
                }
                if (box && a == nin && c == nin) {
                    const double ibm = 1.0 / (bb - slack), ibp = 1.0 / (bb + slack);
                    T = T + (ibm * ibm + ibp * ibp);
                }
            } else if (a == c) {  // a box row v_i (a > nin)
                const double ivm = 1.0 / (R - y[a]), ivp = 1.0 / (R + y[a]);
                T = ivm * ivm + ivp * ivp;
            }
            o[a * ny + c] = bw != 0.0 ? bw * T : 0.0;
        }
}

extern "C" int node_barrier_launch(const NBTable* t, void* stream) {
    if (t->m > 0) {
        const int block = 128;
        node_barrier_kernel<<<(t->m + block - 1) / block, block, 0,
                              (cudaStream_t)stream>>>(*t);
    }
    return (int)cudaGetLastError();
}

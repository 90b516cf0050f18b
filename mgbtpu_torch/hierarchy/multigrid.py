"""MultiGrid (per-subspace prolongation families) and the solver-facing AMG.

A ``MultiGrid`` stores, per subspace symbol ("dirichlet", "full", "uniform",
user-named Dirichlet classes, discretization riders like "broken_P1"), one
family of *fine-level prolongations* R[X][l]: the matrix lifting level-l
X-subspace coefficients directly to the fine broken basis. Per-level
transfers are composed away at construction (the solver only evaluates the
barrier at the fine level), but the coefficient-level transfer chain is kept
for the V-cycle preconditioner. Capability parity with reference
``src/multigrid.jl`` (MultiGrid at :154-276, amg_helper at :474-512,
_prepare_amg at :514-538).

All host-side scipy; the device representation is built per level in
``solver/levelops.py``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _stretch(refine: dict, subspaces: dict):
    """Pad shallower subspace hierarchies to common depth with identity
    transitions (ceil-interpolated level map). Reference
    ``src/multigrid.jl:219-265``."""
    L_X = {X: len(refine[X]) for X in refine}
    L_max = max(L_X.values())
    if all(l == L_max for l in L_X.values()):
        return refine, subspaces
    refine_s, subspaces_s = {}, {}
    for X in refine:
        Lx = L_X[X]
        if Lx == L_max:
            refine_s[X] = refine[X]
            subspaces_s[X] = subspaces[X]
            continue
        synth2nat = [int(np.ceil(Lx * (i + 1) / L_max)) - 1 for i in range(L_max)]
        rf, ss = [], []
        for i in range(L_max):
            ni = synth2nat[i]
            ss.append(subspaces[X][ni])
            if i == L_max - 1:
                rf.append(refine[X][Lx - 1])          # identity at fine
            elif synth2nat[i + 1] > ni:
                rf.append(refine[X][ni])              # real AMG step
            else:
                m = ss[i].shape[0]
                rf.append(sp.identity(m, format="csr"))
        refine_s[X] = rf
        subspaces_s[X] = ss
    return refine_s, subspaces_s


def _compose(subspaces: dict, refine: dict) -> dict:
    """R[X][l] = (refine chain l -> L) @ subspaces[X][l]."""
    out = {}
    for X in subspaces:
        rX, sX = refine[X], subspaces[X]
        L = len(rX)
        rfp = [None] * L
        rfp[L - 1] = sp.csr_matrix(rX[L - 1])
        for l in range(L - 2, -1, -1):
            rfp[l] = sp.csr_matrix(rfp[l + 1] @ rX[l])
        out[X] = [sp.csr_matrix(rfp[l] @ sX[l]) for l in range(L)]
    return out


class MultiGrid:
    """Geometry + per-subspace composed prolongations R[X][l] (l=0 coarsest).

    ``transfers[X][l]`` (when available) maps level-l coefficients to
    level-(l+1) coefficients: R[X][l] == R[X][l+1] @ transfers[X][l]; used by
    the multigrid-preconditioned linear solver.
    """

    def __init__(self, geometry, R: dict, transfers: dict | None = None):
        self.geometry = geometry
        self.R = {X: [sp.csr_matrix(m) for m in Rs] for X, Rs in R.items()}
        self.transfers = transfers

    @classmethod
    def from_subspaces(cls, geometry, subspaces: dict, refine: dict,
                       transfers_override: dict | None = None):
        """``transfers_override[X]`` supplies known-analytic coefficient
        transfers for subspace X (still nestedness-validated), bypassing
        the least-squares machinery — the generic E'E solve for the
        element-local broken_P1 rider was ~8 of the 13 minutes of an L=8
        geometric setup."""
        refine_s, subspaces_s = _stretch(refine, subspaces)
        R = _compose(subspaces_s, refine_s)
        transfers = _coefficient_transfers(subspaces_s, refine_s,
                                           overrides=transfers_override)
        return cls(geometry, R, transfers)

    @property
    def depth(self):
        return len(next(iter(self.R.values())))

    def xflat(self):
        return self.geometry.xflat()


def _blockdiag_inverse(A: sp.spmatrix, max_block=16):
    """Inverse of an SPD matrix whose sparsity decomposes into disjoint
    diagonal blocks of size <= max_block (element-local subspace Gramians),
    as a sparse matrix; None if the structure doesn't hold. Blocks are
    grouped by size and inverted batched."""
    from scipy.sparse.csgraph import connected_components

    A = sp.csr_matrix(A)
    n = A.shape[0]
    if n == 0:
        return sp.csr_matrix(A.shape)
    ncomp, labels = connected_components(A, directed=False)
    sizes = np.bincount(labels)
    if sizes.max() > max_block:
        return None
    order = np.argsort(labels, kind="stable")
    rows_out, cols_out, vals_out = [], [], []
    start = np.zeros(ncomp + 1, dtype=np.int64)
    np.cumsum(sizes, out=start[1:])
    for s in np.unique(sizes):
        comps = np.flatnonzero(sizes == s)
        # (n_g, s) member indices per component of this size
        mem = np.stack([order[start[c]:start[c] + s] for c in comps]) \
            if len(comps) < 1024 else \
            order[(start[comps][:, None] + np.arange(s)[None, :])]
        ii = np.repeat(mem[:, :, None], s, axis=2)
        jj = np.repeat(mem[:, None, :], s, axis=1)
        blocks = np.asarray(A[ii.reshape(-1), jj.reshape(-1)],
                            dtype=np.float64).reshape(len(comps), s, s)
        inv = np.linalg.inv(blocks)
        rows_out.append(ii.reshape(-1))
        cols_out.append(jj.reshape(-1))
        vals_out.append(inv.reshape(-1))
    return sp.csr_matrix(
        (np.concatenate(vals_out),
         (np.concatenate(rows_out), np.concatenate(cols_out))),
        shape=A.shape)


def _coefficient_transfers(subspaces: dict, refine: dict,
                           overrides: dict | None = None) -> dict:
    """Per-subspace level-l -> level-(l+1) coefficient transfers C with
    subspaces[X][l+1] @ C == refine[X][l] @ subspaces[X][l].

    At intermediate levels the subspace embeddings are identities so
    C = refine[l] @ sub[l]; at the fine cap the embedding E has (near-)
    orthogonal sparse columns and coarse spaces are nested in range(E) by
    construction, so C = (E'E)^{-1} E' (refine sub) with E'E SPD and tiny.
    """
    out = {}
    for X in subspaces:
        rX, sX = refine[X], subspaces[X]
        L = len(rX)
        Cs = []
        over = (overrides or {}).get(X)
        for l in range(L - 1):
            if over is not None and l < len(over) and over[l] is not None:
                C_o = sp.csr_matrix(over[l])
                in_dtype = np.result_type(rX[l].dtype, sX[l].dtype)
                target = sp.csr_matrix(rX[l].astype(np.float64)
                                       @ sX[l].astype(np.float64))
                E = sp.csr_matrix(sX[l + 1].astype(np.float64))
                tol = 1e-8 if np.dtype(in_dtype).itemsize >= 8 else 3e-6
                err = abs(E @ C_o.astype(np.float64) - target).max() \
                    if target.nnz else 0.0
                if err <= tol * max(1.0, abs(target).max()
                                    if target.nnz else 1.0):
                    Cs.append(C_o)
                    continue
                # fall through to the generic least-squares path
            # solve in float64 whatever the geometry dtype: float32 R
            # matrices fail an absolute 1e-8 nestedness check from their
            # own rounding (~1e-7), silently disabling every coefficient
            # transfer — and with them the V-cycle PCG path at depth
            in_dtype = np.result_type(rX[l].dtype, sX[l].dtype)
            target = sp.csr_matrix(rX[l].astype(np.float64)
                                   @ sX[l].astype(np.float64))
            E = sp.csr_matrix(sX[l + 1].astype(np.float64))
            n_next = E.shape[1]
            if E.shape[0] == E.shape[1] and (E - sp.identity(E.shape[0])).nnz == 0:
                Cs.append(target)
                continue
            EtE = (E.T @ E).tocsc()
            rhs = (E.T @ target).tocsc()
            try:
                offdiag = EtE - sp.diags(EtE.diagonal())
                if offdiag.nnz == 0 or abs(offdiag).max() == 0:
                    # subspace columns have disjoint support (coordinate-dedup
                    # embeddings): E'E is diagonal and the solve is a row
                    # scaling — the generic spsolve here was a per-column
                    # SuperLU loop costing ~50 s at L=7
                    dinv = 1.0 / EtE.diagonal()
                    C = sp.csr_matrix(sp.diags(dinv) @ rhs)
                else:
                    Binv = _blockdiag_inverse(EtE)
                    if Binv is not None:
                        # element-local rider (broken_P1): E'E decomposes
                        # into tiny disjoint diagonal blocks — invert them
                        # batched and keep everything sparse (the SuperLU
                        # route below was ~400 s at L=8)
                        C = sp.csr_matrix(Binv @ rhs)
                    else:
                        # general overlap: factor once, solve in COLUMN
                        # CHUNKS and sparsify each — a single dense
                        # rhs.toarray() was 10+ GB at L=8
                        solve = sp.linalg.factorized(EtE.tocsc())
                        n_rhs = rhs.shape[1]
                        chunk = max(1, min(n_rhs,
                                           int(2e8 // max(E.shape[1], 1))))
                        parts = []
                        for c0 in range(0, n_rhs, chunk):
                            blk = solve(rhs[:, c0:c0 + chunk].toarray())
                            scale = np.abs(blk).max() if blk.size else 1.0
                            blk[np.abs(blk) < 1e-10 * max(scale, 1e-30)] = 0.0
                            parts.append(sp.csc_matrix(blk))
                        C = sp.csr_matrix(sp.hstack(parts))
                if C.shape != (n_next, target.shape[1]):
                    C = sp.csr_matrix(C.reshape(n_next, target.shape[1]))
            except Exception:
                C = None
            if C is not None:
                # verify nestedness (drop if the subspace is not nested);
                # float32 inputs are only trusted to their own rounding
                tol = 1e-8 if np.dtype(in_dtype).itemsize >= 8 else 3e-6
                err = abs(E @ C - target).max() if target.nnz else 0.0
                if err > tol * max(1.0, abs(target).max() if target.nnz else 1.0):
                    C = None
            Cs.append(C)
        out[X] = Cs
    return out


class AMGSystem:
    """What the solver consumes for one problem (main or feasibility):

    - ``R_fine[l]``: block-diagonal-over-state-variables prolongation of
      level l into the stacked broken basis (nu*m rows).
    - ``D_fine[k]``: fine operator k as (BlockDiagHost, active component).
    Reference ``AMG`` struct + ``amg_helper`` (``src/multigrid.jl:278-512``).
    """

    def __init__(self, geometry, x, w, R_fine, D_fine, nu, state_variables, D,
                 T_fine=None):
        self.geometry = geometry
        self.x = x
        self.w = w
        self.R_fine = R_fine
        self.D_fine = D_fine          # list of (BlockDiagHost, comp_index)
        self.nu = nu
        self.state_variables = state_variables
        self.D = D
        # T_fine[l]: level-l -> level-(l+1) coefficient transfer (stacked
        # over components), satisfying R_fine[l] == R_fine[l+1] @ T_fine[l];
        # None entries when a subspace is not nested. Used by the multigrid
        # V-cycle preconditioner of the large-level Newton solves.
        self.T_fine = T_fine if T_fine is not None else [None] * (len(R_fine) - 1)

    @property
    def depth(self):
        return len(self.R_fine)

    @property
    def n_nodes(self):
        return len(self.w)

    def D_sparse(self, k) -> sp.csr_matrix:
        """The fine operator row D_fine[k] as one sparse matrix over the
        stacked state (``block_column_sparse``)."""
        from ..ops.blockdiag import block_column_sparse

        op, comp = self.D_fine[k]
        return block_column_sparse(op, comp, self.nu)

    def apply_D_full(self, z: np.ndarray) -> np.ndarray:
        """Dz for the full stacked state z (host): (n_nodes, nD)."""
        m = self.n_nodes
        out = np.empty((m, len(self.D_fine)), dtype=z.dtype)
        for k, (op, comp) in enumerate(self.D_fine):
            out[:, k] = op.matvec(z[comp * m:(comp + 1) * m])
        return out


def amg_helper(mg: MultiGrid, state_variables, D) -> AMGSystem:
    """Build the solver-facing AMG from a MultiGrid + state table.

    ``state_variables``: list of (name, subspace_symbol); ``D``: list of
    (state_name, operator_symbol). R_fine[l] is the blockdiag join of each
    state variable's level-l prolongation; D_fine[k] slots operator k into
    its variable's column block.
    """
    geometry = mg.geometry
    x = geometry.xflat()
    w = geometry.w
    ops = geometry.operators
    state_variables = [(str(n), str(s)) for n, s in state_variables]
    nu = len(state_variables)
    for _, space in state_variables:
        if space not in mg.R:
            raise ValueError(f"unknown subspace :{space}; have {sorted(mg.R)}")
    L = len(mg.R[state_variables[0][1]])
    R_fine = [sp.block_diag([mg.R[s][l] for _, s in state_variables],
                            format="csr") for l in range(L)]
    T_fine = []
    for l in range(L - 1):
        parts = []
        ok = True
        for _, s in state_variables:
            Ts = (mg.transfers or {}).get(s)
            if Ts is None or l >= len(Ts) or Ts[l] is None:
                ok = False
                break
            parts.append(Ts[l])
        T_fine.append(sp.block_diag(parts, format="csr") if ok else None)
    comp_of = {name: k for k, (name, _) in enumerate(state_variables)}
    D_fine = []
    for name, opsym in D:
        name, opsym = str(name), str(opsym)
        if name not in comp_of:
            raise ValueError(f"D references unknown state variable :{name}")
        if opsym not in ops:
            raise ValueError(f"D references unknown operator :{opsym}; "
                             f"available: {sorted(ops)}")
        D_fine.append((ops[opsym], comp_of[name]))
    return AMGSystem(geometry, x, w, R_fine, D_fine, nu,
                     state_variables, [(str(a), str(b)) for a, b in D],
                     T_fine=T_fine)


def prepare_amg(mg: MultiGrid, *, state_variables, D):
    """Build the (main, feasibility) AMG pair.

    The feasibility system appends a ``feasibility_slack`` variable in the
    fully broken space and the operator rows
    ``(user D..., slack id, one id row per original component)`` — the
    trailing id rows expose nodal values for the phase-I bounding box.
    Reference ``_prepare_amg`` (``src/multigrid.jl:514-538``).
    """
    # cache on the MultiGrid: repeat assembles of the same problem reuse the
    # SAME AMGSystem pair, so downstream per-system caches (jitted kernels,
    # traced ramp programs, panel ops) survive across assemble() calls —
    # re-tracing the fused ramp costs tens of seconds at depth
    key = (tuple((str(a), str(b)) for a, b in state_variables),
           tuple((str(a), str(b)) for a, b in D))
    cache = getattr(mg, "_prepare_amg_cache", None)
    if cache is None:
        cache = {}
        mg._prepare_amg_cache = cache
    if key not in cache:
        M1 = amg_helper(mg, state_variables, D)
        sv2 = list(state_variables) + [("_feas_slack", "full")]
        D2 = list(D) + [("_feas_slack", "id")] + \
            [(name, "id") for name, _ in state_variables]
        M2 = amg_helper(mg, sv2, D2)
        cache[key] = (M1, M2)
    return cache[key]

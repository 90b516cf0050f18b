"""Pluggable AMG prolongator factories (host-side, scipy).

A prolongator is a callable ``K (csr) -> [P_1, ..., P_m]`` returning the
level prolongations finest -> coarsest; the list length sets the hierarchy
depth. The reference delegates to AlgebraicMultigrid.jl
(``src/amg_prolongators.jl``); here classical Ruge-Stuben is
implemented directly on scipy (setup is one-time, host-side;
only the resulting P matrices ever reach the device), beside smoothed
aggregation and an adapter for pyamg where it is installed. A copy of
``mgbtpu/hierarchy/prolongators.py``. Solutions must be
prolongator-independent (the reference's cross-prolongator test design), so
exact parity with any particular AMG library is not required.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _strength_graph(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Classical strength of connection: i strongly depends on j if
    -A[i,j] >= theta * max_k(-A[i,k])."""
    A = A.tocsr()
    n = A.shape[0]
    S_rows, S_cols = [], []
    indptr, indices, data = A.indptr, A.indices, A.data
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        cols = indices[lo:hi]
        vals = data[lo:hi]
        off = cols != i
        if not off.any():
            continue
        neg = -vals[off]
        m = neg.max()
        if m <= 0:
            continue
        strong = cols[off][neg >= theta * m]
        S_rows.extend([i] * len(strong))
        S_cols.extend(strong.tolist())
    S = sp.csr_matrix((np.ones(len(S_rows)), (S_rows, S_cols)), shape=A.shape)
    return S


def _cf_split(S: sp.csr_matrix) -> np.ndarray:
    """Standard (first-pass) Ruge-Stuben C/F splitting by descending
    influence count. Returns bool mask: True = C-point."""
    n = S.shape[0]
    St = S.T.tocsr()
    lam = np.asarray(St.sum(axis=1)).reshape(-1).astype(np.int64)
    state = np.zeros(n, dtype=np.int8)  # 0=undecided, 1=C, 2=F
    # bucket queue by lambda
    order = list(np.argsort(-lam, kind="stable"))
    import heapq

    heap = [(-lam[i], i) for i in range(n)]
    heapq.heapify(heap)
    lam_cur = lam.copy()
    while heap:
        negl, i = heapq.heappop(heap)
        if state[i] != 0 or -negl != lam_cur[i]:
            continue
        state[i] = 1  # C
        # neighbours that strongly depend on i become F
        for j in St.indices[St.indptr[i]:St.indptr[i + 1]]:
            if state[j] == 0:
                state[j] = 2
                # their strong influences get bumped
                for k in S.indices[S.indptr[j]:S.indptr[j + 1]]:
                    if state[k] == 0:
                        lam_cur[k] += 1
                        heapq.heappush(heap, (-lam_cur[k], k))
    state[state == 0] = 2
    # second pass: every strong F-F pair must share a C; else promote
    Sc = S.tocsr()
    cset = state == 1
    for i in range(n):
        if state[i] != 2:
            continue
        Ci = {j for j in Sc.indices[Sc.indptr[i]:Sc.indptr[i + 1]] if cset[j]}
        for j in Sc.indices[Sc.indptr[i]:Sc.indptr[i + 1]]:
            if state[j] == 2:
                Cj = {k for k in Sc.indices[Sc.indptr[j]:Sc.indptr[j + 1]] if cset[k]}
                if not (Ci & Cj) and not Ci:
                    state[i] = 1
                    cset[i] = True
                    break
    return state == 1


def _direct_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                          is_C: np.ndarray) -> sp.csr_matrix:
    """Classical direct interpolation with positive/negative splitting;
    preserves constants exactly on zero-row-sum matrices."""
    n = A.shape[0]
    cmap = -np.ones(n, dtype=np.int64)
    cmap[is_C] = np.arange(is_C.sum())
    rows, cols, vals = [], [], []
    A = A.tocsr()
    Scsr = S.tocsr()
    for i in range(n):
        if is_C[i]:
            rows.append(i)
            cols.append(cmap[i])
            vals.append(1.0)
            continue
        strong = set(Scsr.indices[Scsr.indptr[i]:Scsr.indptr[i + 1]])
        lo, hi = A.indptr[i], A.indptr[i + 1]
        acols = A.indices[lo:hi]
        avals = A.data[lo:hi]
        aii = 0.0
        sum_neg = sum_pos = 0.0
        cs_neg = cs_pos = 0.0
        centries = []
        for c, v in zip(acols, avals):
            if c == i:
                aii += v
                continue
            if v < 0:
                sum_neg += v
            else:
                sum_pos += v
            if c in strong and is_C[c]:
                centries.append((c, v))
                if v < 0:
                    cs_neg += v
                else:
                    cs_pos += v
        if not centries:
            # isolated F point: interpolates nothing (zero row)
            continue
        alpha = sum_neg / cs_neg if cs_neg != 0 else 0.0
        beta = sum_pos / cs_pos if cs_pos != 0 else 0.0
        if cs_pos == 0:
            aii += sum_pos  # lump positive weak entries into the diagonal
        for c, v in centries:
            w = -(alpha * v) / aii if v < 0 else -(beta * v) / aii
            if w != 0.0:
                rows.append(i)
                cols.append(cmap[c])
                vals.append(w)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, int(is_C.sum())))


def amg_ruge_stuben(*, theta: float = 0.25, max_coarse: int = 2,
                    max_levels: int = 40):
    """Classical Ruge-Stuben prolongator factory (the default).

    Mirrors the role of the reference's ``amg_ruge_stuben``
    (``src/amg_prolongators.jl:16-18``); depth controlled by ``max_coarse``.
    """

    def prolongator(K: sp.spmatrix):
        from ..native import rs_level_native

        A = sp.csr_matrix(K, dtype=np.float64)
        Ps = []
        while A.shape[0] > max_coarse and len(Ps) < max_levels:
            P = rs_level_native(A, theta)   # C++ fast path (None = fallback)
            if P is None:
                S = _strength_graph(A, theta)
                is_C = _cf_split(S)
                nC = int(is_C.sum())
                if nC == 0 or nC >= A.shape[0]:
                    # no coarsening progress: force something smaller or stop
                    if A.shape[0] <= max_coarse or nC == 0:
                        break
                    keep = np.zeros(A.shape[0], dtype=bool)
                    keep[:: 2] = True
                    is_C = keep
                P = _direct_interpolation(A, S, is_C)
            if P.shape[1] >= A.shape[0]:
                break
            Ps.append(P)
            A = (P.T @ A @ P).tocsr()
            A.eliminate_zeros()
        return Ps

    return prolongator


def amg_smoothed_aggregation(*, theta: float = 0.0, omega: float = 4.0 / 3.0,
                             max_coarse: int = 2, max_levels: int = 40):
    """Smoothed-aggregation prolongator factory.

    Greedy aggregation on the (symmetrized) strength graph; tentative 0/1
    partition matrix smoothed by one weighted-Jacobi step
    ``P = (I - omega/rho D^{-1} A) T``. Mirrors the role of the reference's
    ``amg_smoothed_aggregation`` (``src/amg_prolongators.jl:27-29``).
    """

    def prolongator(K: sp.spmatrix):
        A = sp.csr_matrix(K, dtype=np.float64)
        Ps = []
        while A.shape[0] > max_coarse and len(Ps) < max_levels:
            n = A.shape[0]
            # strength: symmetric |A_ij| >= theta sqrt(|Aii Ajj|)
            d = np.abs(A.diagonal())
            coo = A.tocoo()
            mask = coo.row != coo.col
            if theta > 0:
                thr = theta * np.sqrt(d[coo.row] * d[coo.col])
                mask &= np.abs(coo.data) >= thr
            G = sp.csr_matrix((np.ones(mask.sum()),
                               (coo.row[mask], coo.col[mask])), shape=A.shape)
            G = G + G.T
            agg = -np.ones(n, dtype=np.int64)
            n_agg = 0
            # pass 1: aggregate around unaggregated roots
            for i in range(n):
                if agg[i] >= 0:
                    continue
                nbrs = G.indices[G.indptr[i]:G.indptr[i + 1]]
                if all(agg[j] < 0 for j in nbrs):
                    agg[i] = n_agg
                    for j in nbrs:
                        agg[j] = n_agg
                    n_agg += 1
            # pass 2: attach leftovers to a neighbouring aggregate
            for i in range(n):
                if agg[i] >= 0:
                    continue
                nbrs = G.indices[G.indptr[i]:G.indptr[i + 1]]
                for j in nbrs:
                    if agg[j] >= 0:
                        agg[i] = agg[j]
                        break
                if agg[i] < 0:
                    agg[i] = n_agg
                    n_agg += 1
            if n_agg >= n:
                break
            T = sp.csr_matrix((np.ones(n), (np.arange(n), agg)),
                              shape=(n, n_agg))
            Dinv = sp.diags(1.0 / np.where(A.diagonal() != 0, A.diagonal(), 1.0))
            DA = Dinv @ A
            # cheap spectral-radius estimate (few power iterations)
            v = np.random.default_rng(0).standard_normal(n)
            for _ in range(8):
                nv = np.linalg.norm(v)
                if nv == 0:
                    break
                v = DA @ (v / nv)
            rho = np.linalg.norm(v) or 1.0
            P = (sp.eye(n) - (omega / rho) * DA) @ T
            Ps.append(sp.csr_matrix(P))
            A = (P.T @ A @ P).tocsr()
            A.eliminate_zeros()
        return Ps

    return prolongator


def amg_pyamg(*, solver: str = "rootnode", **kwargs):
    """pyamg-backed prolongator (optional; pyamg is not in this image)."""
    try:
        import pyamg  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise ImportError("pyamg is not available in this environment") from e

    def prolongator(K: sp.spmatrix):  # pragma: no cover - env-gated
        import pyamg

        fns = {"rootnode": pyamg.rootnode_solver,
               "smoothed_aggregation": pyamg.smoothed_aggregation_solver,
               "ruge_stuben": pyamg.ruge_stuben_solver}
        ml = fns[solver](sp.csr_matrix(K), **kwargs)
        return [lvl.P.tocsr() for lvl in ml.levels[:-1]]

    return prolongator

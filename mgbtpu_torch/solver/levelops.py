"""Per-level batched "panel" operators (torch port of
``mgbtpu/solver/levelops.py``, float64 branches only).

For a hierarchy level with prolongation R (broken x n_J) and fine operators
D_k, the composed operators G_k = D_k R have element-local support: the rows
of element e touch at most C level columns. Per element we keep the set of
touched columns and the dense panels G_k[rows(e), cols(e)], after which

    Dz      = Dz0 + G s           K1 panel_fwd
    grad    = G' y                K3 panel_adj
    H v     = P' L L' P v         K4 gram_matvec (Gram form, large levels)
    H       = P' Y P, dense       einsum + index_add_ (levels <= DENSE_MAX)

``build_panel_ops`` is host numpy, copied from the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels
from ..ops.scatter import scatter_add


@dataclass
class PanelOps:
    cols: torch.Tensor       # (N, C) int64, sorted per element, padded by repeat
    panels: torch.Tensor     # (nD, N, p, C) float64
    n_nodes: int
    nD: int
    n_J: int
    p: int
    N: int
    C: int
    inv: torch.Tensor        # (n_J, K) int64: each column's flat slots
                             # e*C + c in increasing order, padded with N*C
    host_cols: np.ndarray    # host copy of cols (the ND plan's input)
    nd: Any = None           # ops.ndchol.NDDev: direct-solver plan of a
                             # level above DENSE_MAX (None: dense level)

    def apply_G(self, s, dz0=None):
        """(n_J,) level coefficients -> (n_nodes, nD) operator values
        (+ dz0 when given): kernel K1."""
        return kernels.panel_fwd(self.panels, self.cols, s, dz0)

    def apply_Gt(self, Y):
        """(n_nodes, nD) node values -> (n_J,) adjoint: kernel K3."""
        return kernels.panel_adj(self.panels, self.cols, self.inv, Y,
                                 self.n_J)

    def scatter_flat(self, contrib):
        """(N, C) per-slot contributions -> (n_J,) column sums."""
        out = torch.zeros((self.n_J,), dtype=contrib.dtype,
                          device=contrib.device)
        return scatter_add(out, self.cols.reshape(-1), contrib.reshape(-1))

    def _scatter_blocks(self, He):
        n = self.n_J
        flat = (self.cols[:, :, None] * n + self.cols[:, None, :]).reshape(-1)
        H = torch.zeros((n * n,), dtype=He.dtype, device=He.device)
        return scatter_add(H, flat, He.reshape(-1)).reshape(n, n)

    def assemble_dense(self, Ynode):
        """(n_nodes, nD, nD) per-node Hessian values -> dense (n_J, n_J)
        via the batched triple product."""
        Yr = Ynode.reshape(self.N, self.p, self.nD, self.nD)
        He = torch.einsum("iNpc,Npij,jNpd->Ncd", self.panels, Yr,
                          self.panels)
        return self._scatter_blocks(He)

    def assemble_gram(self, Lnode):
        """Gram-form assembly H = sum_i (L_i' P_i)' (L_i' P_i)."""
        return self._scatter_blocks(gram_element_blocks(self, Lnode))


@dataclass
class GramHessian:
    """Matrix-free Hessian in Gram form, H = (L' P)' (L' P): returned by the
    level f2 on levels above the dense threshold (``ops.nd`` set)."""
    ops: PanelOps
    Lnode: torch.Tensor      # (n_nodes, nD, nD) lower factors of bw*F2


def gram_matvec(ops: PanelOps, Lnode, v):
    """H v = B'(B v), fully matrix-free: kernel K4."""
    return kernels.gram_matvec(ops.panels, ops.cols, ops.inv, Lnode, v)


def _gram_B(ops: PanelOps, Lnode):
    Lr = Lnode.reshape(ops.N, ops.p, ops.nD, ops.nD)
    return torch.einsum("jNpc,Npji->Npic", ops.panels, Lr)


def gram_diag(ops: PanelOps, Lnode):
    """diag(H) = sum over (e,p,i) of B[e,p,i,c]^2."""
    B = _gram_B(ops, Lnode)
    return ops.scatter_flat((B * B).sum(dim=(1, 2)))


def gram_element_blocks(ops: PanelOps, Lnode, col_scale=None):
    """Per-element Gram blocks He[e] = (L' P_e)' (L' P_e), optionally with
    symmetric column scaling: the input of the nested-dissection factor."""
    Bf = _gram_B(ops, Lnode).reshape(ops.N, ops.p * ops.nD, ops.C)
    if col_scale is not None:
        Bf = Bf * col_scale[ops.cols][:, None, :]
    return torch.einsum("Nkc,Nkd->Ncd", Bf, Bf)


def build_panel_ops(D_fine, nu: int, R: sp.spmatrix, p: int,
                    device) -> PanelOps:
    """Host-side plan construction (copied from the reference).

    ``D_fine``: list of (BlockDiagHost, comp) fine operators; ``R``: the
    level prolongation (nu*m x n_J); ``p``: broken nodes per element.
    """
    from ..ops.blockdiag import block_column_sparse

    R = sp.csr_matrix(R)
    n_J = R.shape[1]
    m = R.shape[0] // nu
    N = m // p
    nD = len(D_fine)
    Gs = []
    for op, comp in D_fine:
        Dk = block_column_sparse(op, comp, nu)
        Gk = sp.csr_matrix(Dk @ R)
        Gk.sort_indices()
        Gs.append(Gk)

    # per-element union of touched columns across all k
    elems_all, cols_all = [], []
    for Gk in Gs:
        nnz_rows = np.repeat(np.arange(m), np.diff(Gk.indptr))
        elems_all.append(nnz_rows // p)
        cols_all.append(Gk.indices)
    if elems_all:
        # unique (element, column) pairs in lexicographic order, by one
        # int64 key (np.unique over rows sorts a structured view: seconds
        # at the spectral levels' millions of pairs)
        key = np.unique(np.concatenate(elems_all).astype(np.int64) * n_J
                        + np.concatenate(cols_all))
        ec = np.stack([key // n_J, key % n_J], axis=1)
    else:
        ec = np.zeros((0, 2), dtype=np.int64)
    counts = np.bincount(ec[:, 0], minlength=N)
    C = max(int(counts.max()) if N else 1, 1)
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    cols = np.zeros((N, C), dtype=np.int64)
    if len(ec):
        rows_f = ec[:, 0]
        slots_f = np.arange(len(ec)) - offsets[rows_f]
        cols[rows_f, slots_f] = ec[:, 1]
        has = counts > 0
        last = np.zeros(N, dtype=np.int64)
        last[has] = ec[offsets[1:][has] - 1, 1]
        pad = np.arange(C)[None, :] >= counts[:, None]
        cols[pad] = np.broadcast_to(last[:, None], (N, C))[pad]  # sorted pad
    panels = np.zeros((nD, N, p, C), dtype=np.float64)
    for k, Gk in enumerate(Gs):
        coo = Gk.tocoo()
        e = coo.row // p
        i = coo.row % p
        # slot of each col within its element's sorted column list
        slot = _vector_slots(cols, counts, e, coo.col)
        panels[k, e, i, slot] += coo.data
    return PanelOps(
        cols=torch.as_tensor(cols, device=device),
        panels=torch.as_tensor(panels, device=device),
        n_nodes=m, nD=nD, n_J=n_J, p=p, N=N, C=C,
        inv=torch.as_tensor(inverse_incidence(cols, n_J), device=device),
        host_cols=cols)


def inverse_incidence(cols: np.ndarray, n_J: int) -> np.ndarray:
    """(n_J, K) flat slots e*C + c of each column, increasing, padded with
    N*C. Padded slots of ``cols`` (a repeat of the element's last column,
    with zero panels) are left out."""
    N, C = cols.shape
    valid = np.ones((N, C), dtype=bool)
    valid[:, 1:] = cols[:, 1:] != cols[:, :-1]
    flat_pos = np.flatnonzero(valid.reshape(-1))
    flat_col = cols.reshape(-1)[flat_pos]
    o = np.argsort(flat_col, kind="stable")
    fp, fc = flat_pos[o], flat_col[o]
    cnt = np.bincount(fc, minlength=n_J)
    K = max(int(cnt.max()) if len(fc) else 1, 1)
    off = np.zeros(n_J + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    inv = np.full((n_J, K), N * C, dtype=np.int64)
    inv[fc, np.arange(len(fc)) - off[fc]] = fp
    return inv


def _vector_slots(cols, counts, e, c):
    """Vectorized per-element searchsorted via global (int64) keys."""
    N, C = cols.shape
    max_col = int(cols.max()) + 2 if cols.size else 2
    valid_e = np.repeat(np.arange(N), counts)
    pos_in_e = np.concatenate([np.arange(k) for k in counts]) if N else \
        np.zeros(0, dtype=np.int64)
    valid_c = cols[valid_e, pos_in_e]
    keys = valid_e.astype(np.int64) * max_col + valid_c.astype(np.int64)
    q = e.astype(np.int64) * max_col + c.astype(np.int64)
    idx = np.searchsorted(keys, q)
    return pos_in_e[idx]

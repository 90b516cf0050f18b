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

Under a mesh (``parallel/sharding.py``) a level whose element count
divides by the mesh size is a ``ShardedOps``: each shard holds the
``PanelOps`` of its contiguous element range (its cols and panels, nodes
e*p .. (e+1)*p - 1 of its elements e, as ``apply_D_full`` orders them) on
its device. K1 runs per shard on the broadcast s; K3's phase A and K4's
per-slot phase run per shard, and the first device sums every shard's
per-slot contributions, concatenated in shard order, in one phase B over
the level's inverse incidence: the level's slots in their order, so the
bits of one device. So do the Gram diagonal's per-slot values and the
dense assembly's per-element blocks: computed per shard, scattered once on
the first device in the level's order.

Both classes give the solver (``barrier.py``, ``newton.py``, ``fsai.py``,
``mgb.py``) one interface, per-node tensors travelling as one tensor a
shard: ``split`` and ``gather`` move a per-node tensor to the shards and
back, ``shard_G`` is K1 a shard, ``adjoint``, ``dense_hessian``,
``gram_apply``, ``gram_diagonal`` and ``gram_dense`` sum over the level,
``gram_blocks`` keeps the element blocks a shard and ``gram_blocks_first``
gathers them on the first device. A PanelOps is a level of one shard, whose
sums are its one-device kernels, so the solver has one path. Every level of
one problem spans the same fine elements, so a mesh shards their nodes
alike: the node factors of the solve level serve the V-cycle's coarser
levels as they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels
from ..ops.scatter import scatter_add
from ..parallel.sharding import Mesh, shard_ranges


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
                             # (None on a mesh's shard)
    host_cols: np.ndarray    # host copy of cols (the ND plan's input)
    pcg_ctx: Any = None      # PCGContext of a level above DENSE_MAX (None:
                             # a dense level)

    @property
    def nd(self):
        """The nested-dissection plan of the level's context, if any."""
        return None if self.pcg_ctx is None else self.pcg_ctx.nd

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

    def dense_blocks(self, Ynode):
        """(n_nodes, nD, nD) per-node Hessian values -> the per-element
        blocks (N, C, C) of the batched triple product."""
        Yr = Ynode.reshape(self.N, self.p, self.nD, self.nD)
        return torch.einsum("iNpc,Npij,jNpd->Ncd", self.panels, Yr,
                            self.panels)

    def assemble_dense(self, Ynode):
        """(n_nodes, nD, nD) per-node Hessian values -> dense (n_J, n_J)."""
        return self._scatter_blocks(self.dense_blocks(Ynode))

    # the level interface (see the module docstring): one shard
    def split(self, a):
        return (a,)

    def gather(self, parts):
        (q,) = parts
        return q

    def shard_G(self, s, dz0s):
        (dz0,) = dz0s
        return (self.apply_G(s, dz0),)

    def adjoint(self, Ys):
        return self.apply_Gt(self.gather(Ys))

    def dense_hessian(self, Ys):
        return self.assemble_dense(self.gather(Ys))

    def gram_apply(self, Ls, v):
        return gram_matvec(self, self.gather(Ls), v)

    def gram_diagonal(self, Ls):
        return gram_diag(self, self.gather(Ls))

    def gram_blocks(self, Ls, col_scale=None):
        return gram_element_blocks(self, self.gather(Ls), col_scale)

    def gram_blocks_first(self, Ls):
        return self.gram_blocks(Ls)

    def gram_dense(self, Ls):
        """Gram-form assembly H = sum_i (L_i' P_i)' (L_i' P_i)."""
        return self._scatter_blocks(self.gram_blocks_first(Ls))


@dataclass
class ShardedOps:
    """One level's panel operators over a mesh: ``shards[d]`` the PanelOps
    of elements [d N/n, (d+1) N/n) on ``mesh.devices[d]``, their nodes
    ``nodes[d]``; the sizes, and ``cols`` and ``inv``, are the whole
    level's (on the first device)."""
    mesh: Mesh
    shards: tuple
    nodes: tuple             # (lo, hi) node range of each shard
    n_nodes: int
    nD: int
    n_J: int
    p: int
    N: int
    C: int
    host_cols: np.ndarray
    cols: torch.Tensor
    inv: torch.Tensor
    pcg_ctx: Any = None

    nd = PanelOps.nd

    def split(self, a):
        """A per-node tensor (n_nodes, ...) on the first device -> its
        shards' rows on their devices (views where the device is its
        own)."""
        return tuple(a[lo:hi].to(d)
                     for (lo, hi), d in zip(self.nodes, self.mesh.devices))

    def gather(self, parts):
        """The shards' pieces, concatenated in shard order on the first
        device."""
        return torch.cat([self.mesh.gather(q, self.mesh.first)
                          for q in parts])

    def column_sums(self, contribs):
        """(n_J,) from each shard's per-slot contributions: K3's phase B
        once, on the first device."""
        return kernels.adjoint_sum(self.cols, self.inv, self.gather(contribs),
                                   self.n_J)

    def shard_G(self, s, dz0s):
        """(n_J,) coefficients -> each shard's (n_nodes_d, nD) operator
        values (+ its dz0): K1 per shard on the broadcast s."""
        return tuple(o.apply_G(sd, z) for o, sd, z in
                     zip(self.shards, self.mesh.broadcast(s), dz0s))

    def adjoint(self, Ys):
        """Each shard's node values -> the (n_J,) adjoint: K3's phase A per
        shard, its phase B once."""
        return self.column_sums(kernels.panel_adj_contrib(o.panels, Y)
                                for o, Y in zip(self.shards, Ys))

    def dense_hessian(self, Ynodes):
        """The dense (n_J, n_J) Hessian from each shard's (n_nodes_d, nD,
        nD) values: each shard's element blocks, scattered on the first
        device."""
        return PanelOps._scatter_blocks(self, self.gather(
            o.dense_blocks(Y) for o, Y in zip(self.shards, Ynodes)))

    def gram_apply(self, Ls, v):
        """The Gram matvec: K4's per-slot phase per shard on the broadcast
        v, then K3's phase B once."""
        return self.column_sums(
            kernels.gram_matvec_contrib(o.panels, o.cols, L, vd)
            for o, L, vd in zip(self.shards, Ls, self.mesh.broadcast(v)))

    def gram_diagonal(self, Ls):
        """diag(H): each shard's per-slot values, summed on the first
        device."""
        return PanelOps.scatter_flat(self, self.gather(
            _slot_diag(o, L) for o, L in zip(self.shards, Ls)))

    def gram_blocks(self, Ls, col_scale=None):
        """Each shard's Gram element blocks, on its device."""
        scales = (self.mesh.broadcast(col_scale) if col_scale is not None
                  else [None] * self.mesh.size)
        return tuple(gram_element_blocks(o, L, c)
                     for o, L, c in zip(self.shards, Ls, scales))

    def gram_blocks_first(self, Ls):
        """Every element's Gram block (N, C, C): each shard's, gathered in
        shard order on the first device."""
        return self.gather(self.gram_blocks(Ls))

    def gram_dense(self, Ls):
        """The dense (n_J, n_J) Gram Hessian: the element blocks scattered
        once on the first device in the level's order."""
        return PanelOps._scatter_blocks(self, self.gram_blocks_first(Ls))


@dataclass
class EllOp:
    """Row-padded (ELL) sparse matrix: matvec = gather + a small row
    reduction; the transpose-matvec runs as the same over the transposed
    ELL of the matrix. The hierarchy transfers of the V-cycle."""
    idx: torch.Tensor        # (n_rows, K) int64 column ids, padded by repeat
    val: torch.Tensor        # (n_rows, K), padding entries are 0
    t_idx: torch.Tensor      # (n_cols, Kt): the transposed ELL
    t_val: torch.Tensor
    n_rows: int
    n_cols: int

    def mv(self, x):
        return (self.val * x[self.idx]).sum(dim=1)

    def rmv(self, y):
        return (self.t_val * y[self.t_idx]).sum(dim=1)


def _ell_arrays(A: sp.csr_matrix):
    n = A.shape[0]
    counts = np.diff(A.indptr)
    K = max(int(counts.max()) if n else 1, 1)
    idx = np.zeros((n, K), dtype=np.int64)
    val = np.zeros((n, K), dtype=np.float64)
    if A.nnz:
        rows = np.repeat(np.arange(n), counts)
        slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
        idx[rows, slots] = A.indices
        val[rows, slots] = A.data
        # pad rows by repeating their last valid column (keeps idx in range)
        has = counts > 0
        last = np.zeros(n, dtype=np.int64)
        last[has] = A.indices[A.indptr[1:][has] - 1]
        pad = np.arange(K)[None, :] >= counts[:, None]
        idx[pad] = np.broadcast_to(last[:, None], (n, K))[pad]
    return idx, val


def build_ell(A: sp.spmatrix, device) -> EllOp:
    """Host-side ELL tiling of a scipy sparse matrix (copied from the
    reference), float64 on ``device``."""
    A = sp.csr_matrix(A, dtype=np.float64)
    idx, val = _ell_arrays(A)
    t_idx, t_val = _ell_arrays(sp.csr_matrix(A.T))

    def dev(a):
        return torch.as_tensor(a, device=device)

    return EllOp(idx=dev(idx), val=dev(val), t_idx=dev(t_idx),
                 t_val=dev(t_val), n_rows=A.shape[0], n_cols=A.shape[1])


@dataclass
class PCGContext:
    """The large-level solver of one level (n_J > DENSE_MAX), picked by
    ``newton.BIG_PRE`` when the level is set up: the nested-dissection plan
    (``nd``, the default), or the V-cycle and FSAI data:

    ``coarse_ops[l]`` are the panel operators of the chosen hierarchy
    levels (coarse to just below the solve level); ``transfers[l]`` maps
    chosen level l's coefficients to level l+1's (the last into the solve
    level). Levels <= ``dense_level`` get dense shifted-Cholesky inverses;
    the rest are smoothed with matrix-free Gram matvecs (K4). ``fsai`` is
    the FSAI plan of the solve level, ``coarse_T`` the composed transfer
    dense base -> solve level (BSR) of the two-level FSAI correction, and
    ``start[l]`` the power iteration's start vector on chosen level l
    (``start[n_levels]``: the solve level's)."""
    coarse_ops: tuple = ()
    transfers: tuple = ()
    n_levels: int = 0
    dense_level: int = -1
    fsai: Any = None
    coarse_T: Any = None
    nd: Any = None
    start: tuple = ()


@dataclass
class GramHessian:
    """Matrix-free Hessian in Gram form, H = (L' P)' (L' P): returned by the
    level f2 on levels above the dense threshold (``ops.pcg_ctx`` set), with
    ``Lnode`` one tensor a shard of ``ops`` (see ``split``)."""
    ops: Any
    Lnode: tuple             # (n_nodes_d, nD, nD) lower factors of bw*F2

    @property
    def ctx(self):
        return self.ops.pcg_ctx


def gram_matvec(ops: PanelOps, Lnode, v):
    """H v = B'(B v) on one device, fully matrix-free: kernel K4."""
    return kernels.gram_matvec(ops.panels, ops.cols, ops.inv, Lnode, v)


def _gram_B(ops: PanelOps, Lnode):
    Lr = Lnode.reshape(ops.N, ops.p, ops.nD, ops.nD)
    return torch.einsum("jNpc,Npji->Npic", ops.panels, Lr)


def gram_diag(ops: PanelOps, Lnode):
    """diag(H) = sum over (e,p,i) of B[e,p,i,c]^2."""
    return ops.scatter_flat(_slot_diag(ops, Lnode))


def _slot_diag(ops: PanelOps, Lnode):
    B = _gram_B(ops, Lnode)
    return (B * B).sum(dim=(1, 2))


def gram_element_blocks(ops: PanelOps, Lnode, col_scale=None):
    """Per-element Gram blocks He[e] = (L' P_e)' (L' P_e), optionally with
    symmetric column scaling: the input of the nested-dissection factor."""
    Bf = _gram_B(ops, Lnode).reshape(ops.N, ops.p * ops.nD, ops.C)
    if col_scale is not None:
        Bf = Bf * col_scale[ops.cols][:, None, :]
    return torch.einsum("Nkc,Nkd->Ncd", Bf, Bf)


def build_panel_ops(D_fine, nu: int, R: sp.spmatrix, p: int, device,
                    mesh: Mesh = None):
    """Host-side plan construction (copied from the reference).

    ``D_fine``: list of (BlockDiagHost, comp) fine operators; ``R``: the
    level prolongation (nu*m x n_J); ``p``: broken nodes per element.
    With a ``mesh`` whose size divides the element count, a ShardedOps
    (``device`` is then the mesh's first device).
    """
    cols, panels, m, n_J = _panel_arrays(D_fine, nu, R, p)
    N, C = cols.shape
    nD = panels.shape[0]
    ranges = None if mesh is None else shard_ranges(mesh, N)
    if ranges is None:
        return _panel_ops(cols, panels, m, n_J, p, device)
    # a shard's column sums run on the first device, over the whole
    # level's inverse incidence: the shards keep none
    shards = tuple(_panel_ops(cols[lo:hi], panels[:, lo:hi], (hi - lo) * p,
                              n_J, p, d, inv=False)
                   for (lo, hi), d in zip(ranges, mesh.devices))
    return ShardedOps(mesh=mesh, shards=shards,
                      nodes=tuple((lo * p, hi * p) for lo, hi in ranges),
                      n_nodes=m, nD=nD, n_J=n_J, p=p, N=N, C=C,
                      host_cols=cols,
                      cols=torch.as_tensor(cols, device=mesh.first),
                      inv=torch.as_tensor(inverse_incidence(cols, n_J),
                                          device=mesh.first))


def _panel_ops(cols, panels, n_nodes, n_J, p, device, inv=True) -> PanelOps:
    N, C = cols.shape
    return PanelOps(
        cols=torch.as_tensor(cols, device=device),
        panels=torch.as_tensor(np.ascontiguousarray(panels), device=device),
        n_nodes=n_nodes, nD=panels.shape[0], n_J=n_J, p=p, N=N, C=C,
        inv=(torch.as_tensor(inverse_incidence(cols, n_J), device=device)
             if inv else None),
        host_cols=cols)


def _panel_arrays(D_fine, nu, R, p):
    """(cols (N, C), panels (nD, N, p, C), fine nodes m, n_J) on the
    host."""
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
    return cols, panels, m, n_J


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

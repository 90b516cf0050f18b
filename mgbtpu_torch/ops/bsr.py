"""128-blocked sparse matrices (BSR): the level-space operators of the
large-level preconditioners (torch port of ``mgbtpu/ops/bsr.py``).

A matrix is a set of (B, B) dense tiles: ``tiles[t]`` is the block at
(row tile ``rid[t]``, column tile ``cid[t]``). A matvec is a tile gather,
one batched product and a segment sum over the tiles of each row tile
(a gather of the segment's tiles and a sum in tile order: the same bits
on every run, no atomics and no sort), with no element-wise sparse
gathers. The FSAI factor (``solver/fsai.py``) and the
composed coarse transfer of the two-level FSAI correction are held so.

Construction is host numpy/scipy, copied from the reference, with one
repair: the reference's ``build_bsr`` puts entries in the wrong tiles once a
matrix has more than one column tile (``tests/test_torch_precond.py``), so
its FSAI coarse correction is scrambled wherever the dense base exceeds 128
coefficients; here each entry goes to its own tile.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

B = 128  # tile edge


@dataclass
class BsrPattern:
    """The tile layout of a block-sparse matrix: ``tiles[t]`` (values kept
    apart) is the (B, B) block at (row tile ``rid[t]``, column tile
    ``cid[t]``), t in increasing (rid, cid) order; ``row_slots[i]`` lists
    the tiles of row tile i and ``col_slots[j]`` those of column tile j,
    in increasing t, padded with T (a zero tile). Rows/cols beyond
    ``n_rows``/``n_cols`` are zero padding."""
    rid: torch.Tensor        # (T,) int64
    cid: torch.Tensor        # (T,) int64
    row_slots: torch.Tensor  # (nrt, Kr) int64
    col_slots: torch.Tensor  # (nct, Kc) int64
    n_rows: int
    n_cols: int
    nrt: int
    nct: int
    T: int

    def mv(self, tiles, x):
        """A x for x of shape (n_cols,): (nrt * B,), padding rows 0."""
        g = _tiled(x, self.nct)[self.cid]                    # (T, B)
        y = torch.matmul(tiles, g.unsqueeze(-1)).squeeze(-1)
        return _segment_sum(y, self.row_slots)

    def rmv(self, tiles, y):
        """A' y for y of shape (n_rows,) or (nrt * B,): (nct * B,)."""
        g = _tiled(y, self.nrt)[self.rid]
        x = torch.matmul(g.unsqueeze(-2), tiles).squeeze(-2)
        return _segment_sum(x, self.col_slots)


@dataclass
class BsrMatrix:
    """Block-sparse matrix: a ``BsrPattern`` and its (T, B, B) float64
    tiles."""
    pattern: BsrPattern
    tiles: torch.Tensor

    def mv(self, x):
        """y = A x for x of shape (n_cols,). Returns (n_rows,)."""
        return self.pattern.mv(self.tiles, x)[: self.pattern.n_rows]

    def rmv(self, y):
        """x = A' y for y of shape (n_rows,). Returns (n_cols,)."""
        return self.pattern.rmv(self.tiles, y)[: self.pattern.n_cols]


def _tiled(v, nt):
    return torch.nn.functional.pad(v, (0, nt * B - v.shape[0])).reshape(nt, B)


def _segment_sum(y, slots):
    """(nt * B,): the sums of y's tile rows over each segment's slots, in
    increasing tile order (slot T, past y, is a zero tile)."""
    y = torch.nn.functional.pad(y, (0, 0, 0, 1))
    return y[slots].sum(dim=1).reshape(-1)


def _slots(seg, n):
    """(n, K): each segment's tile ids in increasing order, padded with
    len(seg)."""
    T = len(seg)
    cnt = np.bincount(seg, minlength=n)
    K = max(int(cnt.max()) if T else 1, 1)
    order = np.argsort(seg, kind="stable")
    start = np.zeros(n + 1, np.int64)
    np.cumsum(cnt, out=start[1:])
    out = np.full((n, K), T, np.int64)
    out[seg[order], np.arange(T) - start[seg[order]]] = order
    return out


def bsr_pattern(rows, cols, n, m, device):
    """The ``BsrPattern`` of the (rows, cols) entries of an n x m matrix
    on ``device``, and the tile id of each entry."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nrt = -(-n // B)
    nct = -(-m // B)
    key = (rows // B) * nct + cols // B
    uniq = np.unique(key)
    if not len(uniq):       # an empty matrix: one zero tile
        uniq = np.zeros(1, np.int64)
    rid, cid = uniq // nct, uniq % nct

    def dev(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    pattern = BsrPattern(rid=dev(rid), cid=dev(cid),
                         row_slots=dev(_slots(rid, nrt)),
                         col_slots=dev(_slots(cid, nct)),
                         n_rows=n, n_cols=m, nrt=nrt, nct=nct, T=len(uniq))
    return pattern, np.searchsorted(uniq, key)


def build_bsr(A: sp.spmatrix, device) -> BsrMatrix:
    """Host-side tiling of a scipy sparse matrix, as float64 tiles on
    ``device``. Each entry goes to its own tile (the reference pairs the
    tile ids, in sorted-key order, with the entries in COO order, which
    differ once the matrix has more than one column tile)."""
    coo = sp.coo_matrix(A)
    pattern, tid = bsr_pattern(coo.row, coo.col, *coo.shape, device)
    tiles = np.zeros((pattern.T, B, B), np.float64)
    np.add.at(tiles, (tid, coo.row % B, coo.col % B),
              coo.data.astype(np.float64))
    return BsrMatrix(pattern, torch.as_tensor(tiles, device=device))


def bsr_pattern_scatter(rows, cols, n: int, m: int, device):
    """The ``BsrPattern`` of entry slots (one a value the device will
    produce, in slot order) and ``flat_idx[s]``, the position of slot s in
    the flattened (T, B, B) tile array."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    pattern, tid = bsr_pattern(rows, cols, n, m, device)
    return pattern, tid * (B * B) + (rows % B) * B + (cols % B)

"""Factorized sparse approximate inverse (FSAI) preconditioner, BSR-backed
(torch port of ``mgbtpu/solver/fsai.py``).

For a level too large to factorize densely, the barrier Gram Hessian
H = sum_e P_e' Y_e P_e keeps its sparsity pattern from one centering to
the next while its values move, so the pattern is planned once on the
host and the values are refreshed on the device:

- the PATTERN (lower triangle of H's sparsity, truncated to
  ``MGBTPU_FSAI_K`` entries a row, read when the plan is built) is static
  per level;
- the VALUES: one scatter of the element Gram blocks into an ELL layout,
  a gather of k x k local blocks, a local equilibration read off each
  block's own diagonal, and an unrolled Gauss-Jordan batched solve;
- the APPLY runs through 128-blocked sparse tiles (``ops/bsr.py``).

Per row i with lower-neighbour set J_i (diagonal last), on the
equilibrated matrix Hs = D H D:

    g_i = (Hs[J_i, J_i])^-1 e_last,   G[i, J_i] = g_i / sqrt(g_i[last])

which gives diag(G Hs G') = 1 (Kolotilina-Yeremin FSAI), and
M^-1 = G'G is SPD. The Newton-level use (with the two-level coarse
correction of ``fsai2``/``fsai2a``) is in ``solver/newton.py``.

The plan is host numpy, copied from the reference; the sums of the
element blocks into H's slots run through ``scatter_add`` (a fixed order).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.bsr import B as _B
from ..ops.bsr import BsrPattern, bsr_pattern_scatter
from ..ops.scatter import scatter_add


@dataclass
class FSAIPlan:
    """Static pattern data of one level, on its device."""
    scat_idx: torch.Tensor  # (N*C*C,) int64 into flat (n_J*kh) H values
    diag_flat: torch.Tensor  # (n_J,) int64: flat ELL position of (i, i)
    low_idx: torch.Tensor   # (n_J, k) int64: lower-neighbour cols, diag last
    low_mask: torch.Tensor  # (n_J, k) bool
    pos: torch.Tensor       # (n_J, k, k) int64 into flat H values
    pos_ok: torch.Tensor    # (n_J, k, k) bool: entry present in pattern
    g: BsrPattern           # the tiles of G
    g_scat: torch.Tensor    # (n_real,) int64 into flat (g.T*B*B) G tiles
    g_slot: torch.Tensor    # (n_real,) int64: the (n_J*k) slots they fill
    n_J: int
    kh: int
    k: int


def build_fsai_plan(cols: np.ndarray, n_J: int, device) -> FSAIPlan:
    """Host-side pattern construction from the element column lists."""
    cols = np.asarray(cols, np.int64)
    N, C = cols.shape
    rows = np.repeat(cols, C, axis=1).ravel()          # (N*C*C,) row ids
    colsf = np.tile(cols, (1, C)).ravel()              # matching col ids
    P = sp.coo_matrix((np.ones(len(rows), np.int32), (rows, colsf)),
                      shape=(n_J, n_J)).tocsr()
    P.sum_duplicates()
    P.sort_indices()
    indptr, indices = P.indptr, P.indices
    counts = np.diff(indptr)
    kh = int(counts.max())

    r_of = np.repeat(np.arange(n_J), counts)
    s_of = np.arange(P.nnz) - np.repeat(indptr[:-1], counts)

    keys = r_of.astype(np.int64) * (n_J + 1) + indices

    def gslot(qr, qc):
        q = qr.astype(np.int64) * (n_J + 1) + qc
        return np.searchsorted(keys, q)

    # scatter map: element contribution (e, c, d) -> flat ELL slot
    g = gslot(rows, colsf)
    scat_idx = r_of[g] * kh + s_of[g]

    gd = gslot(np.arange(n_J), np.arange(n_J))
    diag_flat = r_of[gd] * kh + s_of[gd]

    # lower-triangular pattern, diagonal last. Per-row counts are capped at
    # MGBTPU_FSAI_K; a capped row keeps the neighbours sharing the most
    # elements with it (the multiplicity in P.data). Truncated FSAI stays
    # SPD: G is lower triangular with a positive diagonal.
    k_cap = int(os.environ.get("MGBTPU_FSAI_K", 32))
    low_mask_csr = indices <= r_of
    lr = r_of[low_mask_csr]
    lc = indices[low_mask_csr]
    lmult = np.asarray(P.data)[low_mask_csr].astype(np.int64)
    is_diag = lc == lr
    prio = np.where(is_diag, np.int64(1) << 40, lmult)
    order = np.lexsort((-lc, -prio, lr))          # rows contiguous
    lr_s, lc_s = lr[order], lc[order]
    cnt_all = np.bincount(lr_s, minlength=n_J)
    start = np.insert(np.cumsum(cnt_all), 0, 0)[:-1]
    rank = np.arange(len(lr_s)) - start[lr_s]
    keep = rank < k_cap
    lr, lc = lr_s[keep], lc_s[keep]
    o2 = np.lexsort((lc, lr))                     # ascending cols per row
    lr, lc = lr[o2], lc[o2]
    lcounts = np.bincount(lr, minlength=n_J)
    k = int(lcounts.max()) if len(lr) else 1
    low_idx = np.zeros((n_J, k), np.int64)
    low_mask = np.zeros((n_J, k), bool)
    ls = (np.arange(len(lr))
          - np.repeat(np.insert(np.cumsum(lcounts), 0, 0)[:-1], lcounts))
    # the diagonal (the largest kept col, always present) lands in slot k-1
    ls = ls + (k - lcounts)[lr]
    low_idx[lr, ls] = lc
    low_mask[lr, ls] = True
    pad = ~low_mask
    low_idx[pad] = np.broadcast_to(np.arange(n_J)[:, None], (n_J, k))[pad]

    # pos[i, a, b]: flat ELL slot of H[low_idx[i,a], low_idx[i,b]] where
    # present; padding / absent entries are masked
    qa = np.repeat(low_idx, k, axis=1).ravel()
    qb = np.tile(low_idx, (1, k)).ravel()
    qm = (np.repeat(low_mask, k, axis=1) & np.tile(low_mask, (1, k))).ravel()
    qkey = qa * (n_J + 1) + qb
    ppos = np.searchsorted(keys, qkey)
    ppos_c = np.minimum(ppos, len(keys) - 1)
    present = qm & (keys[ppos_c] == qkey)
    flat = np.where(present, r_of[ppos_c] * kh + s_of[ppos_c], 0)
    pos = flat.reshape(n_J, k, k)
    pos_ok = present.reshape(n_J, k, k)

    # BSR tiling of G's pattern (natural order). The reference scatters the
    # padding slots' zeros onto the row's diagonal slot; here only the real
    # slots are written, each once, so the fill is a plain index copy.
    g_tiles, g_flat = bsr_pattern_scatter(
        np.repeat(np.arange(n_J), k), low_idx.ravel(), n_J, n_J, device)
    real = low_mask.ravel()

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return FSAIPlan(
        scat_idx=dev(scat_idx), diag_flat=dev(diag_flat),
        low_idx=dev(low_idx), low_mask=dev(low_mask, torch.bool),
        pos=dev(pos), pos_ok=dev(pos_ok, torch.bool), g=g_tiles,
        g_scat=dev(g_flat[real]), g_slot=dev(np.flatnonzero(real)),
        n_J=n_J, kh=kh, k=k)


def _gj_solve_last(Bk):
    """x with Bk x = e_last for a batch of SPD (k, k) blocks, by unrolled
    Gauss-Jordan elimination (no pivoting: the blocks are jittered SPD),
    in the reference's order of operations."""
    n, k, _ = Bk.shape
    e = torch.zeros((n, k, 1), dtype=Bk.dtype, device=Bk.device)
    e[:, k - 1, 0] = 1.0
    M = torch.cat([Bk, e], dim=2)                      # (n, k, k+1)
    tiny = torch.tensor(1e-30, dtype=Bk.dtype, device=Bk.device)
    for j in range(k):
        piv = M[:, j, j][:, None]
        piv = torch.where(torch.abs(piv) > 1e-30, piv, tiny)
        rowj = M[:, j, :] / piv                        # (n, k+1)
        fac = M[:, :, j]                               # (n, k)
        M = M - fac[:, :, None] * rowj[:, None, :]
        M[:, j, :] = rowj
    return M[:, :, k]


def fsai_values(plan: FSAIPlan, ops, Ls):
    """FSAI factor values from the current node factors ``Ls`` (one tensor
    a shard of ``ops``, as ``GramHessian.Lnode``): the element Gram blocks
    come from each shard and are summed on the first device, where the
    factor lives.

    Returns ``(Gtiles, dpos)``: the BSR value tiles of the factor G built
    on the equilibrated matrix Hs = D H D, D = diag(1/sqrt(diag H)), and
    ``dpos = sqrt(diag H)`` (the CG equilibration scale). Each local block
    is equilibrated from its own diagonal: the same values as a global
    equilibration."""
    He = ops.gram_blocks_first(Ls)                          # (N, C, C)
    dtype, device = He.dtype, He.device
    Hvals = scatter_add(
        torch.zeros((plan.n_J * plan.kh,), dtype=dtype, device=device),
        plan.scat_idx, He.reshape(-1))
    dpos = torch.sqrt(torch.clamp(Hvals[plan.diag_flat], min=1e-30))
    k = plan.k
    zero = torch.zeros((), dtype=dtype, device=device)
    Bblk = torch.where(plan.pos_ok, Hvals[plan.pos], zero)  # (n_J, k, k)
    dloc = torch.diagonal(Bblk, dim1=1, dim2=2)             # (n_J, k)
    sloc = 1.0 / torch.sqrt(torch.clamp(dloc, min=1e-30))
    sloc = torch.where(plan.low_mask, sloc, torch.ones_like(sloc))
    Bblk = Bblk * sloc[:, :, None] * sloc[:, None, :]
    eye = torch.eye(k, dtype=dtype, device=device)
    Bblk = torch.where(plan.pos_ok, Bblk, eye[None, :, :])
    Bblk = Bblk + 1e-6 * eye[None, :, :]
    gsol = _gj_solve_last(Bblk)                             # (n_J, k)
    scale = torch.sqrt(torch.clamp(gsol[:, -1], min=1e-30))
    G_vals = (gsol / scale[:, None]).reshape(-1)
    Gtiles = torch.zeros((plan.g.T * _B * _B,), dtype=dtype, device=device)
    Gtiles[plan.g_scat] = G_vals[plan.g_slot]
    return Gtiles.reshape(plan.g.T, _B, _B), dpos


def fsai_apply(plan: FSAIPlan, Gtiles, rs):
    """M_s r = G' (G r) in equilibrated coordinates (SPD), through the BSR
    tiles twice (the adjoint reuses the tiles with the roles swapped)."""
    return plan.g.rmv(Gtiles, plan.g.mv(Gtiles, rs))[: plan.n_J]

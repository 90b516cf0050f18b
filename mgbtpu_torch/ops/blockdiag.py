"""Host-side structured block operators.

The reference's ``BlockDiag`` (``src/BlockMatrices.jl:11-29``) stores a broken
FEM operator as one dense p-by-q block per element, here an ``(N, p, q)``
dense array whose matvec is one batched einsum.

This module holds the *host* (numpy/scipy) representation used during setup;
the device form lives in ``solver/levelops.py``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class BlockDiagHost:
    """Element-block-diagonal operator: data[e] is the p-by-q block of element e."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim != 3:
            raise ValueError("BlockDiagHost data must be (N, p, q)")
        self.data = data

    @property
    def shape(self):
        N, p, q = self.data.shape
        return (N * p, N * q)

    @property
    def nblocks(self):
        return self.data.shape[0]

    def to_sparse(self) -> sp.csr_matrix:
        N, p, q = self.data.shape
        return sp.block_diag([self.data[e] for e in range(N)], format="csr") \
            if N > 1 else sp.csr_matrix(self.data[0])

    def matvec(self, v: np.ndarray) -> np.ndarray:
        N, p, q = self.data.shape
        return np.einsum("epq,eq->ep", self.data, v.reshape(N, q)).reshape(-1)

    def rmatvec(self, v: np.ndarray) -> np.ndarray:
        N, p, q = self.data.shape
        return np.einsum("epq,ep->eq", self.data, v.reshape(N, p)).reshape(-1)

    def __matmul__(self, v):
        return self.matvec(np.asarray(v))


def extract_block_diag(A: sp.spmatrix, p: int, q: int | None = None) -> BlockDiagHost:
    """Extract the (N, p, q) block-diagonal structure from a sparse matrix.

    Raises if A has entries outside the block-diagonal pattern. Mirrors the
    reference's ``_extract_block_diag`` round-trip contract
    (``src/BlockMatrices.jl:97-116``).
    """
    q = p if q is None else q
    A = sp.csr_matrix(A)
    n_r, n_c = A.shape
    if n_r % p or n_c % q:
        raise ValueError("matrix dims not divisible by block size")
    N = n_r // p
    if n_c // q != N:
        raise ValueError("row/col block counts differ")
    out = np.zeros((N, p, q), dtype=A.dtype)
    coo = A.tocoo()
    er, lr = np.divmod(coo.row, p)
    ec, lc = np.divmod(coo.col, q)
    if np.any(er != ec):
        raise ValueError("matrix has entries outside the block diagonal")
    out[er, lr, lc] = coo.data
    return BlockDiagHost(out)


def block_column_sparse(op, active: int, nu: int) -> sp.csr_matrix:
    """Sparse form of ``[0 ... op ... 0]`` with ``op`` in column-block ``active``
    of ``nu`` equal blocks — the shape of every fine operator row D_fine[k]
    (reference ``BlockColumn``, ``src/BlockMatrices.jl:32-46``)."""
    A = op.to_sparse() if isinstance(op, BlockDiagHost) else sp.csr_matrix(op)
    n_r, n_c = A.shape
    blocks = [sp.csr_matrix((n_r, n_c)) for _ in range(nu)]
    blocks[active] = A
    return sp.hstack(blocks, format="csr")

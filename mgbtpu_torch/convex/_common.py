"""Shared helpers for the convex-set constructors and the barriers' plain
versions.

Host-side sampling (``resolve_x``, ``sample_grid``) and, in tensor idiom
over the node axis, the scalar-list algebra of ``mgbtpu/convex/_common.py``
(:27-155): a per-node vector is a list of (m,) columns, a per-node matrix a
nested list of them, sums are left folds in the reference's order, and the
scatters to the row width put exact zeros outside a piece's rows.
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch


def resolve_x(mg):
    """Flat (n_nodes, dim) node coordinates from a MultiGrid/Geometry/array."""
    if mg is None:
        raise ValueError("a mesh (mg=) or explicit grids are required")
    g = mg.geometry if hasattr(mg, "geometry") else mg
    if hasattr(g, "xflat"):
        return np.asarray(g.xflat())
    return np.asarray(mg)


def sample_grid(fn, x, dtype, width=None):
    """Sample closure ``fn(x_row)`` over nodes into an (n, width) grid."""
    from ..utils.maps import sample_rows

    return sample_rows(fn, x, dtype, width=width)


def ssum(parts):
    """Left-fold sum of a list of tensors (the reference's ``ssum``)."""
    return functools.reduce(operator.add, parts)


def gather(idx, y):
    """Columns y[:, idx] as a list of (m,) tensors (``vec_scalars``)."""
    return [y[:, j] for j in idx]


def mat_cols(A, nr, nc):
    """Row-major flat per-node matrix (m, nr*nc) -> nested list of (m,)
    columns (``mat_scalars``)."""
    return [[A[:, i * nc + j] for j in range(nc)] for i in range(nr)]


def scatter_vec(idx, vals, N, like):
    """List of (m,) columns at the rows ``idx`` -> (m, N), exact zeros
    elsewhere (``scatter_svec``)."""
    pos = {j: k for k, j in enumerate(idx)}
    zero = torch.zeros_like(like)
    return torch.stack([vals[pos[j]] if j in pos else zero
                        for j in range(N)], dim=1)


def scatter_mat(idx, H, N, like):
    """Nested list at the rows/columns ``idx`` -> (m, N, N), exact zeros
    elsewhere (``scatter_smat``)."""
    pos = {j: k for k, j in enumerate(idx)}
    zero = torch.zeros_like(like)
    return torch.stack([torch.stack(
        [H[pos[i]][pos[j]] if i in pos and j in pos else zero
         for j in range(N)], dim=1) for i in range(N)], dim=1)

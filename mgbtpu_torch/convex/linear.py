"""Linear inequality constraints: A(x) y[idx] + b(x) > 0 componentwise.

Barrier: -sum(log(F_i)). Port of ``mgbtpu/convex/linear.py`` (reference
``src/convex_linear.jl:87-223``). A is (nc, ni) per node (stored row-major
flattened), b is (nc,) per node. The barrier and cobarrier run through
kernel K6 (``kernels/node_barrier.py``, whose plain version holds the
closed forms); the slack estimate is plain PyTorch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.node_barrier import LINEAR, Piece, linear_parts
from ._common import resolve_x, sample_grid
from .convex import Convex, input_spec_from_idx


def convex_linear(mg=None, *, idx=None, A=None, b=None, A_grid=None,
                  b_grid=None, x=None, dtype=np.float64):
    """Build the linear-constraint Convex. ``idx`` is a tuple of 0-based
    input rows (None = all rows); ``A(x)->(nc, ni)`` and ``b(x)->(nc,)`` (or
    a scalar) are sampled at the mesh nodes unless grids are passed."""
    xs = resolve_x(mg) if x is None else np.asarray(x)
    n = xs.shape[0]
    idx_t = None if idx is None else tuple(int(i) for i in idx)

    if A_grid is None:
        if A is None:
            if idx_t is None:
                raise ValueError("idx=None with identity A cannot determine the "
                                 "constraint size; pass idx, A, or A_grid")
            ni = len(idx_t)
            A_grid = np.tile(np.eye(ni, dtype=dtype).reshape(1, -1), (n, 1))
            nc = ni
        else:
            nc = np.asarray(A(xs[0]), dtype=dtype).shape[0]
            A_grid = sample_grid(
                lambda xi: np.asarray(A(xi), dtype=dtype).reshape(-1), xs, dtype)
    else:
        A_grid = np.asarray(A_grid, dtype=dtype)
        if b_grid is None and not callable(b):
            raise ValueError("explicit A_grid needs b_grid (or callable b) to fix nc")
        nc = None

    if b_grid is None:
        if b is None:
            b_grid = np.zeros((n, nc), dtype=dtype)
        elif np.asarray(b(xs[0])).ndim == 0:
            if nc is None:
                raise ValueError("scalar-valued b needs A (or idx) to fix nc")
            b_grid = np.zeros((n, nc), dtype=dtype)
            for i in range(n):
                b_grid[i, :] = b(xs[i])
        else:
            b_grid = sample_grid(lambda xi: np.asarray(b(xi), dtype=dtype),
                                 xs, dtype)
    else:
        b_grid = np.asarray(b_grid, dtype=dtype)
    nc = b_grid.shape[1]
    if A_grid.shape[1] % nc != 0:
        raise ValueError(
            f"A_grid has {A_grid.shape[1]} columns/node, not a multiple of nc={nc}")
    ni = A_grid.shape[1] // nc
    if idx_t is not None and ni != len(idx_t):
        raise ValueError(f"A implies ni={ni} but len(idx)={len(idx_t)}")
    idx_r = tuple(range(ni)) if idx_t is None else idx_t

    def Slack(args, Dz):
        _, F = linear_parts(args[0], args[1], idx_r, Dz)
        return -functools.reduce(torch.minimum, F)

    return Convex(args=(A_grid, b_grid),
                  pieces=(Piece(LINEAR, idx_r, nc),), slack=Slack,
                  input_spec=input_spec_from_idx(idx_t, ni))

"""Piecewise-active constraint combination.

At each node, over the active pieces k (``select(x)[k]`` truthy): barrier
= sum_k, cobarrier = sum_k, slack = max_k. The selection grid is a per-node
float matrix (nonzero = active). An inactive piece contributes exactly zero
(or -inf for the slack max), dropped with ``where`` before arithmetic, never
multiplied: a piece whose barrier is +/-inf at an inactive node must not
poison the sum. Pieces are summed in piece order. Port of
``mgbtpu/convex/piecewise.py`` (reference ``src/convex_piecewise.jl:
114-182``): the combined set is one piece table, so each mode is one K6
launch (``kernels/node_barrier.py``), not one launch per piece.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ._common import resolve_x, sample_grid
from .convex import Convex


def convex_piecewise(Q, *, mg=None, select=None, select_grid=None, x=None,
                     dtype=np.float64):
    """Combine pieces ``Q`` (tuple of single-piece Convex) with spatial
    selectivity: ``select(x)`` (or ``select_grid``, (n, len(Q))) marks the
    active pieces at each node; default all."""
    Q = tuple(Q)
    npc = len(Q)
    for q in Q:
        if q.select or len(q.pieces) != 1:
            raise ValueError("a piece of a piecewise set must be a single "
                             "power cone or linear block")
    if select_grid is None:
        xs = resolve_x(mg) if x is None else np.asarray(x)
        if select is None:
            select_grid = np.ones((xs.shape[0], npc), dtype=dtype)
        else:
            select_grid = sample_grid(
                lambda xi: np.asarray(select(xi), dtype=dtype), xs, dtype)
    else:
        select_grid = np.asarray(select_grid, dtype=dtype)
    if select_grid.shape[1] != npc:
        raise ValueError("select grid width must equal the piece count")

    # args layout: (select, piece 1 grids..., piece 2 grids..., ...)
    starts = np.cumsum([1] + [len(q.args) for q in Q]).tolist()

    def slack(args, Dz):
        sel = args[0]
        total = None
        for k, q in enumerate(Q):
            val = q.slack(args[starts[k]:starts[k + 1]], Dz)
            val = torch.where(sel[:, k] != 0, val,
                              torch.full_like(val, -math.inf))
            total = val if total is None else torch.maximum(total, val)
        return total

    return Convex(
        args=(select_grid,) + tuple(a for q in Q for a in q.args),
        pieces=tuple(q.pieces[0].shifted(starts[k]) for k, q in enumerate(Q)),
        slack=slack,
        input_spec=("all", tuple(q.input_spec for q in Q)),
        select=True)

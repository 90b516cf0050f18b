"""Euclidean power cone: {y : s >= ||q||_2^p}, [q; s] = A(x) y[idx] + b(x).

Barrier: -log(s^(2/p) - ||q||^2) - mu(p) log(s), with mu = 0 for p in
{1, 2}, 1 for p < 2, 2 for p > 2. Port of ``mgbtpu/convex/
euclidian_power.py`` (reference ``src/convex_euclidian_power.jl``): the
closed forms are written once, as batched tensor code over the node axis,
in ``kernels/power_cone.py`` (and in ``csrc/power_cone.cuh`` for the
kernels). A lone cone's barrier runs through kernel K2
(``power_cone_eval``); its phase-I cobarrier, and the cone as a piece of a
piecewise set, through K6 (``node_barrier``). The slack estimate (once, at
the start of phase I) is plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import power_cone as K2
from ..kernels.node_barrier import POWER, Piece
from ..utils.log import safe_pow
from ._common import resolve_x, sample_grid, ssum
from .convex import Convex, input_spec_from_idx


def _mu_of_p(p):
    p = np.asarray(p, dtype=np.float64)
    mu = np.where(p < 2.0, 1.0, 2.0)
    mu = np.where((p == 1.0) | (p == 2.0), 0.0, mu)
    return mu


def convex_euclidian_power(mg=None, *, idx=None, A=None, b=None, p=2.0,
                           A_grid=None, b_grid=None, p_grid=None, x=None,
                           dtype=np.float64):
    """Build the Euclidean-power-cone Convex.

    ``idx`` is a tuple of 0-based positions into the per-node input vector
    y = Dz (None = all rows); ``A(x)->(nz,nz)``, ``b(x)->(nz,) or scalar``,
    ``p(x)->scalar`` (or a plain number) are sampled at the mesh nodes
    unless pre-built grids are passed.
    """
    xs = resolve_x(mg) if x is None else np.asarray(x)
    n = xs.shape[0]
    idx_t = None if idx is None else tuple(int(i) for i in idx)

    if A_grid is None:
        if idx_t is not None:
            nz = len(idx_t)
        else:
            if A is None:
                raise ValueError("idx=None needs a matrix-valued A (or A_grid) "
                                 "to determine the constraint dimension")
            nz = np.asarray(A(xs[0])).shape[0]
        if A is None:
            A_grid = np.tile(np.eye(nz, dtype=dtype).reshape(1, -1), (n, 1))
        else:
            A_grid = sample_grid(
                lambda xi: np.asarray(A(xi), dtype=dtype).reshape(-1), xs, dtype)
    else:
        A_grid = np.asarray(A_grid, dtype=dtype)
        nz = int(round(np.sqrt(A_grid.shape[1])))
        if nz * nz != A_grid.shape[1]:
            raise ValueError("A_grid columns must be a square count nz^2")
    if idx_t is not None and len(idx_t) != nz:
        raise ValueError(f"len(idx)={len(idx_t)} but A implies nz={nz}")

    if b_grid is None:
        if b is None:
            b_grid = np.zeros((n, nz), dtype=dtype)
        elif np.asarray(b(xs[0])).ndim == 0:
            # scalar b lands in the s slot (last), zeros elsewhere
            def bfn(xi):
                out = np.zeros((nz,), dtype=dtype)
                out[-1] = b(xi)
                return out
            b_grid = sample_grid(bfn, xs, dtype)
        else:
            b_grid = sample_grid(lambda xi: np.asarray(b(xi), dtype=dtype),
                                 xs, dtype)
    else:
        b_grid = np.asarray(b_grid, dtype=dtype)
    if b_grid.shape[1] != nz:
        raise ValueError(f"b_grid has {b_grid.shape[1]} values/node, need nz={nz}")

    if p_grid is None:
        if callable(p):
            p_grid = sample_grid(lambda xi: np.asarray(p(xi), dtype=dtype),
                                 xs, dtype)[:, 0]
        else:
            p_grid = np.full((n,), float(p), dtype=dtype)
    else:
        p_grid = np.asarray(p_grid, dtype=dtype)
    mu_grid = _mu_of_p(p_grid).astype(dtype)
    # static alpha specialization: constant p with alpha = 2/p in {1, 2}
    # (p = 2 and the headline p = 1) skips the transcendental power chain
    spec = 0
    if p_grid.size and np.all(p_grid == p_grid.flat[0]):
        a0 = 2.0 / float(p_grid.flat[0])
        if a0 in (1.0, 2.0):
            spec = int(a0)

    idx_r = tuple(range(nz)) if idx_t is None else idx_t

    def Slack(args, Dz):
        A_, b_, p_, _ = args
        q, s = K2.core_parts(A_, b_, idx_r, Dz)
        q_sq = ssum([qi * qi for qi in q])
        return -torch.minimum(s - safe_pow(q_sq, p_ / 2.0), s)

    return Convex(args=(A_grid, b_grid, p_grid, mu_grid),
                  pieces=(Piece(POWER, idx_r, nz, spec),), slack=Slack,
                  input_spec=input_spec_from_idx(idx_t, nz))

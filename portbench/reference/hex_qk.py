"""Tensor-product Q_k elements on the uniformly subdivided cube [-1, 1]^d.

The upstream ``fem1d``/``fem2d``/``fem3d`` element: k + 1 Chebyshev-Lobatto
nodes -cos(pi i / k) per axis, local node v = a_0 + s a_1 + s^2 a_2 (axis 0
fastest, s = k + 1), nodal weights the interpolatory (Clenshaw-Curtis) rule.
``subdivide(geometry, L)`` halves every element L - 1 times; child c of
element e becomes element 8 e + c (2^d e + c), bit a of c choosing the low
or high half along axis a. Every element is the same cube scaled by h/2, so
one derivative matrix per axis serves them all.
"""
from __future__ import annotations

import numpy as np

from . import Discretization


def lobatto_nodes(k: int) -> np.ndarray:
    return -np.cos(np.pi * np.arange(k + 1) / k)


def nodal_basis(nodes: np.ndarray):
    """(derivative matrix D[i, j] = L_j'(x_i), weights w_j = int L_j) of the
    Lagrange basis on ``nodes`` over [-1, 1], from its monomial
    coefficients."""
    s = len(nodes)
    V = nodes[:, None] ** np.arange(s)[None, :]
    C = np.linalg.inv(V)                  # L_j = sum_m C[m, j] x^m
    m = np.arange(s)
    dV = np.zeros_like(V)
    dV[:, 1:] = m[1:] * nodes[:, None] ** (m[1:] - 1)
    moments = (1.0 - (-1.0) ** (m + 1)) / (m + 1)
    return dV @ C, moments @ C


def element_centers(d: int, level: int) -> np.ndarray:
    """(2^(d (level-1)), d) centers, in the order of the subdivision."""
    centers = np.zeros((1, d))
    h = 2.0
    for _ in range(level - 1):
        bits = (np.arange(1 << d)[:, None] >> np.arange(d)[None, :]) & 1
        offs = (2.0 * bits - 1.0) * (h / 4)
        centers = (centers[:, None, :] + offs[None, :, :]).reshape(-1, d)
        h /= 2
    return centers


def build(cfg) -> Discretization:
    d, k = int(cfg["reference"]["dim"]), int(cfg["reference"]["order"])
    level = int(cfg["level"])
    s = k + 1
    n = s ** d
    nodes1 = lobatto_nodes(k)
    D1, w1 = nodal_basis(nodes1)
    mi = (np.arange(n)[:, None] // s ** np.arange(d)[None, :]) % s   # (n, d)

    centers = element_centers(d, level)
    N = len(centers)
    h = 2.0 / 2 ** (level - 1)
    x = (centers[:, None, :] + (h / 2) * nodes1[mi][None, :, :]).reshape(-1, d)
    w = np.tile(np.prod(w1[mi], axis=1) * (h / 2) ** d, N)

    deriv = np.empty((d, 1, n, n))
    for a in range(d):
        same = np.ones((n, n), dtype=bool)
        for b in range(d):
            if b != a:
                same &= mi[:, None, b] == mi[None, :, b]
        deriv[a, 0] = np.where(same, D1[mi[:, None, a], mi[None, :, a]],
                               0.0) * (2.0 / h)

    ne = 2 ** (level - 1)                      # elements per axis
    cell = np.rint((centers + 1.0) / h - 0.5).astype(np.int64)      # (N, d)
    lattice = (k * cell[:, None, :] + mi[None, :, :]).reshape(-1, d)
    side = k * ne + 1
    dof = (lattice * side ** np.arange(d)[None, :]).sum(axis=1)
    on_edge = ((lattice == 0) | (lattice == side - 1)).any(axis=1)
    boundary = np.zeros(side ** d, dtype=bool)
    boundary[dof[on_edge]] = True
    return Discretization(x=x, w=w, elem=np.arange(N * n).reshape(N, n),
                          deriv=deriv, dof=dof, boundary=boundary)

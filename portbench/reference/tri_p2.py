"""P2 triangles with the cubic bubble (7 nodes) on the subdivided square.

The upstream ``fem2d_P2`` element: nodes corner A, midpoint AB, corner B,
midpoint BC, corner C, midpoint CA, centroid; basis span{1, x, y, x^2, xy,
y^2, (1 - x - y) x y}; nodal weights the integrals of the nodal basis. The
square [-1, 1]^2 starts as the triangles (-1,-1) (1,-1) (-1,1) and (1,-1)
(1,1) (-1,1); ``subdivide(geometry, L)`` splits each triangle ABC L - 1
times into (CA, A, AB), (AB, B, BC), (BC, C, CA), (AB, BC, CA), child c of
element e becoming element 4 e + c. The maps are affine, so each element's
derivative matrices are the reference ones under its inverse Jacobian.
"""
from __future__ import annotations

from math import factorial

import numpy as np

from . import Discretization

REF_NODES = np.array([[0.0, 0.0], [0.5, 0.0], [1.0, 0.0], [0.5, 0.5],
                      [0.0, 1.0], [0.0, 0.5], [1 / 3, 1 / 3]])
EXPONENTS = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))


def _span(p):
    """Values and gradients of the 7 spanning functions at points p."""
    x, y = p[:, 0], p[:, 1]
    val = [x ** a * y ** b for a, b in EXPONENTS]
    gx = [a * x ** max(a - 1, 0) * y ** b for a, b in EXPONENTS]
    gy = [b * x ** a * y ** max(b - 1, 0) for a, b in EXPONENTS]
    val.append((1 - x - y) * x * y)
    gx.append(y * (1 - 2 * x - y))
    gy.append(x * (1 - x - 2 * y))
    return np.stack(val, 1), np.stack(gx, 1), np.stack(gy, 1)


def reference_element():
    """(Gx, Gy, w): derivatives of nodal basis j at node i on the unit
    triangle, and the integrals of the nodal basis over it."""
    V, Vx, Vy = _span(REF_NODES)
    C = np.linalg.inv(V)
    ints = [factorial(a) * factorial(b) / factorial(a + b + 2)
            for a, b in EXPONENTS] + [1 / 24 - 2 / 60]
    return Vx @ C, Vy @ C, np.asarray(ints) @ C


def triangles(level: int) -> np.ndarray:
    """(2 * 4^(level-1), 3, 2) corners A, B, C in the order of the
    subdivision."""
    T = np.array([[[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0]],
                  [[1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]])
    for _ in range(level - 1):
        A, B, C = T[:, 0], T[:, 1], T[:, 2]
        AB, BC, CA = (A + B) / 2, (B + C) / 2, (C + A) / 2
        kids = np.stack([np.stack(c, 1) for c in
                         ((CA, A, AB), (AB, B, BC), (BC, C, CA),
                          (AB, BC, CA))], 1)
        T = kids.reshape(-1, 3, 2)
    return T


def build(cfg) -> Discretization:
    level = int(cfg["level"])
    T = triangles(level)
    N = len(T)
    A, B, C = T[:, 0], T[:, 1], T[:, 2]
    pts = np.stack([A, (A + B) / 2, B, (B + C) / 2, C, (C + A) / 2,
                    (A + B + C) / 3], 1)                        # (N, 7, 2)
    x = pts.reshape(-1, 2)
    Gx, Gy, wref = reference_element()
    J = np.stack([B - A, C - A], 2)                             # J[e, :, col]
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    inv = np.linalg.inv(J)                                      # d(xi,eta)/dx
    deriv = np.stack([inv[:, 0, a, None, None] * Gx[None]
                      + inv[:, 1, a, None, None] * Gy[None]
                      for a in range(2)])                       # (2, N, 7, 7)
    w = (det[:, None] * wref[None, :]).reshape(-1)

    # corners and midpoints lie on a lattice of step 2^(1-level); centroids
    # belong to one element each
    key = np.rint((x + 1.0) * 2 ** level).astype(np.int64)
    side = 2 ** (level + 1) + 1
    lat = key[:, 0] + side * key[:, 1]
    centroid = np.zeros((N, 7), dtype=bool)
    centroid[:, 6] = True
    centroid = centroid.reshape(-1)
    lat = np.where(centroid, side * side + np.arange(N * 7), lat)
    uniq, dof = np.unique(lat, return_inverse=True)
    edge = ((key == 0) | (key == side - 1)).any(axis=1) & ~centroid
    boundary = np.zeros(len(uniq), dtype=bool)
    boundary[dof[edge]] = True
    return Discretization(x=x, w=w, elem=np.arange(N * 7).reshape(N, 7),
                          deriv=deriv, dof=dof, boundary=boundary)

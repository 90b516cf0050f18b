"""Single-level geometry container + coordinate dedup.

Host-side (numpy) analogue of the reference's ``Geometry``
(``src/multigrid.jl:37-57``): descriptor, cached full-node connectivity ``t``
(shape (V, N), ``t[v, e]`` = global node id, so coincident broken nodes share
an id), broken mesh tensor ``x`` (V, N, e), quadrature weights ``w`` (V*N,),
and per-discretization broken operators (block-diagonal, see
``ops.blockdiag.BlockDiagHost``). Everything here is setup-time data; the solver
ships only the arrays it touches to the device.
"""
from __future__ import annotations

import hashlib

import numpy as np


class Geometry:
    def __init__(self, discretization, x: np.ndarray, w: np.ndarray,
                 operators: dict, t: np.ndarray | None = None):
        x = np.asarray(x)
        if x.ndim != 3:
            raise ValueError("mesh tensor x must be (V, N, dim)")
        self.discretization = discretization
        self.x = x
        self.w = np.asarray(w).reshape(-1)
        self.operators = operators
        V, N = x.shape[0], x.shape[1]
        if t is None:
            _, labels = dedupe(self.xflat())
            t = labels.reshape(V, N, order="F")
        else:
            t = np.asarray(t, dtype=np.int64)
            if t.shape != (V, N):
                raise ValueError(f"connectivity t must be ({V}, {N})")
        self.t = t

    def xflat(self) -> np.ndarray:
        """Flat (V*N, dim) node coordinates; node (v, e) is row e*V + v."""
        V, N, d = self.x.shape
        return self.x.reshape(V * N, d, order="F")

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0] * self.x.shape[1]

    @property
    def dtype(self):
        return self.x.dtype


def dedupe(x: np.ndarray, tol: float | None = None):
    """Coordinate dedup: (unique_coords, labels), labels[i] = 1-based unique id? No:
    0-based unique id of row i, ids assigned by first occurrence in scan order.

    Same contract as the reference's random-projection dedup
    (``src/TensorFEM.jl:74-110``): rows within ``tol`` Euclidean distance get
    the same id. Deterministic: the projection direction is seeded from the
    array bytes.
    """
    x = np.asarray(x, dtype=np.float64)
    n, d = x.shape
    if n == 0:
        return np.zeros((0, d)), np.zeros((0,), dtype=np.int64)
    if tol is None:
        tol = max(np.abs(x).max(), 1.0) * 100 * np.finfo(np.float64).eps
    seed = int.from_bytes(hashlib.sha256(x.tobytes()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    p = x @ u
    order = np.argsort(p, kind="stable")
    labels = np.full(n, -1, dtype=np.int64)
    count = 0
    ps = p[order]
    for a in range(n):
        ia = order[a]
        if labels[ia] >= 0:
            continue
        labels[ia] = count
        b = a + 1
        while b < n and ps[b] <= ps[a] + tol:
            ib = order[b]
            if labels[ib] < 0 and np.linalg.norm(x[ia] - x[ib]) <= tol:
                labels[ib] = count
            b += 1
        count += 1
    # ids by first occurrence in scan order (stable relabel)
    first = np.full(count, -1, dtype=np.int64)
    remap = np.full(count, -1, dtype=np.int64)
    nxt = 0
    for i in range(n):
        l = labels[i]
        if remap[l] < 0:
            remap[l] = nxt
            first[nxt] = i
            nxt += 1
    labels = remap[labels]
    uniq = x[first[:nxt]]
    return uniq, labels


def unique_coords(labels: np.ndarray, x: np.ndarray) -> np.ndarray:
    """First-occurrence coordinates per label id (0-based)."""
    labels = np.asarray(labels)
    n_u = labels.max() + 1 if labels.size else 0
    out = np.zeros((n_u, x.shape[1]), dtype=x.dtype)
    seen = np.zeros(n_u, dtype=bool)
    for i, l in enumerate(labels):
        if not seen[l]:
            out[l] = x[i]
            seen[l] = True
    return out

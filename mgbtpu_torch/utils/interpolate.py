"""Solution interpolation at arbitrary points.

- 1D tensor FEM: exact per-element degree-k Lagrange interpolation
  (isoparametric element located by bisection; out-of-domain points clamp to
  the boundary values). Reference ``src/TensorFEM.jl:967-1014``.
- 1D spectral: Chebyshev-coefficient interpolation (extrapolates).
- 2D spectral: tensor-product Chebyshev. Reference ``src/spectral1d.jl`` /
  ``spectral2d.jl``.

Host numpy, a copy of ``mgbtpu/utils/interpolate.py``. ``z`` may be a numpy
array or a tensor on any device (it is brought to the host); the results
are numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(z) -> np.ndarray:
    if isinstance(z, torch.Tensor):
        z = z.detach().cpu().numpy()
    return np.asarray(z, dtype=np.float64)


def chebfun_coefficients(values: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    from ..discretize.spectral import chebyshev_values

    V = chebyshev_values(nodes, len(nodes))
    return np.linalg.solve(V, _host(values))


def chebfun(coeffs: np.ndarray, x) -> np.ndarray:
    from ..discretize.spectral import chebyshev_values

    coeffs = _host(coeffs)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    return chebyshev_values(x, len(coeffs)) @ coeffs


def _interp_fem1d(geom, z, t):
    from ..discretize.tensorfem import cheb_lobatto_nodes, lagrange_values

    k = geom.discretization.k
    s = k + 1
    x = geom.x                 # (s, N, 1)
    N = x.shape[1]
    nodes1 = cheb_lobatto_nodes(k)
    lefts = x[0, :, 0]
    x_lo, x_hi = x[0, 0, 0], x[s - 1, N - 1, 0]

    def one(tq):
        if tq <= x_lo:
            return z[0]
        if tq >= x_hi:
            return z[s * N - 1]
        e = int(np.clip(np.searchsorted(lefts, tq, side="right") - 1, 0, N - 1))
        # invert the (possibly isoparametric) 1D map by bisection
        lo, hi = -1.0, 1.0
        Xe = x[:, e, 0]
        flo = Xe[0] - tq
        if flo == 0:
            return z[e * s]
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            fm = float(lagrange_values(nodes1, mid)[0] @ Xe) - tq
            if fm == 0:
                break
            if np.sign(fm) == np.sign(flo):
                lo, flo = mid, fm
            else:
                hi = mid
        xi = 0.5 * (lo + hi)
        L = lagrange_values(nodes1, xi)[0]
        return float(L @ z[e * s:(e + 1) * s])

    t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
    out = np.array([one(tq) for tq in t_arr])
    return out if np.ndim(t) else out[0]


def _interp_spectral1d(geom, z, t):
    nodes = geom.xflat()[:, 0]
    c = chebfun_coefficients(z, nodes)
    out = chebfun(c, t)
    return out if np.ndim(t) else out[0]


def _interp_spectral2d(geom, z, pts):
    from ..discretize.spectral import chebyshev_values

    n = geom.discretization.n
    nodes = geom.xflat()[:n, 0]
    V = chebyshev_values(nodes, n)
    C = np.linalg.solve(V, z.reshape(n, n, order="F"))
    C = np.linalg.solve(V, C.T).T
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    bx = chebyshev_values(pts[:, 0], n)
    by = chebyshev_values(pts[:, 1], n)
    out = np.einsum("qi,ij,qj->q", bx, C, by)
    return out if pts.shape[0] > 1 else float(out[0])


def interpolate(geom, z, t):
    """Evaluate a fine-grid solution vector at points ``t``."""
    from ..discretize.spectral import Spectral1D, Spectral2D
    from ..discretize.tensorfem import TensorFEM

    disc = geom.discretization
    z = _host(z).reshape(-1)
    if isinstance(disc, TensorFEM) and disc.d == 1 and disc.e == 1:
        return _interp_fem1d(geom, z, t)
    if isinstance(disc, Spectral1D):
        return _interp_spectral1d(geom, z, t)
    if isinstance(disc, Spectral2D):
        return _interp_spectral2d(geom, z, t)
    raise TypeError(f"interpolate: unsupported discretization {type(disc)}")

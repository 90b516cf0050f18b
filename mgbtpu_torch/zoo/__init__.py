"""Zoo — library of convex variational test problems.

Port of ``mgbtpu/zoo/__init__.py``. Each constructor takes a MultiGrid and
returns an assembled MGBProblem; solve with ``mgb_solve``. Capability parity
with reference ``src/Zoo/`` (p_harmonic, norton_hoff, rof,
two_sided_obstacle, elastoplastic_torsion, minimal_surface). All index sets
are 0-based positions into the per-node operator-value vector Dz.
``device`` is where the problem is meant to be solved, as for ``assemble``
(default cuda, raises without a card; "cpu" for the plain path).
"""
from __future__ import annotations

import numpy as np

from ..convex import convex_euclidian_power, convex_linear, intersect
from ..solver.mgb import assemble, default_D, default_idx

__all__ = ["p_harmonic", "norton_hoff", "rof", "two_sided_obstacle",
           "elastoplastic_torsion", "minimal_surface"]

_OPS = ("dx", "dy", "dz")


def _dim(mg):
    return mg.geometry.discretization.dim


def _vector_setup(d, f, g_u, s_init):
    """Shared setup for vector-valued problems (p_harmonic, norton_hoff):
    state (u_1..u_d, s); per component an :id row plus d partials; trailing
    s:id row. Reference ``src/Zoo/Zoo.jl:34-96``."""
    state_variables = [(f"u{i+1}", "dirichlet") for i in range(d)] + \
        [("s", "full")]
    D = []
    for i in range(d):
        D.append((f"u{i+1}", "id"))
        for j in range(d):
            D.append((f"u{i+1}", _OPS[j]))
    D.append(("s", "id"))
    nrows = d * (1 + d) + 1

    def f_kw(x):
        fv = np.atleast_1d(np.asarray(f(x), dtype=np.float64))
        out = np.zeros(nrows)
        for i in range(d):
            out[i * (d + 1)] = fv[i]
        out[-1] = 1.0
        return out

    def g_kw(x):
        gv = np.atleast_1d(np.asarray(g_u(x), dtype=np.float64))
        return np.concatenate([gv[:d], [s_init]])

    idx = tuple(i * (d + 1) + 1 + j for i in range(d) for j in range(d)) \
        + (nrows - 1,)
    return state_variables, D, f_kw, g_kw, idx, nrows


def _scalar_fg(nrows, f, g_u, s_init):
    def f_kw(x):
        out = np.zeros(nrows)
        out[0] = f(x)
        out[-1] = 0.5
        return out

    def g_kw(x):
        return np.array([g_u(x), s_init], dtype=np.float64)

    return f_kw, g_kw


def p_harmonic(mg, *, p=1.5, f=None, g_u=None, s_init=100.0, device=None):
    """Vectorial p-Laplacian: min int |grad u|_F^p + f.u, u: Omega -> R^d.

    Reference ``src/Zoo/p_harmonic.jl``.
    """
    d = _dim(mg)
    if f is None:
        f = lambda x: np.full(d, 0.5)
    if g_u is None:
        if d == 1:
            g_u = lambda x: np.array([x[0] ** 2])
        else:
            g_u = lambda x: np.array([float(np.prod(x[:d]))] + [0.0] * (d - 1))
    sv, D, f_kw, g_kw, idx, _ = _vector_setup(d, f, g_u, s_init)
    Q = convex_euclidian_power(mg, idx=idx, p=float(p))
    return assemble(mg, state_variables=sv, D=D, f=f_kw, g=g_kw, Q=Q,
                    device=device)


def norton_hoff(mg, *, p=1.5, f=None, g_u=None, s_init=100.0, device=None):
    """Norton-Hoff power-law elasticity: min int |eps(u)|_F^p + f.u with the
    symmetric gradient eps(u) = (grad u + grad u')/2, packed into the power
    cone via (eps_diag..., sqrt(2)*eps_offdiag..., 0-padding, s).

    Reference ``src/Zoo/norton_hoff.jl``.
    """
    d = _dim(mg)
    if d == 1:
        raise ValueError("norton_hoff: 1D not supported (use p-Poisson / "
                         "elastoplastic_torsion)")
    if f is None:
        f = lambda x: np.full(d, 0.5)
    if g_u is None:
        g_u = lambda x: np.array([float(np.prod(x[:d]))] + [0.0] * (d - 1))
    sv, D, f_kw, g_kw, idx, _ = _vector_setup(d, f, g_u, s_init)
    nz = d * d + 1

    # Within y[idx], partial du_i/dx_j sits at position i*d + j; slack last.
    A = np.zeros((nz, nz))
    row = 0
    for i in range(d):
        A[row, i * d + i] = 1.0
        row += 1
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    for i in range(d):
        for j in range(i + 1, d):
            A[row, i * d + j] = inv_sqrt2
            A[row, j * d + i] = inv_sqrt2
            row += 1
    A[nz - 1, nz - 1] = 1.0
    Q = convex_euclidian_power(mg, idx=idx, A=lambda x: A, p=float(p))
    return assemble(mg, state_variables=sv, D=D, f=f_kw, g=g_kw, Q=Q,
                    device=device)


def rof(mg, *, f_data=None, lam=1.0, g_u=None, s_init=10.0, r_init=10.0,
        device=None):
    """Rudin-Osher-Fatemi TV denoising: min int |grad u| + lam/2 (u-f)^2,
    state (u, s, r) with s >= |grad u| and r >= (u - f)^2.

    Reference ``src/Zoo/rof.jl``.
    """
    d = _dim(mg)
    if f_data is None:
        f_data = lambda x: 0.5 * np.tanh(5.0 * x[0])
    if g_u is None:
        g_u = f_data
    sv = [("u", "dirichlet"), ("s", "full"), ("r", "full")]
    D = [("u", "id")] + [("u", _OPS[j]) for j in range(d)] + \
        [("s", "id"), ("r", "id")]
    nrows = d + 3

    def f_kw(x):
        out = np.zeros(nrows)
        out[nrows - 2] = 1.0
        out[nrows - 1] = lam / 2.0
        return out

    def g_kw(x):
        return np.array([g_u(x), s_init, r_init], dtype=np.float64)

    tv_idx = tuple(range(1, d + 1)) + (nrows - 2,)
    Q_tv = convex_euclidian_power(mg, idx=tv_idx, p=1.0)
    data_idx = (0, nrows - 1)
    Q_data = convex_euclidian_power(
        mg, idx=data_idx, A=lambda x: np.eye(2),
        b=lambda x: np.array([-f_data(x), 0.0]), p=2.0)
    Q = intersect(mg, Q_tv, Q_data)
    return assemble(mg, state_variables=sv, D=D, f=f_kw, g=g_kw, Q=Q,
                    device=device)


def two_sided_obstacle(mg, *, f=None, g_u=None, psi_lower=None,
                       psi_upper=None, s_init=10.0, device=None):
    """Membrane between obstacles: min int |grad u|^2/2 + f u subject to
    psi_lower <= u <= psi_upper. Reference ``src/Zoo/two_sided_obstacle.jl``.
    """
    d = _dim(mg)
    if f is None:
        fval = {1: 1.0, 2: 2.0, 3: 8.0}[d]
        f = lambda x: fval
    if g_u is None:
        g_u = lambda x: 0.0
    if psi_lower is None:
        psi_lower = lambda x: -0.1
    if psi_upper is None:
        psi_upper = lambda x: 1.0
    sv = [("u", "dirichlet"), ("s", "full")]
    D = default_D(d)
    nrows = d + 2
    f_kw, g_kw = _scalar_fg(nrows, f, g_u, s_init)
    Q_slack = convex_euclidian_power(mg, idx=default_idx(d), p=2.0)
    Q_box = convex_linear(
        mg, idx=(0,), A=lambda x: np.array([[1.0], [-1.0]]),
        b=lambda x: np.array([-psi_lower(x), psi_upper(x)]))
    Q = intersect(mg, Q_slack, Q_box)
    return assemble(mg, state_variables=sv, D=D, f=f_kw, g=g_kw, Q=Q,
                    device=device)


def elastoplastic_torsion(mg, *, f=None, g_u=None, smax=1.0, s_init=None,
                          device=None):
    """Hencky elasto-plastic torsion: min int |grad u|^2/2 + f u subject to
    |grad u| <= smax. Reference ``src/Zoo/elastoplastic_torsion.jl``.
    """
    d = _dim(mg)
    if f is None:
        fval = {1: 2.0, 2: 4.0, 3: 16.0}[d]
        f = lambda x: fval
    if g_u is None:
        g_u = lambda x: 0.0
    smax2 = float(smax) ** 2
    if s_init is None:
        s_init = smax2 / 2
    sv = [("u", "dirichlet"), ("s", "full")]
    D = default_D(d)
    nrows = d + 2
    f_kw, g_kw = _scalar_fg(nrows, f, g_u, s_init)
    Q_slack = convex_euclidian_power(mg, idx=default_idx(d), p=2.0)
    Q_yield = convex_linear(mg, idx=(nrows - 1,),
                            A=lambda x: np.array([[-1.0]]),
                            b=lambda x: np.array([smax2]))
    Q = intersect(mg, Q_slack, Q_yield)
    return assemble(mg, state_variables=sv, D=D, f=f_kw, g=g_kw, Q=Q,
                    device=device)


def minimal_surface(mg, *, g_u=None, s_init=10.0, device=None):
    """Plateau problem in graph form: min int sqrt(1 + |grad u|^2) via the
    shifted Lorentz cone s^2 >= |grad u|^2 + 1, with the constant 1 packed
    through the affine b. Reference ``src/Zoo/minimal_surface.jl``.
    """
    d = _dim(mg)
    if g_u is None:
        if d == 1:
            g_u = lambda x: 0.5 * x[0] ** 2
        elif d == 2:
            g_u = lambda x: 0.5 * (x[0] ** 2 - x[1] ** 2)
        else:
            g_u = lambda x: 0.5 * float(np.sum(np.asarray(x[:d]) ** 2))
    sv = [("u", "dirichlet"), ("s", "full")]
    D = default_D(d)
    nrows = d + 2
    nz = nrows

    def f_kw(x):
        out = np.zeros(nrows)
        out[-1] = 1.0
        return out

    def g_kw(x):
        return np.array([g_u(x), s_init], dtype=np.float64)

    A = np.zeros((nz, nz))
    for i in range(d):
        A[i, i + 1] = 1.0       # z_i = du/dx_i
    A[nz - 1, nz - 1] = 1.0     # z_last = s
    b = np.zeros(nz)
    b[d] = 1.0                  # the shifted-cone constant
    Q = convex_euclidian_power(mg, idx=tuple(range(nz)),
                               A=lambda x: A, b=lambda x: b, p=1.0)
    return assemble(mg, state_variables=sv, D=D, f=f_kw, g=g_kw, Q=Q,
                    device=device)

"""Time-dependent p-Laplace flow by implicit Euler over the barrier solver.

Port of ``mgbtpu/solver/parabolic.py`` (reference ``src/Parabolic.jl``).
Each step is a full barrier solve warm-started through the linear term: the
state is (u, s1, s2) with cones s1 >= u^2 and s2 >= ||grad u||^p, and the
step-k linear functional is (h*f1 - u_prev, 1/2, h/p) on the id rows. Each
step starts from g with s1 = s2 = 0, on the cones' walls, so each runs
phase I. The AMG pair is built once and reused across steps, and so are
the per-level panel operators and nested-dissection plans (the Convex is
constructed once, so every step hits the same solver cache).
"""
from __future__ import annotations

import numpy as np

from .._config import resolve_device
from ..convex import convex_euclidian_power, intersect
from ..hierarchy.multigrid import prepare_amg
from ..utils.maps import sample_rows
from .mgb import assemble, mgb_solve


def default_D_parabolic(dim):
    ops = ["dx", "dy", "dz"][:dim]
    return ([("u", "id")] + [("u", o) for o in ops]
            + [("s1", "id"), ("s2", "id")])


def parabolic_idx1(dim):
    # (u, s1): u:id row 0, s1:id row dim+1
    return (0, dim + 1)


def parabolic_idx2(dim):
    # (grad u..., s2): partial rows 1..dim, s2:id row dim+2
    return tuple(range(1, dim + 1)) + (dim + 2,)


def default_g_parabolic(dim):
    if dim == 1:
        return lambda t, x: np.array([x[0], 0.0, 0.0])
    return lambda t, x: np.array(
        [float(np.sum(np.asarray(x[:dim]) ** 2)), 0.0, 0.0])


class ParabolicSOL:
    """Solution: geometry, time stamps ts, and per-step state matrices u."""

    def __init__(self, geometry, ts, u):
        self.geometry = geometry
        self.ts = np.asarray(ts)
        self.u = u


def parabolic_solve(mg, *, state_variables=None, dim=None, f1=None, p=1.0,
                    h=0.2, t0=0.0, t1=1.0, ts=None, g=None, D=None, Q=None,
                    verbose=False, device=None,
                    **solver_kwargs) -> ParabolicSOL:
    """Implicit-Euler p-Laplace flow from g(t0, x) over the time stamps
    ``ts`` (default t0, t0 + h, ..., t1); ``device`` as ``mgb_solve``
    (default cuda, raises without a card; "cpu" for the plain path). Other
    keyword arguments go to every step's ``mgb_solve``."""
    device = resolve_device(device)
    geom = mg.geometry
    if dim is None:
        dim = geom.discretization.dim
    sp_slack = geom.discretization.default_slack_space()
    if state_variables is None:
        state_variables = [("u", "dirichlet"), ("s1", sp_slack),
                           ("s2", sp_slack)]
    if D is None:
        D = default_D_parabolic(dim)
    if f1 is None:
        f1 = lambda t, x: 0.5   # noqa: E731
    if g is None:
        g = default_g_parabolic(dim)
    if ts is None:
        ts = np.arange(t0, t1 + h / 2, h)
    ts = np.asarray(ts, dtype=np.float64)
    if Q is None:
        Q = intersect(mg,
                      convex_euclidian_power(mg, idx=parabolic_idx1(dim),
                                             p=2.0),
                      convex_euclidian_power(mg, idx=parabolic_idx2(dim),
                                             p=float(p)))
    x = geom.xflat()
    n_steps = len(ts)
    nD = len(D)

    U = [sample_rows(lambda xi, tv=ts[j]: g(tv, xi), x, np.float64)
         for j in range(n_steps)]
    f1_grid = np.stack([sample_rows(lambda xi, tv=ts[j]: f1(tv, xi),
                                    x, np.float64)[:, 0]
                        for j in range(n_steps)], axis=1)     # (n, n_steps)
    M = prepare_amg(mg, state_variables=state_variables, D=D)

    def step_f_grid(z_prev, j):
        hj = ts[j] - ts[j - 1]
        out = np.zeros((x.shape[0], nD))
        out[:, 0] = hj * f1_grid[:, j] - z_prev[:, 0]
        out[:, nD - 2] = 0.5
        out[:, nD - 1] = hj / float(p)
        return out

    for j in range(1, n_steps):
        if verbose:  # pragma: no cover - cosmetic
            print(f"parabolic_solve: step {j}/{n_steps - 1}")
        prob = assemble(mg, M=M, state_variables=state_variables, D=D,
                        g_grid=U[j], f_grid=step_f_grid(U[j - 1], j), Q=Q,
                        device=device)
        sol = mgb_solve(prob, device=device, **solver_kwargs)
        U[j] = np.asarray(sol.z)
    return ParabolicSOL(geom, ts, U)

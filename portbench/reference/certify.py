"""Judge a solution of the p = 1 barrier problem by its optimality conditions.

The program solves, for the rows y = Dz = (u, grad u, s) at every node and
t = 1/tol at the end of its ramp,

    min_z  sum_i [ t w_i <c_i, y_i> - bw_i log(s_i^2 - |grad u_i|^2) ]

over z = (u, s) with u continuous and equal to g on the boundary, s free at
every node, bw_i = 1/m. Its answer is the unique minimizer, the central point
at t. Without solving, the reference reads the answer's conditions at every
node and every free value of u:

- ``s_gap``: the slack's own condition fixes s from grad u in closed form,
  s* = a + sqrt(a^2 + |grad u|^2) with a = bw / (t w c_s). The number is the
  largest |s - s*| in units of the barrier's gap s* - |grad u|, the scale at
  which the slack means anything.
- ``u_res``: with s = s*, the derivative in each free value of u is
  sum_elements D'(w (c_grad + c_s grad u / s*)) + w c_u; the number is its
  largest size against the sum of the sizes of its terms.
- ``bc``: the largest |u - g| on the boundary, which the method keeps
  exactly.

A non-finite answer reads inf in every number.
"""
from __future__ import annotations

import numpy as np

from . import Discretization


def readings(disc: Discretization, c: np.ndarray, g: np.ndarray,
             z: np.ndarray, t: float) -> dict:
    """The three numbers for answer z (m, 2) to costs c (m, 2 + dim) and
    start/boundary data g (m, 2) at barrier parameter t."""
    m, d = disc.n_nodes, disc.dim
    z = np.asarray(z, dtype=np.float64)
    if z.shape != (m, 2) or not np.isfinite(z).all():
        return {"s_gap": np.inf, "u_res": np.inf, "bc": np.inf}
    u, s = z[:, 0], z[:, 1]
    w = disc.w
    bw = 1.0 / m
    c_u, c_grad, c_s = c[:, 0], c[:, 1:1 + d], c[:, 1 + d]
    if not (c_s > 0).all():
        raise ValueError("certify: the slack's cost must be positive")

    ue = u[disc.elem]                                          # (N, n)
    q = np.stack([(disc.deriv[a] @ ue[..., None])[..., 0]
                  for a in range(d)], -1).reshape(m, d)
    qn = np.sqrt((q * q).sum(axis=1))
    a = bw / (t * w * c_s)
    root = np.sqrt(a * a + qn * qn)
    s_star = a + root
    gap = a + a * a / (root + qn)
    s_gap = float(np.max(np.abs(s - s_star) / gap))

    flux = (w[:, None] * (c_grad + c_s[:, None] * q / s_star[:, None]))
    fe = flux.reshape(*disc.elem.shape, d)                     # (N, n, d)
    r = (w * c_u).reshape(disc.elem.shape).copy()
    size = np.abs(r)
    for k in range(d):
        Dt = disc.deriv[k].transpose(0, 2, 1)
        r += (Dt @ fe[..., k, None])[..., 0]
        size += (np.abs(Dt) @ np.abs(fe[..., k, None]))[..., 0]
    n_dof = len(disc.boundary)
    r_dof = np.bincount(disc.dof, r.reshape(-1), n_dof)
    size_dof = np.bincount(disc.dof, size.reshape(-1), n_dof)
    free = ~disc.boundary
    u_res = float(np.max(np.abs(r_dof[free]) / size_dof[free]))

    on_bdry = disc.boundary[disc.dof]
    bc = float(np.max(np.abs(u[on_bdry] - g[on_bdry, 0])))
    return {"s_gap": s_gap, "u_res": u_res, "bc": bc}

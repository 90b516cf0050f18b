"""Carry data from the JAX package into the port, as plain arrays.

``from_reference_arrays`` turns numpy arrays taken from an ``mgbtpu``
problem into the port's objects, so that a test can run both packages on
identical data. It never imports ``mgbtpu``: the caller passes the arrays.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ._config import resolve_device


def from_reference_arrays(*, device=None, D_fine=None, R_fine=None, w=None,
                          f_grid=None, g_grid=None, convex=None,
                          panel_ops=None) -> dict:
    """Build the port's counterparts of the given reference arrays.

    ``D_fine``: list of ``(blocks (N, p, q), component)`` fine operators ->
    list of ``(BlockDiagHost, component)``.
    ``R_fine``: list of sparse prolongations -> list of float64 CSR.
    ``w``, ``f_grid``, ``g_grid``: arrays -> float64 numpy.
    ``convex``: dict with the power-cone grids ``A``, ``b``, ``p``, ``mu``
    and ``idx`` -> ``Convex`` (``mu`` is checked against the one the port
    derives from ``p``).
    ``panel_ops``: dict with ``cols`` (N, C), ``panels`` (nD, N, p, C) and
    ``n_J`` -> ``PanelOps`` on ``device``: the card unless the caller
    passes ``device="cpu"`` (raises without a card, as every entry point).

    Returns a dict holding an entry for each argument given.
    """
    from .convex.euclidian_power import convex_euclidian_power
    from .ops.blockdiag import BlockDiagHost
    from .solver.levelops import PanelOps, inverse_incidence

    out = {}
    if D_fine is not None:
        out["D_fine"] = [(BlockDiagHost(np.asarray(data, np.float64)),
                          int(comp)) for data, comp in D_fine]
    if R_fine is not None:
        out["R_fine"] = [sp.csr_matrix(R, dtype=np.float64) for R in R_fine]
    for name, a in (("w", w), ("f_grid", f_grid), ("g_grid", g_grid)):
        if a is not None:
            out[name] = np.asarray(a, np.float64)
    if convex is not None:
        p = np.asarray(convex["p"], np.float64)
        Q = convex_euclidian_power(
            A_grid=convex["A"], b_grid=convex["b"], p_grid=p,
            idx=convex["idx"], x=np.zeros((len(p), 1)))
        if not np.array_equal(Q.args[3], np.asarray(convex["mu"], np.float64)):
            raise ValueError("convex: mu grid differs from the one implied "
                             "by p")
        out["convex"] = Q
    if panel_ops is not None:
        dev = resolve_device(device)
        cols = np.array(panel_ops["cols"], np.int64)
        panels = np.array(panel_ops["panels"], np.float64)
        nD, N, p, C = panels.shape
        out["panel_ops"] = PanelOps(
            cols=torch.as_tensor(cols, device=dev),
            panels=torch.as_tensor(panels, device=dev),
            n_nodes=N * p, nD=nD, n_J=int(panel_ops["n_J"]), p=p, N=N, C=C,
            inv=torch.as_tensor(inverse_incidence(cols, int(panel_ops["n_J"])),
                                device=dev),
            host_cols=cols)
    return out

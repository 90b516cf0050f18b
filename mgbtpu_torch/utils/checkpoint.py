"""Solution serialization and warm-start helpers.

The reference has no checkpoint/resume (solves are seconds-to-minutes) but
exposes warm-start affordances: the ``g`` grid is the initial iterate and
Dirichlet lift, and ``_matched_t`` picks the barrier parameter a warm start
best approximates (``src/mgb.jl:289-330``). Here: the port's ``MGBSOL``
round-trips through npz (tensors go to host numpy), and ``warm_start_grid``
feeds a previous solution back into ``assemble(g_grid=...)``. A copy of
``mgbtpu/utils/checkpoint.py``.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def save_solution(path, sol) -> None:
    """Serialize an MGBSOL (solution matrix, diagnostics, log) to .npz."""
    main = sol.SOL_main or {}
    feas = sol.SOL_feasibility or {}
    np.savez(
        path,
        z=_host(sol.z),
        log=np.frombuffer(sol.log.encode(), dtype=np.uint8),
        main_its=_host(main.get("its", np.zeros((0, 0)))),
        main_ts=_host(main.get("ts", np.zeros(0))),
        main_kappas=_host(main.get("kappas", np.zeros(0))),
        main_c_dot_Dz=_host(main.get("c_dot_Dz", np.zeros(0))),
        feas_ts=_host(feas.get("ts", np.zeros(0))) if feas else np.zeros(0),
    )


def load_solution(path):
    """Load a saved solution: namespace with z, log, diagnostics."""
    d = np.load(path)
    feas_ts = d["feas_ts"] if "feas_ts" in d else np.zeros(0)
    return SimpleNamespace(
        z=d["z"],
        log=bytes(d["log"]).decode(),
        SOL_main=dict(its=d["main_its"], ts=d["main_ts"],
                      kappas=d["main_kappas"], c_dot_Dz=d["main_c_dot_Dz"]),
        SOL_feasibility=dict(ts=feas_ts) if feas_ts.size else None,
    )


def warm_start_grid(sol):
    """The g_grid that warm-starts a new solve from a previous solution
    (the solver's initial iterate is the g grid)."""
    return _host(sol.z).copy()

"""The hand-written CUDA kernels of the port (CUDA C++ for sm_90a).

=====  ===================  ==============================================
K1     ``panel_fwd``        Dz = Dz0 + G s (replaces ``fwd_dd``)
K2     ``power_cone_eval``  per-node lone power-cone barrier (``node_eval``)
K3     ``panel_adj``        G'y scattered into n_J (``adj_contrib``)
K4     ``gram_matvec``      P' L L' P v, fused (``ymv_contrib``)
K5a    ``front_factor``     ND front partial Cholesky (``panel_chol_inv``)
K5b    ``front_forward``,   ND front triangular solves, one tree level
       ``front_backward``   of a sweep each (``panel_chol_inv``)
K6     ``node_barrier``     per-node barrier of any piece table: linear,
                            piecewise/intersect, cobarrier + phase-I box
                            (``node_eval``)
=====  ===================  ==============================================

On a mesh, K3's two phases run apart (``panel_adj_contrib`` per shard,
``adjoint_sum`` once on the first device), as does K4's per-slot phase
(``gram_matvec_contrib``), each call counted as a launch of its kernel.

Each wrapper runs its plain PyTorch version when its inputs lie on the CPU
and launches its kernel when they lie on a CUDA device; it never falls back.
Each counts its launches in the integer attribute ``launches`` (K5b's two
sweeps share ``front_solve.launches``; K5a and K5b also count those in
their large forms in ``large_launches``; K2 also counts them by mode in
``mode_launches``; K6 also counts those in the cobarrier form in
``co_launches``, by mode in ``mode_launches`` and those of a table with a
wide piece, a runtime-width cone or a wide linear block, in
``wide_launches``, and those of a table past its parameter kernels'
limits in ``table_launches``).
"""
from . import _build, node_barrier as _node_barrier
from ._build import build_all
from .front_factor import cholesky_nan, front_factor, front_factor_plain
from .front_solve import (front_backward, front_backward_plain,
                          front_forward, front_forward_plain, front_solve)
from .gram_matvec import (gram_matvec, gram_matvec_contrib,
                          gram_matvec_plain)
from .node_barrier import Piece, node_barrier, node_barrier_plain
from .panel_adj import (adjoint_sum, panel_adj, panel_adj_contrib,
                        panel_adj_plain)
from .panel_fwd import panel_fwd, panel_fwd_plain
from .power_cone import power_cone_eval, power_cone_plain

WRAPPERS = {"panel_fwd": panel_fwd, "power_cone": power_cone_eval,
            "panel_adj": panel_adj, "gram_matvec": gram_matvec,
            "front_factor": front_factor, "front_solve": front_solve,
            "node_barrier": node_barrier}


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
    front_factor.large_launches = 0
    front_solve.large_launches = 0
    node_barrier.co_launches = 0
    node_barrier.wide_launches = 0
    node_barrier.table_launches = 0
    node_barrier.mode_launches = [0, 0, 0]
    power_cone_eval.mode_launches = [0, 0, 0]


def clear_caches():
    """Forget the loaded kernel entries (ctypes functions of the built
    libraries); the next launch loads them again (``mgb_cleanup()``)."""
    _build._LIBS.clear()
    _node_barrier._LAUNCH.clear()


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["WRAPPERS", "Piece", "adjoint_sum", "build_all", "cholesky_nan",
           "clear_caches",
           "front_backward", "front_backward_plain", "front_factor",
           "front_factor_plain", "front_forward", "front_forward_plain",
           "front_solve",
           "gram_matvec", "gram_matvec_contrib", "gram_matvec_plain",
           "launches", "node_barrier", "node_barrier_plain", "panel_adj",
           "panel_adj_contrib", "panel_adj_plain", "panel_fwd",
           "panel_fwd_plain", "power_cone_eval", "power_cone_plain",
           "reset_launches"]

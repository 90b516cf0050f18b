"""mgbtpu_torch — the PyTorch/CUDA port of mgbtpu (multigrid barrier).

A second package beside the JAX one, in float64 throughout, with the same
layout and names: ``subdivide(fem2d_P2(), L)`` -> ``amg`` -> ``assemble`` ->
``mgb_solve``. The level operators and the per-node barrier run through
hand-written CUDA kernels (``kernels/``) on the card, which is the default
device; ``device="cpu"`` runs the plain PyTorch versions instead. Imports
neither JAX nor ``mgbtpu``.
"""
from .convex import Convex, convex_euclidian_power, convex_Euclidian_power
from .discretize import Geometry, fem2d_P2
from .hierarchy import (MultiGrid, amg, amg_ruge_stuben, find_boundary,
                        prepare_amg, subdivide)
from .solver import (MGBProblem, MGBSOL, assemble, default_D, default_f,
                     default_g, default_idx, linesearch_backtracking,
                     linesearch_illinois, mgb_solve, stopping_exact,
                     stopping_inexact)
from .utils import Log, MGBConvergenceFailure

__all__ = [
    "Convex", "convex_euclidian_power", "convex_Euclidian_power",
    "Geometry", "fem2d_P2", "MultiGrid", "amg", "amg_ruge_stuben",
    "find_boundary", "prepare_amg", "subdivide", "MGBProblem", "MGBSOL",
    "assemble", "default_D", "default_f", "default_g", "default_idx",
    "linesearch_backtracking", "linesearch_illinois", "mgb_solve",
    "stopping_exact", "stopping_inexact", "Log", "MGBConvergenceFailure",
]

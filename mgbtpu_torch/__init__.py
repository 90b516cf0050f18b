"""mgbtpu_torch — the PyTorch/CUDA port of mgbtpu (multigrid barrier).

A second package beside the JAX one, in float64 throughout, with the same
layout and names: ``subdivide(geometry, L)`` -> ``amg`` -> ``assemble`` ->
``mgb_solve`` on the tensor-product Q_k elements (``fem1d``, ``fem2d``,
``fem3d``), the P1/P2 triangles (``fem2d_P1``, ``fem2d_P2``) and the
Chebyshev spectral elements (``spectral1d``, ``spectral2d``), plus
``parabolic_solve`` and the ``zoo`` problems over the power cone, linear,
piecewise and intersected convex sets, the ``Model`` DSL, ``gmsh_import``
and the plots (``plot``, ``plot3d_html``; matplotlib is imported only when
a matplotlib plot is drawn), and ``make_mesh`` for a solve sharded over
several devices (``mgb_solve(prob, mesh=make_mesh())``). The level
operators and the per-node barriers run through hand-written CUDA kernels
(``kernels/``) on the card, which is the default device; ``device="cpu"``
runs the plain PyTorch versions instead. Imports neither JAX nor
``mgbtpu``.
"""
from .convex import (Convex, convex_euclidian_power, convex_Euclidian_power,
                     convex_linear, convex_piecewise, intersect)
from .discretize import (Geometry, fem1d, fem2d, fem2d_P1, fem2d_P2, fem3d,
                         spectral1d, spectral2d, tensor_dofmap)
from .hierarchy import (MultiGrid, amg, amg_ruge_stuben,
                        amg_smoothed_aggregation, find_boundary,
                        geometric_mg, prepare_amg, subdivide)
from .solver import (MGBProblem, MGBSOL, assemble, default_D, default_f,
                     default_g, default_idx, linesearch_backtracking,
                     linesearch_illinois, mgb_cleanup, mgb_solve,
                     stopping_exact, stopping_inexact)
from .solver.parabolic import ParabolicSOL, parabolic_solve
from .utils import Log, MGBConvergenceFailure, chebfun, interpolate, map_rows
from .utils.checkpoint import load_solution, save_solution, warm_start_grid
from .frontends import gmsh_import
from .frontends.model import Model
from .parallel import make_mesh
from . import zoo
# the function shadows the subpackage on purpose, as in the JAX package:
# plot(sol) is the API; the modules stay importable as
# ``from mgbtpu_torch.plot.plotting import ...``
from .plot.html3d import plot3d_html
from .plot.plotting import animation_html, plot, save_animation

__all__ = [
    "Convex", "convex_euclidian_power", "convex_Euclidian_power",
    "convex_linear", "convex_piecewise", "intersect", "Geometry",
    "fem1d", "fem2d", "fem3d", "fem2d_P1", "fem2d_P2", "spectral1d",
    "spectral2d", "tensor_dofmap", "MultiGrid", "amg", "amg_ruge_stuben",
    "amg_smoothed_aggregation", "find_boundary", "geometric_mg",
    "prepare_amg", "subdivide", "MGBProblem", "MGBSOL", "assemble",
    "default_D", "default_f", "default_g", "default_idx",
    "linesearch_backtracking", "linesearch_illinois", "mgb_cleanup",
    "mgb_solve", "stopping_exact", "stopping_inexact", "parabolic_solve",
    "ParabolicSOL", "Log", "MGBConvergenceFailure", "chebfun",
    "interpolate", "map_rows", "save_solution", "load_solution", "warm_start_grid",
    "zoo", "gmsh_import", "Model", "animation_html", "plot", "plot3d_html",
    "save_animation", "make_mesh",
]

from .mgb import (MGBProblem, MGBSOL, assemble, mgb_cleanup, mgb_solve,
                  default_D, default_f, default_g, default_idx)
from .newton import (linesearch_backtracking, linesearch_illinois,
                     stopping_exact, stopping_inexact)

__all__ = [
    "MGBProblem", "MGBSOL", "assemble", "mgb_cleanup", "mgb_solve",
    "default_D", "default_f", "default_g", "default_idx",
    "linesearch_backtracking", "linesearch_illinois",
    "stopping_exact", "stopping_inexact",
]

"""Typed convergence failure with machine-readable codes.

Mirrors reference ``src/utils.jl:157-184``: front ends dispatch on ``code``.
Codes: "infeasible", "feasibility_Rmax", "stall", "iteration_limit",
"failure".
"""
from __future__ import annotations


class MGBConvergenceFailure(Exception):
    def __init__(self, message: str, code: str = "failure"):
        super().__init__(message)
        self.message = message
        self.code = code

    def __str__(self):  # pragma: no cover - trivial
        return f"MGBConvergenceFailure[{self.code}]: {self.message}"

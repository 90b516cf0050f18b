"""Barrier log, safe power, and the solve logger (torch tensors).

The "convex programmer's log" returns -inf outside the domain instead of
raising, so an infeasible trial point makes the barrier value +/-inf
(rejected by finite-ness checks in the line search) rather than aborting
(reference ``src/utils.jl:4-14``; ``mgbtpu/utils/log.py``).
"""
from __future__ import annotations

import math

import torch


def barrier_floor(dtype=torch.float64) -> float:
    """Smallest admissible barrier argument: sqrt(tiny) of the dtype, so
    that the Hessian terms 1/x^2 stay representable (mgbtpu's
    ``_barrier_floor``)."""
    return math.sqrt(torch.finfo(dtype).tiny)


def Log(x):
    """log(x) for x > sqrt(tiny), else -inf (never raises)."""
    floor = barrier_floor(x.dtype)
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > floor, torch.log(safe),
                       torch.full_like(x, -math.inf))


def safe_pow(s, alpha):
    """s**alpha computed as exp(alpha*Log(s)): 0 for s <= 0 and alpha > 0,
    so enclosing barrier terms go +/-inf and the trial point is rejected
    (reference ``src/convex_linear.jl:379-391``)."""
    return torch.exp(alpha * Log(s))


class Logger:
    """In-memory per-solve log (reference ``printlog``/``@mgblog``): each
    line is prefixed with the emitting routine, lines accumulate into
    ``MGBSOL.log``, and nothing is printed unless a stream is supplied."""

    def __init__(self, stream=None):
        self.lines: list[str] = []
        self._owned = None
        if isinstance(stream, (str, bytes)):
            stream = self._owned = open(stream, "a", buffering=1)
        self.stream = stream

    def __call__(self, tag: str, *args):
        msg = tag + ":" + "".join(str(a) for a in args)
        self.lines.append(msg)
        if self.stream is not None:
            print(msg, file=self.stream)

    def close(self):
        if self._owned is not None:
            self._owned.close()
            self._owned = None

    def text(self) -> str:
        return "\n".join(self.lines) + ("\n" if self.lines else "")

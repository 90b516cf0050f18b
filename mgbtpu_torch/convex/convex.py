"""The Convex container: per-node barrier families + parameter grids.

Port of ``mgbtpu/convex/convex.py``. A barrier family is a batched function
over the node axis, ``barrier(mode, args, Dz, bw, wc)``, that returns the
level's per-node terms directly (mode 0 objective terms, mode 1 gradient
rows, mode 2 Hessian blocks; see ``kernels/power_cone.py``): the JAX
package's ``vmap(F)`` plus the masking of ``solver/barrier.py`` in one call.
``args`` hold the per-node grids as host numpy arrays; the solver moves them
to its device once.

Index semantics are 0-based. ``idx=None`` means "all rows".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple


@dataclass
class Convex:
    args: Tuple[Any, ...]     # per-node grids, each (n,) or (n, k), numpy
    barrier: Callable         # barrier(mode, args, Dz, bw, wc)
    cobarrier: Tuple[Callable, Callable, Callable]  # slack-augmented (phase I)
    slack: Callable           # slack(args, Dz) -> (n,) initial-slack estimate
    input_spec: Tuple         # D-row count validation


def input_spec_from_idx(idx, n: int):
    """Construction-time D-row validation spec (reference
    ``src/convex.jl:71-78``): ``idx=None`` demands exactly ``n`` D rows; an
    explicit index set demands at least ``max(idx)+1`` rows (0-based)."""
    if idx is None:
        return ("exact", n)
    idx = tuple(int(i) for i in idx)
    if len(idx) == 0:
        raise ValueError("idx must contain at least one input row")
    if any(i < 0 for i in idx):
        raise ValueError(f"idx entries must be >= 0; got {idx}")
    return ("atleast", max(idx) + 1)


def validate_convex_inputs(Q: Convex, nD: int) -> None:
    """Check Q's expected input-row layout against the problem's D table
    (reference ``src/convex.jl:54-68``)."""
    kind, n = Q.input_spec
    if kind == "exact" and n != nD:
        raise ValueError(
            f"convex constraint with idx=None expects exactly {n} "
            f"D row(s), but D has {nD} row(s)")
    if kind == "atleast" and n > nD:
        raise ValueError(
            f"convex constraint indexes input row {n - 1} (0-based), "
            f"but D has only {nD} row(s)")

"""The Convex container: a static piece table + per-node parameter grids.

Port of ``mgbtpu/convex/convex.py``. A ``Convex`` describes its barrier by
its pieces (``kernels.node_barrier.Piece``: kind, input rows, widths, the
power cone's alpha specialisation, and where its grids sit in ``args``) and
an optional select grid ``args[0]`` (``convex_piecewise``/``intersect``).
``barrier(mode, args, Dz, bw, wc)`` returns the level's per-node terms
directly (mode 0 objective terms, mode 1 gradient rows, mode 2 Hessian
blocks): the JAX package's ``vmap(F)`` plus the masking of
``solver/barrier.py`` in one kernel call, K2 for a lone power cone of the
shapes it takes (nz <= 5, <= 12 rows) and K6 for any other table, on
every device; ``cobarrier`` is the slack-augmented (phase-I) form,
always K6. ``args`` hold the per-node grids as host numpy arrays; the solver
moves them to its device once.

Index semantics are 0-based. ``idx=None`` means "all rows".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

from ..kernels import power_cone as K2
from ..kernels.node_barrier import POWER, Piece, node_barrier


@dataclass
class Convex:
    args: Tuple[Any, ...]     # per-node grids, each (n,) or (n, k), numpy
    pieces: Tuple[Piece, ...]  # the static piece table
    slack: Callable           # slack(args, Dz) -> (n,) initial-slack estimate
    input_spec: Tuple         # D-row count validation
    select: bool = False      # args[0] is the (n, pieces) select grid

    def _sel(self, args):
        return args[0] if self.select else None

    def barrier(self, mode, args, Dz, bw, wc):
        """Per-node barrier terms of ``mode`` at the rows Dz (see
        ``kernels/node_barrier.py``)."""
        pc = self.pieces[0]
        if not self.select and len(self.pieces) == 1 and pc.kind == POWER \
                and K2.takes(pc.width, Dz.shape[1]):
            return K2.power_cone_eval(mode, Dz, *pc.grids(args), bw, wc,
                                      pc.idx, pc.spec)
        return node_barrier(mode, Dz, self.pieces, args, self._sel(args), bw,
                            wc)

    def cobarrier(self, mode, args, yhat, bw, wc, NC=None, box=None):
        """The slack-augmented barrier: yhat[:, NC-1] is the slack (NC
        defaults to all of yhat's rows); with ``box=(b, R)`` the phase-I
        box terms over the rows NC.. are added."""
        return node_barrier(mode, yhat, self.pieces, args, self._sel(args),
                            bw, wc, co=yhat.shape[1] if NC is None else NC,
                            box=box)


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

    def _check(spec):
        kind = spec[0]
        if kind == "exact" and spec[1] != nD:
            raise ValueError(
                f"convex constraint with idx=None expects exactly {spec[1]} "
                f"D row(s), but D has {nD} row(s)")
        if kind == "atleast" and spec[1] > nD:
            raise ValueError(
                f"convex constraint indexes input row {spec[1] - 1} "
                f"(0-based), but D has only {nD} row(s)")
        if kind == "all":
            for s in spec[1]:
                _check(s)
        # ("any",) -> unchecked

    _check(Q.input_spec)


def intersect(mg, *Qs: Convex) -> Convex:
    """Intersection of convex domains: all pieces active at every node
    (reference ``src/convex.jl:110-122``)."""
    from .piecewise import convex_piecewise

    if len(Qs) == 0:
        raise ValueError("intersect needs at least one Convex")
    return convex_piecewise(Qs, mg=mg, select=lambda x: (True,) * len(Qs))

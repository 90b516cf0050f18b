"""Shared helpers for the convex-set constructors (host-side sampling)."""
from __future__ import annotations

import numpy as np


def resolve_x(mg):
    """Flat (n_nodes, dim) node coordinates from a MultiGrid/Geometry/array."""
    if mg is None:
        raise ValueError("a mesh (mg=) or explicit grids are required")
    g = mg.geometry if hasattr(mg, "geometry") else mg
    if hasattr(g, "xflat"):
        return np.asarray(g.xflat())
    return np.asarray(mg)


def sample_grid(fn, x, dtype, width=None):
    """Sample closure ``fn(x_row)`` over nodes into an (n, width) grid."""
    from ..utils.maps import sample_rows

    return sample_rows(fn, x, dtype, width=width)

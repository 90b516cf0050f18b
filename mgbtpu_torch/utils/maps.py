"""Row-wise sampling of user closures at mesh nodes (host, setup time)."""
from __future__ import annotations

import numpy as np


def sample_rows(fn, x, dtype, width=None):
    """Sample a user closure at mesh nodes into an (n, width) grid.

    ``fn(x_row) -> scalar or vector``. Row loop on host (setup time only,
    mirrors the reference's grid lowering in ``assemble``,
    ``src/mgb.jl:720-721``).
    """
    x = np.asarray(x)
    n = x.shape[0]
    out0 = np.atleast_1d(np.asarray(fn(x[0]), dtype=dtype))
    k = out0.shape[0] if width is None else width
    out = np.empty((n, k), dtype=dtype)
    out[0] = out0
    for i in range(1, n):
        out[i] = np.atleast_1d(np.asarray(fn(x[i]), dtype=dtype))
    return out

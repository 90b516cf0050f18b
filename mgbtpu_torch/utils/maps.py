"""Row-wise maps and sampling of user closures at mesh nodes (host,
setup time).

``map_rows(f, *arrays)`` applies ``f`` to each row: every (n, k) array
contributes a length-k row vector, every (n,) array a scalar. Results are
collected back into an (n, k_out) array (vector-valued f) or an (n,) array
(scalar-valued f): the host analogue of the reference's ``map_rows``
(``src/utils.jl:112-130``).
"""
from __future__ import annotations

import numpy as np


def map_rows(f, *arrays):
    arrays = [np.asarray(a) for a in arrays]
    n = arrays[0].shape[0]
    rows0 = [a[0] for a in arrays]
    out0 = np.asarray(f(*rows0), dtype=arrays[0].dtype)
    if out0.ndim == 0:
        out = np.empty((n,), dtype=out0.dtype)
    else:
        out = np.empty((n, out0.shape[0]), dtype=out0.dtype)
    out[0] = out0
    for i in range(1, n):
        rows = [a[i] for a in arrays]
        out[i] = np.asarray(f(*rows))
    return out


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

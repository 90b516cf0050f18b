"""Peaks of the card and the least work of the ND factorization and solve.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM3, 67 TFLOP/s of float64 on the tensor cores (DMMA; 34
outside them). A bound is the larger of bytes over the bandwidth and
operations over the float64 peak. The counts follow from the shapes of the
plan alone (fronts per tree level nk, assigned width a, boundary width b), so
any implementation of the same operation is held to the same count; they are
frozen copies of ``chip_smoke.factor_bound`` and ``chip_smoke.solve_bound``.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 67e12
L2_BYTES = 50e6
WORD = 8


def bound_s(nbytes: float, nops: float):
    """(seconds, "bytes" or "operations"): what bounds the work."""
    tb = nbytes / HBM_BYTES_PER_S
    to = nops / F64_FLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def factor_counts(levels):
    """(bytes, operations) of one ``nd_factor`` over ``levels`` [(nk, a,
    b)]: each front's (f + 1)^2 entries read once, Lf, U and S written once;
    the flops of the column-by-column elimination, each symmetric update
    (A's trailing block, S) on its lower triangle only."""
    nbytes = nops = 0
    for nk, a, b in levels:
        f = a + b
        nbytes += WORD * nk * (f * f + a * a + a * b + b * b)
        for j in range(a):
            w = a - 1 - j
            nops += nk * (w * (w + 1) + 2 * b * w + b * (b + 1) + w + b + 1)
    return nbytes, nops


def solve_counts(levels, n_J: int, n_updated: int):
    """(bytes, operations) of one ``nd_solve`` over ``levels`` [(nk, a, b)]:
    rhs in and x out; the forward sweep reads each level's Lf lower
    triangle and U, the vector entries it gathers and writes y; the
    backward sweep reads them again less what the 50 MB L2 still holds
    (the factors count 2 fbytes - min(fbytes, L2)); two flops a factor
    entry a sweep and one a separator update (``n_updated`` boundary
    entries that are real dofs)."""
    fbytes = sum(WORD * nk * (a * (a + 1) // 2 + a * b) for nk, a, b in levels)
    nbytes = WORD * 2 * (n_J + 1) + 2 * fbytes - min(fbytes, L2_BYTES)
    nops = n_updated
    for nk, a, b in levels:
        nbytes += WORD * nk * (a + b)
        nops += nk * (2 * a * a + 4 * a * b)
    return nbytes, nops

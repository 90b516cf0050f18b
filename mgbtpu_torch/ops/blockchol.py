"""Dense equilibrated shifted-Cholesky explicit inverse: the dense base of
the V-cycle and the coarse solve of the two-level FSAI preconditioner
(torch port of ``shifted_spd_inverse``, ``mgbtpu/ops/blockchol.py``).

The JAX module's blocked Cholesky and blocked triangular inverse exist only
to keep XLA programs small; here the factor is ``cholesky_ex`` (through
``kernels.cholesky_nan``, NaN on a non-positive-definite input, as the
reference's factor) and the inverse a triangular solve against the
identity, library calls on the card as on the CPU.
"""
from __future__ import annotations

import torch

from ..kernels import cholesky_nan


def shifted_spd_inverse(Hmat, shifts=(2.0, 32.0)):
    """Returns (Minv, dinv) with M = dinv * Hmat * dinv + shift*eps*I (the
    smallest shift of the ladder whose factor is finite) and Minv = M^-1.

    The shift floors the preconditioned spectrum (kappa_pre ~ shift /
    lambda_min), so the smallest finite one wins; the explicit inverse makes
    each application one dense matvec."""
    eps = torch.finfo(Hmat.dtype).eps
    d = torch.sqrt(torch.abs(torch.diagonal(Hmat)))
    dinv = torch.where(d > 0, 1.0 / d, torch.ones_like(d))
    Hs = Hmat * (dinv[:, None] * dinv[None, :])
    eye = torch.eye(Hmat.shape[0], dtype=Hmat.dtype, device=Hmat.device)
    for c in shifts:
        L = cholesky_nan(Hs + (c * eps) * eye)
        if bool(torch.isfinite(L).all()):
            break
    X = torch.linalg.solve_triangular(L, eye, upper=False)
    return X.mT @ X, dinv

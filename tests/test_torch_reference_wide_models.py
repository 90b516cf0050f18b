"""The stored JAX x64 records of the models past K6's 16-piece, 32-row
kernels (``port_models.WIDE_MODELS``, each on fem1d's 5 nodes), re-derived
from JAX here so they cannot drift from the reference; marked ``slow``
(outside tier-1: about 20 s).

The JAX package writes a cone's Hessian as a scalar graph of nz^4 terms:
XLA's compile of the nz = 17 Newton program passed 29 GB and five minutes
on the CPU before it was stopped, and ``jax.vmap`` of that Hessian without
``jit`` takes 88 s a call. So the field models' records come from their
one-field equivalent (``port_models.py``): the JAX x64 solve of one field
v with the coefficient |c|, whose path gives the n-field path as
u_i = (c_i / |c|) v (the barrier and the stopping tests are invariant
under rotations of the field vector, and so is Newton's method), with the
same Newton counts in exact arithmetic.
``tests/test_torch_wide_tables.py`` holds the port's CPU solves of the same
models to these records in tier-1, and ``chip_smoke.py`` the card's.

- ``seventeen_constraints``: 17 pieces (phase I over their cobarrier).
- ``sixteen_fields``: one cone of nz = 17 over 33 rows.
- ``thirty_two_fields``: one cone of nz = 33 over 65 rows.

Regenerate ``ref_model_wide.npz`` (all, or the models named) with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_wide_models.py [name ...]
"""
import os
import sys

import numpy as np
import pytest

from jax_references import DATA, assert_same_record, record_of, solve_record

WIDE = os.path.join(DATA, "ref_model_wide.npz")
FIELDS = {"sixteen_fields": 16, "thirty_two_fields": 32}


def fem1d_mesh(pkg):
    return pkg.amg(pkg.fem1d(nodes=np.linspace(-1.0, 1.0, 5)))


def fields_from_one(z1, c):
    """The n-field solution (m, n + 1) from the one-field one (m, 2), the
    columns u_0..u_{n-1}, s: u_i = (c_i / |c|) v."""
    c = np.asarray(c, np.float64)
    return np.concatenate([z1[:, :1] * (c / np.linalg.norm(c))[None, :],
                           z1[:, 1:]], axis=1)


def wide_model_reference(name) -> dict:
    """Record of the JAX x64 solve of ``port_models.MODELS[name]`` on
    fem1d's 5 nodes (a field model's through its one-field equivalent)."""
    import mgbtpu
    import port_models

    mg = fem1d_mesh(mgbtpu)
    if name in FIELDS:
        c = port_models.field_coefficients(FIELDS[name])
        m, _ = port_models.n_fields(mgbtpu, mg, 1, [np.linalg.norm(c)])
    else:
        m, _ = port_models.MODELS[name](mgbtpu, mg)
    sol = m.solve(**port_models.SOLVE)
    out = dict(solve_record(sol),
               cg=np.asarray(sol.SOL_main["cg"], np.int64))
    if name in FIELDS:
        out["z"] = fields_from_one(out["z"], c)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", ["seventeen_constraints", "sixteen_fields",
                                  "thirty_two_fields"])
def test_wide_model_reference_reproduces(name):
    assert_same_record(wide_model_reference(name),
                       record_of(np.load(WIDE), name))


if __name__ == "__main__":
    from jax_references import main_setup, update

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_use_fusion_emitters=false"
                               ).strip()
    main_setup()
    import port_models

    for name in sys.argv[1:] or port_models.WIDE_MODELS:
        update(WIDE, {name: wide_model_reference(name)})

"""The stored JAX x64 yardsticks of the front-end slice's card runs
(``chip_smoke.py``), re-derived from JAX here so they cannot drift from the
reference; marked ``slow`` (outside tier-1: about 20 s, 45 s and 20 s of
JAX x64 on one CPU). Each model is built by the same function on both sides
(``port_models.py``, called with the JAX package here).

- ``ref_model_torsion_L5.npz``: ``examples/model_dsl.py``'s elastoplastic
  torsion on ``subdivide(fem2d_P2(), 5)``, tol 1e-6: the solve record, its
  CG counts and the duals of its three constraints (equality, epigraph,
  linear).
- ``ref_gmsh_lshape.npz``: the committed L-shaped mesh
  (``mgbtpu_torch/data/lshape_tri6.msh``) through ``gmsh_import`` (P2 with
  the bubble), ``assemble(amg(g), p=1.0)`` and ``mgb_solve``, as
  ``tests/test_gmsh.py`` solves its meshes.
- ``ref_model_five_L3.npz``: the five-constraint model (phase I over the
  five-piece cobarrier) and, under ``three_fields/``, the three-field model
  (one nz = 7 cone), on ``subdivide(fem2d_P2(), 3)``.

Regenerate them with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_frontends.py
"""
import os

import numpy as np
import pytest

from jax_references import (DATA, assert_same_record, flatten, record_of,
                            save, solve_record)

TORSION = os.path.join(DATA, "ref_model_torsion_L5.npz")
LSHAPE = os.path.join(DATA, "ref_gmsh_lshape.npz")
FIVE = os.path.join(DATA, "ref_model_five_L3.npz")
MSH = os.path.join(DATA, "lshape_tri6.msh")


def model_reference(name, L, duals=()) -> dict:
    """Record of the JAX x64 solve of ``port_models.MODELS[name]`` on fem2d_P2
    L, with its CG counts and the duals of the constraints ``duals``."""
    import mgbtpu
    import port_models

    mg = mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L))
    m, cons = port_models.MODELS[name](mgbtpu, mg)
    sol = m.solve(**port_models.SOLVE)
    out = dict(solve_record(sol), cg=np.asarray(sol.SOL_main["cg"], np.int64),
               L=np.array(L))
    for key in duals:
        out[f"dual_{key}"] = np.asarray(m.dual(cons[key]), np.float64)
    return out


def lshape_reference() -> dict:
    import mgbtpu
    from mgbtpu.frontends import gmsh_import

    g = gmsh_import(MSH).geometry
    sol = mgbtpu.mgb_solve(mgbtpu.assemble(mgbtpu.amg(g), p=1.0))
    return dict(solve_record(sol), cg=np.asarray(sol.SOL_main["cg"], np.int64))


def _same(fresh, stored, extra=()):
    assert_same_record(fresh, stored)
    np.testing.assert_array_equal(fresh["cg"], stored["cg"])
    for key in extra:
        d = stored[key]
        assert np.abs(fresh[key] - d).max() <= 1e-10 * np.abs(d).max()


@pytest.mark.slow
def test_torsion_l5_reference_reproduces():
    stored = dict(np.load(TORSION))
    duals = [k for k in stored if k.startswith("dual_")]
    _same(model_reference("torsion", 5, [k[5:] for k in duals]), stored,
          duals)


@pytest.mark.slow
def test_lshape_reference_reproduces():
    _same(lshape_reference(), dict(np.load(LSHAPE)))


@pytest.mark.slow
def test_five_constraints_and_three_fields_l3_reproduce():
    data = np.load(FIVE)
    for name in ("five_constraints", "three_fields"):
        _same(model_reference(name, 3), record_of(data, name))


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    save(TORSION, model_reference("torsion", 5, ("eq", "cone", "lin")))
    save(LSHAPE, lshape_reference())
    save(FIVE, flatten({n: model_reference(n, 3)
                        for n in ("five_constraints", "three_fields")}))

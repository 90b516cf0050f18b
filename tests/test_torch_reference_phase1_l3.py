"""The stored JAX x64 yardstick of the port's card solve of
``zoo.p_harmonic`` on fem2d_P2 L=3 from an infeasible start (s = 0): phase
I of a 3-component problem over 7 + 1 + 3 = 11 rows, the widest the port's
kernels take on a solve (``mgbtpu_torch/data/ref_phase1_L3.npz``, held
against by ``chip_smoke.py``). Re-derived from JAX in the ``slow`` test so
it cannot drift from the reference; the tier-1 case checks that the record
is whole and that what derived it is unchanged (its fingerprint,
``jax_references``). Regenerate (with its fingerprint) with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_phase1_l3.py
"""
import os

import numpy as np
import pytest

from jax_references import (DATA, assert_record_holds, assert_same_record,
                            flatten, record_of, save, write_fingerprint,
                            zoo_reference)

REF = os.path.join(DATA, "ref_phase1_L3.npz")
L = 3
NAME = "p_harmonic"


def test_phase1_l3_reference_reproduces():
    """The record is whole, with a phase I, and what derived it is
    unchanged."""
    stored = record_of(np.load(REF), NAME)
    assert stored["feas_its"].size > 0
    assert_record_holds(
        "ref_phase1_L3.npz", stored, "tests/test_torch_reference_phase1_l3.py"
        "::test_phase1_l3_reference_rederives", z_shape=(224, 3))


@pytest.mark.slow
def test_phase1_l3_reference_rederives():
    stored = record_of(np.load(REF), NAME)
    assert stored["feas_its"].size > 0
    assert_same_record(zoo_reference(NAME, L, s_init=0.0), stored)


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    save(REF, flatten({NAME: zoo_reference(NAME, L, s_init=0.0)}))
    write_fingerprint(os.path.basename(REF))

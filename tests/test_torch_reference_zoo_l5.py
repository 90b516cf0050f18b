"""The stored JAX x64 yardstick of the port's card solve of
``zoo.two_sided_obstacle`` on fem2d_P2 L=5
(``mgbtpu_torch/data/ref_obstacle_L5.npz``, held against by
``chip_smoke.py``): re-derived from JAX in the ``slow`` test so it cannot
drift from the reference; the tier-1 case checks that the record is whole
and that what derived it is unchanged (its fingerprint,
``jax_references``). Regenerate (with its fingerprint) with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_zoo_l5.py
"""
import os

import numpy as np
import pytest

from jax_references import (DATA, assert_record_holds, assert_same_record,
                            flatten, record_of, save, write_fingerprint,
                            zoo_reference)

REF = os.path.join(DATA, "ref_obstacle_L5.npz")
L = 5
NAME = "two_sided_obstacle"


def test_obstacle_l5_reference_reproduces():
    """The record is whole and what derived it is unchanged."""
    assert_record_holds(
        "ref_obstacle_L5.npz", record_of(np.load(REF), NAME),
        "tests/test_torch_reference_zoo_l5.py::"
        "test_obstacle_l5_reference_rederives", z_shape=(3584, 2))


@pytest.mark.slow
def test_obstacle_l5_reference_rederives():
    stored = record_of(np.load(REF), NAME)
    assert_same_record(zoo_reference(NAME, L), stored)


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    save(REF, flatten({NAME: zoo_reference(NAME, L)}))
    write_fingerprint(os.path.basename(REF))

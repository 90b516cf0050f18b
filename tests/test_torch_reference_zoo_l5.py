"""The stored JAX x64 yardstick of the port's card solve of
``zoo.two_sided_obstacle`` on fem2d_P2 L=5
(``mgbtpu_torch/data/ref_obstacle_L5.npz``, held against by
``chip_smoke.py``): re-derived from JAX here so it cannot drift from the
reference. Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_zoo_l5.py
"""
import os

import numpy as np

from jax_references import (DATA, assert_same_record, flatten, record_of,
                            save, zoo_reference)

REF = os.path.join(DATA, "ref_obstacle_L5.npz")
L = 5
NAME = "two_sided_obstacle"


def test_obstacle_l5_reference_reproduces():
    stored = record_of(np.load(REF), NAME)
    assert_same_record(zoo_reference(NAME, L), stored)


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    save(REF, flatten({NAME: zoo_reference(NAME, L)}))

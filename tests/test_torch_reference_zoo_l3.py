"""The stored JAX x64 yardsticks of the port's card solves of the six zoo
problems on fem2d_P2 L=3 (``mgbtpu_torch/data/ref_zoo_L3.npz``, held
against by ``chip_smoke.py``): re-derived from JAX here so they cannot
drift from the reference. Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_zoo_l3.py
"""
import os

import numpy as np
import pytest

from jax_references import (DATA, assert_same_record, flatten, record_of,
                            save, zoo_reference)

REF = os.path.join(DATA, "ref_zoo_L3.npz")
L = 3
NAMES = ["p_harmonic", "norton_hoff", "rof", "two_sided_obstacle",
         "elastoplastic_torsion", "minimal_surface"]


@pytest.mark.parametrize("name", NAMES)
def test_zoo_l3_reference_reproduces(name):
    stored = record_of(np.load(REF), name)
    assert_same_record(zoo_reference(name, L), stored)


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    save(REF, flatten({n: zoo_reference(n, L) for n in NAMES}))

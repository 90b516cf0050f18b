"""The stored JAX x64 yardstick of the port's card solve of fem2d_P1, p=1,
L=5 (``mgbtpu_torch/data/ref_fem2d_p1_L5.npz``, held against by
``chip_smoke.py``): re-derived from JAX in the ``slow`` test so it cannot
drift from the reference; the tier-1 case checks that the record is whole
and that what derived it is unchanged (its fingerprint,
``jax_references``). Regenerate it (with its fingerprint) with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_p1.py
"""
import os

import numpy as np
import pytest

from jax_references import (DATA, assert_record_holds, assert_same_record,
                            p_laplace_reference, save, write_fingerprint)

REF = os.path.join(DATA, "ref_fem2d_p1_L5.npz")
L = 5


def test_p1_l5_reference_reproduces():
    """The record is whole and what derived it is unchanged."""
    assert_record_holds(
        "ref_fem2d_p1_L5.npz", dict(np.load(REF)),
        "tests/test_torch_reference_p1.py::test_p1_l5_reference_rederives",
        z_shape=(1536, 2), cg=True)


@pytest.mark.slow
def test_p1_l5_reference_rederives():
    stored = dict(np.load(REF))
    fresh = p_laplace_reference("fem2d_P1", L)
    assert_same_record(fresh, stored)
    np.testing.assert_array_equal(fresh["cg"], stored["cg"])


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    save(REF, p_laplace_reference("fem2d_P1", L))
    write_fingerprint(os.path.basename(REF))

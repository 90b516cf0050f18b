"""The stored JAX x64 yardsticks of the port's card solves of fem3d (the
default k=3 Q3 hexes), p=1, at L=3 and L=4
(``mgbtpu_torch/data/ref_fem3d_k3_L{3,4}.npz``, held against by
``chip_smoke.py``): re-derived from JAX here so they cannot drift from the
reference. The L=4 solve takes about two minutes of JAX x64 on one CPU and
is marked ``slow`` (outside tier-1). Regenerate both with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_fem3d.py
"""
import os

import numpy as np
import pytest

from jax_references import (DATA, assert_same_record, p_laplace_reference,
                            save)


def ref_path(L):
    return os.path.join(DATA, f"ref_fem3d_k3_L{L}.npz")


def _reproduces(L):
    stored = dict(np.load(ref_path(L)))
    fresh = p_laplace_reference("fem3d", L)
    assert_same_record(fresh, stored)
    np.testing.assert_array_equal(fresh["cg"], stored["cg"])


def test_fem3d_l3_reference_reproduces():
    _reproduces(3)


@pytest.mark.slow
def test_fem3d_l4_reference_reproduces():
    _reproduces(4)


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    for L in (3, 4):
        save(ref_path(L), p_laplace_reference("fem3d", L))

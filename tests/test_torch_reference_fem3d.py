"""The stored JAX x64 yardsticks of the port's card solves of fem3d (the
default k=3 Q3 hexes), p=1, at L=3, L=4 and L=5
(``mgbtpu_torch/data/ref_fem3d_k3_L{3,4,5}.npz``, held against by
``chip_smoke.py``, L=5 with ``--fem3d-level 5``): re-derived from JAX here
so they cannot drift from the reference in the ``slow`` tests (L=3 about
seven minutes of JAX x64 beside other tests, L=4 about two minutes alone,
L=5 about 45 minutes and 18 GB alone); the tier-1 cases check that the L=3
and L=5 records are whole and that what derived them is unchanged (their
fingerprints, ``jax_references``). Regenerate the L=3 and L=4 records (and
their fingerprints) with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_fem3d.py [L ...]

(the levels given, L=3 and L=4 when none is).
"""
import os
import sys

import numpy as np
import pytest

from jax_references import (DATA, assert_record_holds, assert_same_record,
                            p_laplace_reference, save, write_fingerprint)


def ref_path(L):
    return os.path.join(DATA, f"ref_fem3d_k3_L{L}.npz")


def _reproduces(L):
    stored = dict(np.load(ref_path(L)))
    fresh = p_laplace_reference("fem3d", L)
    assert_same_record(fresh, stored)
    np.testing.assert_array_equal(fresh["cg"], stored["cg"])


def test_fem3d_l3_reference_reproduces():
    """The L=3 record is whole and what derived it is unchanged."""
    assert_record_holds(
        "ref_fem3d_k3_L3.npz", dict(np.load(ref_path(3))),
        "tests/test_torch_reference_fem3d.py::test_fem3d_l3_reference_rederives",
        z_shape=(4096, 2), cg=True)


@pytest.mark.slow
def test_fem3d_l3_reference_rederives():
    _reproduces(3)


@pytest.mark.slow
def test_fem3d_l4_reference_reproduces():
    _reproduces(4)


def test_fem3d_l5_reference_reproduces():
    """The L=5 record (4,096 hexes, 262,144 nodes) is whole and what derived
    it is unchanged."""
    rec = dict(np.load(ref_path(5)))
    assert int(rec["L"]) == 5 and rec["z"].shape == (4096 * 64, 2)
    assert_record_holds(
        "ref_fem3d_k3_L5.npz", rec,
        "tests/test_torch_reference_fem3d.py::test_fem3d_l5_reference_rederives",
        z_shape=rec["z"].shape, cg=True)


@pytest.mark.slow
def test_fem3d_l5_reference_rederives():
    _reproduces(5)


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    for L in [int(a) for a in sys.argv[1:]] or [3, 4]:
        save(ref_path(L), p_laplace_reference("fem3d", L))
        write_fingerprint(os.path.basename(ref_path(L)))

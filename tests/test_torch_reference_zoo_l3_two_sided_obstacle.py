"""The stored JAX x64 yardstick of the port's card solve of
``zoo.two_sided_obstacle`` on fem2d_P2 L=3 (its record in
``mgbtpu_torch/data/ref_zoo_L3.npz``, held against by ``chip_smoke.py``),
re-derived from JAX here so that it cannot drift from the reference (the
``slow`` test; tier-1 checks the record's fingerprint, ``jax_references``).
Each of the six zoo problems has a file of its own: each solve takes one
to three minutes of JAX x64, and a run spreads files, not tests, over its
workers (``--dist loadfile``). Regenerate this record with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_zoo_l3_two_sided_obstacle.py
"""
import pytest

from jax_references import zoo_l3_holds, zoo_l3_reproduces, zoo_l3_update

NAME = "two_sided_obstacle"


@pytest.mark.parametrize("name", [NAME])
def test_zoo_l3_reference_reproduces(name):
    """The record is whole and what derived it is unchanged."""
    zoo_l3_holds(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", [NAME])
def test_zoo_l3_reference_rederives(name):
    zoo_l3_reproduces(name)


if __name__ == "__main__":
    zoo_l3_update(NAME)

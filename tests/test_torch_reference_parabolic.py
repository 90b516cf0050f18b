"""The stored JAX x64 yardstick of the port's card run of
``parabolic_solve`` on fem2d_P2 L=5, p=1, h=0.5 over [0, 1]
(``mgbtpu_torch/data/ref_parabolic_L5.npz``: the states u of both implicit
steps and each step's phase-I and main-ramp record, held against by
``chip_smoke.py``). Re-derived here on the first step only (ts = 0, 0.5:
half the cost); the second step's values come from the same ``__main__``
run. Regenerate with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_parabolic.py
"""
import os

import numpy as np

from jax_references import (DATA, assert_same_record, parabolic_reference,
                            record_of, save)

REF = os.path.join(DATA, "ref_parabolic_L5.npz")
L = 5
TS = (0.0, 0.5, 1.0)


def test_parabolic_l5_first_step_reproduces():
    data = np.load(REF)
    np.testing.assert_array_equal(data["ts"], TS)
    fresh = parabolic_reference(L, TS[:2])
    u = data["u"]
    np.testing.assert_array_equal(fresh["u"][0], u[0])
    assert np.linalg.norm(fresh["u"][1] - u[1]) <= 1e-10 * np.linalg.norm(u[1])
    assert_same_record(record_of(fresh, "step1"), record_of(data, "step1"))


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    save(REF, parabolic_reference(L, TS))

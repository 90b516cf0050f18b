"""PyTorch port, fem2d_P2 p=1 on the CPU at L=4, 6 and 7 against the JAX x64
records ``mgbtpu_torch/data/ref_fem2d_p2_L{4,6,7}.npz``
(``tests/test_torch_reference_data.py`` writes them): the bars
``chip_smoke.py --level L`` holds the card to, with the solution to 1e-8
relative here: the Newton iterations in total within 5 % and the accepted /
attempted ramp steps equal. L=7 (57,344 nodes, minutes on one CPU thread)
is marked ``slow``.
"""
import os

import numpy as np
import pytest
import torch

import mgbtpu_torch as mt

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mgbtpu_torch", "data")


def _held(L):
    ref = np.load(os.path.join(DATA, f"ref_fem2d_p2_L{L}.npz"))
    sol = mt.mgb_solve(mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), L)),
                                   p=1.0, device="cpu"), device="cpu")
    S = sol.SOL_main
    z = ref["z"]
    assert sol.z.shape == z.shape and np.isfinite(sol.z).all()
    assert np.linalg.norm(sol.z - z) <= 1e-8 * np.linalg.norm(z)
    its, its_ref = int(S["its"].sum()), int(ref["its"].sum())
    assert abs(its - its_ref) <= 0.05 * its_ref, (its, its_ref)
    assert [S["steps_accepted"], S["steps_attempted"]] == \
        ref["steps"].tolist()


@pytest.mark.parametrize("L", [4, 6])
def test_solve_matches_record(L):
    _held(L)


@pytest.mark.slow
def test_l7_solve_matches_record():
    _held(7)

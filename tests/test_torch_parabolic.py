"""PyTorch port, ``parabolic_solve`` on the CPU: the reference's fem2d_P2
golden vector (``tests/test_golden.py::test_parabolic_fem2d_P2``) to the
same 1e-6, and every implicit step's state u equal to the JAX x64 solve's to
1e-8 at fem2d_P2 L=2, h=0.5. Each step starts on the cones' walls (s1 = s2
= 0), so each runs phase I through the intersected cones' cobarrier and the
box (kernel K6's plain version here) before its main ramp."""
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
from test_golden import GOLD_fem2d_P2

torch.set_num_threads(1)
TOL_U = 1e-8


def test_golden_fem2d_p2():
    sol = mgbtpu_torch.parabolic_solve(mgbtpu_torch.amg(mgbtpu_torch.fem2d_P2()),
                                       h=0.5, p=1.0, device="cpu")
    assert np.linalg.norm(np.stack(sol.u) - np.array(GOLD_fem2d_P2)) < 1e-6
    np.testing.assert_array_equal(sol.ts, [0.0, 0.5, 1.0])


def test_steps_match_jax_l2():
    L = 2
    sj = mgbtpu.parabolic_solve(
        mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)), h=0.5, p=1.0)
    mt = mgbtpu_torch
    st = mt.parabolic_solve(mt.amg(mt.subdivide(mt.fem2d_P2(), L)), h=0.5,
                            p=1.0, device="cpu")
    assert len(st.u) == len(sj.u) == 3
    for uj, ut in zip(sj.u, st.u):
        assert ut.shape == uj.shape
        assert np.linalg.norm(ut - uj) <= TOL_U * np.linalg.norm(uj)


def test_parabolic_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgbtpu_torch.parabolic_solve(mgbtpu_torch.amg(mgbtpu_torch.fem2d_P2()),
                                     h=0.5)

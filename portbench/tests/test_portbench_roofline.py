"""The roofline counts: by hand at a small plan, equal to the records'
arithmetic (``chip_smoke.factor_bound``/``solve_bound``) on a real plan, and
a function of the plan's shapes alone."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import roofline, trace


def test_factor_counts_by_hand():
    # one level of 2 fronts, a = 3 assigned and b = 1 boundary columns:
    # (f + 1)^2 read... f = 4: 16 + 9 + 3 + 1 words a front
    nbytes, nops = roofline.factor_counts([(2, 3, 1)])
    assert nbytes == 8 * 2 * (16 + 9 + 3 + 1)
    # columns j = 0, 1, 2 (w = 2, 1, 0): 16 + 9 + 4 flops a front
    assert nops == 2 * (16 + 9 + 4)


def test_solve_counts_by_hand():
    nbytes, nops = roofline.solve_counts([(2, 3, 1)], n_J=10, n_updated=5)
    fbytes = 8 * 2 * (6 + 3)            # Lf's lower triangle and U
    assert nbytes == 8 * 2 * 11 + fbytes + 8 * 2 * 4
    assert nops == 5 + 2 * (2 * 9 + 4 * 3)


def test_bound_names_what_bounds_it():
    assert roofline.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound_s(1.0, 67e12) == (1.0, "operations")


def _level(nk, a, b, bdofs):
    return SimpleNamespace(nk=nk, amax=a, bmax=b,
                           bdofs=np.asarray(bdofs).reshape(nk, b))


def test_counts_depend_on_the_shapes_alone():
    n_J = 40
    p1 = SimpleNamespace(n_J=n_J, levels=[_level(2, 3, 2, [1, 2, 3, 40]),
                                          _level(1, 4, 1, [40])])
    p2 = SimpleNamespace(n_J=n_J, levels=[_level(2, 3, 2, [9, 8, 7, 40]),
                                          _level(1, 4, 1, [40])])
    s1, s2 = trace._plan_shapes(p1), trace._plan_shapes(p2)
    assert s1 == s2
    assert roofline.factor_counts(s1[0]) == roofline.factor_counts(s2[0])
    assert roofline.solve_counts(*s1) == roofline.solve_counts(*s2)


@pytest.fixture(scope="module")
def nd_plan():
    import mgbtpu_torch as mt
    from mgbtpu_torch.solver.levelops import build_panel_ops
    from mgbtpu_torch.solver.mgb import ProblemKernels, nd_plan as plan

    import torch

    M = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 4)), p=1.0,
                    device="cpu").M[0]
    ops = build_panel_ops(M.D_fine, M.nu, M.R_fine[-1],
                          M.geometry.x.shape[0], torch.device("cpu"))
    return plan(M, ops, ProblemKernels.ND_LEAF_ELEMS, torch.device("cpu"))


def test_frozen_copy_equals_the_records_arithmetic(nd_plan):
    import chip_smoke

    levels, n_J, updated = trace._plan_shapes(nd_plan)
    fronts = [(SimpleNamespace(shape=(nk,)), a, b) for nk, a, b in levels]
    ms, by = chip_smoke.factor_bound(fronts)
    s, by2 = roofline.bound_s(*roofline.factor_counts(levels))
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)
    ms, by, _ = chip_smoke.solve_bound(nd_plan.levels, nd_plan.n_J)
    s, by2 = roofline.bound_s(*roofline.solve_counts(levels, n_J, updated))
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)

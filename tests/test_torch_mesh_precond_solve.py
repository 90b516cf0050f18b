"""PyTorch port, whole solves with the V-cycle and FSAI preconditioners of
a large level under a mesh of CPU shards: fem2d_P2 L=2 (8 elements) with
DENSE_MAX=50 and DENSE_BASE=10, so that its top level (73 coefficients)
takes the large-level context (asserted) over a three-level V-cycle or the
FSAI factor with its coarse correction at the 6-coefficient dense base.
``mgb_solve(mesh=make_mesh(devices=["cpu"] * n))`` for n = 2 and 4, under
``vcycle`` and ``fsai2``: the same z, bit for bit, and the same Newton and
CG counts as the unsharded solve (one unsharded solve a choice, cached).
"""
import numpy as np
import pytest
import torch

import mgbtpu_torch as mt
from mgbtpu_torch.solver import mgb as MT
from mgbtpu_torch.solver import newton as NT
from mgbtpu_torch.solver.levelops import ShardedOps

torch.set_num_threads(1)
CPU = torch.device("cpu")
_UNSHARDED = {}


def _solve(n):
    """The solve over n CPU shards (n = 1: no mesh), and its top level's
    operators."""
    mesh = None if n == 1 else mt.make_mesh(devices=["cpu"] * n)
    prob = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 2)), p=1.0,
                       device="cpu")
    sol = mt.mgb_solve(prob, device="cpu", mesh=mesh)
    M = prob.M[0]
    kern = MT._kernels_for(M, prob.Q, None, NT.linesearch_backtracking(),
                           CPU, mesh)
    return sol, kern.ops(M.depth - 1)


@pytest.mark.parametrize("choice,n", [("vcycle", 2), ("vcycle", 4),
                                      ("fsai2", 2), ("fsai2", 4)])
def test_solve_under_a_mesh(choice, n, monkeypatch):
    monkeypatch.setattr(MT.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch.setattr(MT.ProblemKernels, "DENSE_BASE", 10)
    monkeypatch.setattr(NT, "BIG_PRE", choice)
    if choice not in _UNSHARDED:
        _UNSHARDED[choice] = _solve(1)[0]
    s1 = _UNSHARDED[choice]
    sol, top = _solve(n)
    ctx = top.pcg_ctx
    assert isinstance(top, ShardedOps) and len(top.shards) == n
    assert ctx is not None and ctx.nd is None
    assert [o.n_J for o in ctx.coarse_ops] == [6, 26]
    if choice == "fsai2":
        assert ctx.fsai is not None and ctx.coarse_T is not None
    S, S1 = sol.SOL_main, s1.SOL_main
    assert int(S["cg"].sum()) > 0
    assert np.isfinite(sol.z).all()
    assert np.array_equal(sol.z, s1.z)
    np.testing.assert_array_equal(S["its"], S1["its"])
    np.testing.assert_array_equal(S["cg"], S1["cg"])

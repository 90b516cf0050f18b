"""PyTorch port, the V-cycle and FSAI preconditioners of a large level
under a mesh of CPU shards (``make_mesh(devices=["cpu"] * n)``):

- ``make_pcg_pre`` + ``pcg_solve`` at the top level of fem2d_P2 L=3
  (N = 32 elements) with DENSE_MAX=50, DENSE_BASE=40, at p=2, t=100, s=0
  (``tests/test_torch_precond.py``'s state), for each of ``vcycle``,
  ``fsai``, ``fsai2`` and ``fsai2a`` over 2 shards and ``vcycle`` over 4:
  the bits and the CG count of the unsharded call, the chosen levels
  sharded alike, the traffic counted in ``TRANSFERS``;
- the V-cycle mesh solve of fem2d_P2 L=2 (8 elements, DENSE_MAX=50,
  DENSE_BASE=10: the top level of 73 coefficients takes a three-level
  V-cycle) within 6e-7, JAX's own mesh bar (``tests/test_sharding.py``),
  of the JAX x64 solve under the same knobs (one JAX solve, cached).

A mesh gives the bits of one device: every sum over a level's elements or
nodes runs once on the first device in one device's order.
"""
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt
from mgbtpu.solver import mgb as MJ
from mgbtpu.solver import newton as NJ
from mgbtpu_torch.parallel.sharding import TRANSFERS, reset_transfers
from mgbtpu_torch.solver import mgb as MT
from mgbtpu_torch.solver import newton as NT
from mgbtpu_torch.solver.levelops import PanelOps, ShardedOps

torch.set_num_threads(1)
CPU = torch.device("cpu")
_JAX = {}


def _level(L, p, mesh):
    """(kernels, level, top ops) of fem2d_P2 L at p, over ``mesh``."""
    prob = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), L)), p=p,
                       device="cpu")
    M = prob.M[0]
    kern = MT._kernels_for(M, prob.Q, None, NT.linesearch_backtracking(),
                           CPU, mesh)
    return prob, kern, M.depth - 1


def _pcg(n, p=2.0, t=100.0):
    """(x, CG count, top ops) of ``pcg_solve`` at the L=3 top level's
    state over n CPU shards (n = 1: no mesh)."""
    mesh = None if n == 1 else mt.make_mesh(devices=["cpu"] * n)
    prob, kern, l = _level(3, p, mesh)
    ops = kern.ops(l)
    M = prob.M[0]
    wc = M.w[:, None] * (t * prob.f_grid)
    z = np.asarray(prob.g_grid).T.reshape(-1)
    fa = kern._fargs(l, z, wc, MT.barrier_weights(M.w, None),
                     tuple(kern.tensor(a) for a in prob.Q.args))
    s0 = torch.zeros((ops.n_J,), dtype=torch.float64)
    H, g = kern.fns[2](s0, *fa), kern.fns[1](s0, *fa)
    pre = NT.make_pcg_pre(H)
    x, k = NT.pcg_solve(H, g, pre=pre)
    return x.numpy(), k, ops


@pytest.mark.parametrize("choice,n", [("vcycle", 2), ("vcycle", 4),
                                      ("fsai", 2), ("fsai2", 2),
                                      ("fsai2a", 2)])
def test_pcg_solve_under_a_mesh(choice, n, monkeypatch):
    monkeypatch.setattr(MT.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch.setattr(MT.ProblemKernels, "DENSE_BASE", 40)
    monkeypatch.setattr(NT, "BIG_PRE", choice)
    x1, k1, o1 = _pcg(1)
    reset_transfers()
    x, k, ops = _pcg(n)
    assert isinstance(o1, PanelOps) and isinstance(ops, ShardedOps)
    ctx = ops.pcg_ctx
    assert ctx.nd is None and ctx.n_levels == 2
    # the dense base and the smoothed level are sharded as the top is
    assert all(isinstance(o, ShardedOps) and o.nodes == ops.nodes
               for o in ctx.coarse_ops)
    assert [o.n_J for o in ctx.coarse_ops] == [
        o.n_J for o in o1.pcg_ctx.coarse_ops]
    assert np.isfinite(x).all()
    assert np.array_equal(x, x1)
    assert k == k1 >= 1
    # every Hessian apply gathers one piece a shard to the first device
    assert TRANSFERS["gathers"] >= n * (k + 1)
    assert TRANSFERS["broadcasts"] >= k + 1


def _knobs(monkeypatch):
    """The L=2 solves' knobs in both packages, with the JAX AOT cache off:
    it keys the environment, not monkeypatched module attributes."""
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "0")
    for M in (MJ, MT):
        monkeypatch.setattr(M.ProblemKernels, "DENSE_MAX", 50)
        monkeypatch.setattr(M.ProblemKernels, "DENSE_BASE", 10)
    monkeypatch.setattr(NJ, "BIG_PRE", "vcycle")
    monkeypatch.setattr(NT, "BIG_PRE", "vcycle")


def test_vcycle_mesh_solve_matches_jax(monkeypatch):
    _knobs(monkeypatch)
    mesh = mt.make_mesh(devices=["cpu"] * 2)
    prob, kern, l = _level(2, 1.0, mesh)
    st = mt.mgb_solve(prob, mesh=mesh)
    top = kern.ops(l)
    assert isinstance(top, ShardedOps) and top.pcg_ctx.nd is None
    assert [o.n_J for o in top.pcg_ctx.coarse_ops] == [6, 26]
    if "sj" not in _JAX:
        _JAX["sj"] = mgbtpu.mgb_solve(mgbtpu.assemble(mgbtpu.amg(
            mgbtpu.subdivide(mgbtpu.fem2d_P2(), 2)), p=1.0))
    sj = _JAX["sj"]
    assert int(np.sum(sj.SOL_main["cg"])) > 0     # JAX's CG ran too
    assert st.z.shape == sj.z.shape and np.isfinite(st.z).all()
    assert np.linalg.norm(st.z - sj.z) <= 6e-7 * np.linalg.norm(sj.z)

"""PyTorch port, the large-level preconditioners at full width: one
``make_pcg_pre`` + ``pcg_solve`` at the top level of fem2d_P2 L=5 with the
default DENSE_MAX and DENSE_BASE (the level subset a user gets) under each
``BIG_PRE`` choice, on the CPU, against the stored JAX x64 records
``mgbtpu_torch/data/ref_pcg_L5_<choice>.npz`` that ``chip_smoke.py``
holds the card to (``tools/derive_precond_records.py``).

At ``tests/test_pcg_scaling.py``'s state (p=2, t=100, s=0): x within
1e-8 relative, the CG count within +-1, the chosen levels equal and the
V-cycle's lambda_max within 1e-12 relative. At the deep-t state (p=1 at
t = 1/tol from the stored p=1 L=5 solution): the CG count within +-1, and x in the H-norm
within 1e-8 relative where the record's CG converged below its cap of
150 (at t ~ 6.7e7 the 2-norm of x carries the system's conditioning:
1e-6 apart with the same 89 CG iterations, its H-norm 8e-10).

The fsai2/fsai2a records come from the JAX package with its
``build_bsr`` tiling repaired, as the port builds it (ROADMAP Queue 3):
the record also carries the unrepaired result (``<state>/as_is/``; 68 and
150 CG at the p=2 state against 7 and 9 repaired), which the port is not
held to.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "mgbtpu_torch", "data")
CHOICES = ("vcycle", "fsai", "fsai2", "fsai2a")
CPU = torch.device("cpu")
_PROBS = {}

torch.set_num_threads(1)


def _record(choice):
    return np.load(os.path.join(DATA, f"ref_pcg_L5_{choice}.npz"))


def _problem(p):
    import mgbtpu_torch

    if p not in _PROBS:
        _PROBS[p] = mgbtpu_torch.assemble(mgbtpu_torch.amg(
            mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P2(), 5)), p=p,
            device="cpu")
    return _PROBS[p]


def pcg_at(choice, state, monkeypatch, shift_z=False):
    """The port's (x, CG count, pre, ops, H, g) at the record's state (with
    ``shift_z``, from z one ulp up)."""
    import mgbtpu_torch
    from mgbtpu_torch.solver import mgb as MT
    from mgbtpu_torch.solver import newton as NT

    monkeypatch.setattr(NT, "BIG_PRE", choice)
    ref = _record(choice)
    prob = _problem(2.0 if state == "p2" else 1.0)
    mgbtpu_torch.mgb_cleanup(prob)
    M1 = prob.M[0]
    kern = MT._kernels_for(M1, prob.Q, None, NT.linesearch_backtracking(),
                           CPU)
    l = M1.depth - 1
    ops = kern.ops(l)
    w = M1.w
    t = float(ref[f"{state}/t"])
    if state == "p2":
        z = np.asarray(prob.g_grid).T.reshape(-1)
    else:
        z = np.load(os.path.join(DATA, "ref_fem2d_p2_L5.npz"))["z"].T \
            .reshape(-1)
    if shift_z:
        z = np.nextafter(z, np.inf)
    fa = kern._fargs(l, z, w[:, None] * (t * prob.f_grid),
                     MT.barrier_weights(w, None),
                     tuple(kern.tensor(a) for a in prob.Q.args))
    s0 = torch.zeros((ops.n_J,), dtype=torch.float64)
    H, g = kern.fns[2](s0, *fa), kern.fns[1](s0, *fa)
    pre = NT.make_pcg_pre(H)
    x, k = NT.pcg_solve(H, g, pre=pre)
    return x, k, pre, ops, H, g


def _common(choice, state, monkeypatch):
    ref = _record(choice)
    x, k, pre, ops, H, g = pcg_at(choice, state, monkeypatch)
    ctx = ops.pcg_ctx
    assert ops.n_J == int(ref[f"{state}/n_J"])
    assert [o.n_J for o in ctx.coarse_ops] == \
        ref[f"{state}/levels"].tolist()
    assert abs(k - int(ref[f"{state}/cg"])) <= 1, (k, int(ref[f"{state}/cg"]))
    if choice == "vcycle":
        lmax = float(pre[1][1][ctx.n_levels][1])
        lref = float(ref[f"{state}/lambda_max"])
        assert abs(lmax - lref) <= 1e-12 * lref
    return ref, x, ops, H


@pytest.mark.parametrize("choice", CHOICES)
def test_pcg_l5_p2_state(choice, monkeypatch):
    ref, x, _, _ = _common(choice, "p2", monkeypatch)
    xr = ref["p2/x"]
    assert np.linalg.norm(x.numpy() - xr) <= 1e-8 * np.linalg.norm(xr)


@pytest.mark.parametrize("choice", CHOICES)
def test_pcg_l5_deep_state(choice, monkeypatch):
    ref, x, ops, H = _common(choice, "deep", monkeypatch)
    if int(ref["deep/cg"]) < 150:
        xr = torch.tensor(ref["deep/x"])
        d = x - xr
        err = torch.dot(d, ops.gram_apply(H.Lnode, d)).sqrt()
        scale = torch.dot(xr, ops.gram_apply(H.Lnode, xr)).sqrt()
        assert float(err / scale) <= 1e-8


def test_deep_state_moves_with_the_last_bit_of_z(monkeypatch):
    """Why the card is not held to the deep-state record: at t = 1/tol the
    slacks are ~1/t, so one ulp of z moves the system itself. The same
    V-cycle solve from z one ulp up: x moves by more than 10 % in the
    H-norm (82 % on this state), while its CG count stays."""
    x0, k0, _, ops, H, _ = pcg_at("vcycle", "deep", monkeypatch)
    x1, k1, *_ = pcg_at("vcycle", "deep", monkeypatch, shift_z=True)
    d = x1 - x0
    move = float((torch.dot(d, ops.gram_apply(H.Lnode, d))
                  / torch.dot(x0, ops.gram_apply(H.Lnode, x0))).sqrt())
    print(f"deep state: x moves by {move!r} in the H-norm, cg {k0} -> {k1}")
    assert move > 0.1 and abs(k1 - k0) <= 1


@pytest.mark.slow
@pytest.mark.parametrize("choice", CHOICES)
def test_records_reproduce(choice):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import derive_precond_records as D

    ref = _record(choice)
    fresh = D.pcg_record(choice)
    for key in ref.files:
        if key.endswith("seconds"):
            continue
        if key.endswith("x"):
            assert np.linalg.norm(fresh[key] - ref[key]) <= \
                1e-12 * np.linalg.norm(ref[key]), key
        else:
            np.testing.assert_array_equal(fresh[key], ref[key], err_msg=key)

"""What the port's CPU parity tests share (not a test module): closeness
to 1e-14 of dense and sparse arrays, the comparison of two packages'
prepared hierarchies level by level, panel plans included (the
reference's plans reach the port through
``mgbtpu_torch.interop.from_reference_arrays``), and of two solves' ramps."""
import numpy as np
import torch

from mgbtpu.solver.levelops import build_panel_ops as build_ref
from mgbtpu_torch.interop import from_reference_arrays
from mgbtpu_torch.solver.levelops import build_panel_ops

TOL = 1e-14


def close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= TOL * max(np.abs(b).max(initial=0.0), 1.0)


def close_sparse(A, B):
    A, B = A.tocsr(), B.tocsr()
    assert A.shape == B.shape
    if A.shape[0] * A.shape[1]:
        assert abs(A - B).max() <= TOL * max(abs(B).max(), 1.0)


def same_systems(pj, pt, p):
    """The (main, feasibility) systems of ``prepare_amg`` in both packages:
    weights, nodes, D_fine, and per level R_fine and the panel plan."""
    for Mj, Mt in zip(pj, pt):
        close(Mt.w, Mj.w)
        close(Mt.x, Mj.x)
        assert Mt.depth == Mj.depth
        assert len(Mt.D_fine) == len(Mj.D_fine)
        for (opt, ct), (opj, cj) in zip(Mt.D_fine, Mj.D_fine):
            assert ct == cj
            close(opt.data, opj.data)
        for l in range(Mj.depth):
            close_sparse(Mt.R_fine[l], Mj.R_fine[l])
            oj = build_ref(Mj.D_fine, Mj.nu, Mj.R_fine[l], p, np.float64)
            ref = from_reference_arrays(device="cpu", panel_ops=dict(
                cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
                n_J=oj.n_J))["panel_ops"]
            ot = build_panel_ops(Mt.D_fine, Mt.nu, Mt.R_fine[l], p, "cpu")
            assert (ot.n_J, ot.N, ot.C, ot.p, ot.nD) == (ref.n_J, ref.N,
                                                        ref.C, ref.p, ref.nD)
            assert torch.equal(ot.cols, ref.cols)
            assert torch.equal(ot.inv, ref.inv)
            close(ot.panels.numpy(), ref.panels.numpy())


def same_ramp(sj, st, floor_from=-1, tol_z=1e-8):
    """The same solution (to ``tol_z``) and the same accepted/attempted
    steps; the same Newton its on every ramp step before ``floor_from``
    (default: the last step, the exact-stopping polish). From
    ``floor_from`` on, the steps run at the objective's roundoff floor:
    each within +-1 and all of them within +-4 in total."""
    assert st.z.shape == sj.z.shape
    assert np.linalg.norm(st.z - sj.z) <= tol_z * np.linalg.norm(sj.z)
    Sj, St = sj.SOL_main, st.SOL_main
    assert St["steps_accepted"] == Sj["steps_accepted"]
    assert St["steps_attempted"] == Sj["steps_attempted"]
    ij, it = Sj["its"], St["its"]
    np.testing.assert_array_equal(it[:, :floor_from], ij[:, :floor_from])
    diff = it[:, floor_from:].sum(axis=0) - ij[:, floor_from:].sum(axis=0)
    assert abs(int(diff.sum())) <= 4
    if floor_from != -1:
        assert np.abs(diff).max() <= 1

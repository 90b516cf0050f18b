"""PyTorch port, the seven CUDA kernels against their plain PyTorch versions
on the card, at small ragged shapes and in every mode the wrappers take.

Marked ``cuda``: each test skips without a card. The file imports neither
JAX nor ``mgbtpu``, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: the kernels sum in another order than the plain versions
(per thread in registers, the adjoint's column sums over the inverse
incidence and in fixed shuffle trees, the front factorization column by
column and the front solves in 32-wide tiles where the library blocks
otherwise), so they agree to a few ulps, not bitwise; 1e-13 relative to
the largest entry. They use no atomics, so a repeat call must give the
same bits.
The per-node barrier kernels (K2, K6) follow the plain versions operation
by operation (built with --fmad=false) and must give the same non-finite
pattern.
"""
import numpy as np
import pytest
import torch

import mgbtpu_torch as mt
import mgbtpu_torch.kernels as K
from mgbtpu_torch.kernels.node_barrier import POWER
from mgbtpu_torch.ops.ndchol import boundary_incidence
from mgbtpu_torch.solver.levelops import inverse_incidence

pytestmark = pytest.mark.cuda
TOL = 1e-13


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(torch.isnan(out).cpu(), torch.isnan(ref).cpu())
    np.testing.assert_array_equal(torch.isposinf(out).cpu(),
                                  torch.isposinf(ref).cpu())
    np.testing.assert_array_equal(torch.isneginf(out).cpu(),
                                  torch.isneginf(ref).cpu())
    fin = torch.isfinite(ref)
    if not fin.any():
        return 0.0
    err = float((out[fin] - ref[fin]).abs().max())
    return err / max(float(ref[fin].abs().max()), 1e-300)


def _panels(rng, dev, nD=4, N=37, p=7, C=13, n_J=101):
    """Sorted per-element columns padded by repeating the last one (zero
    panels on the padded slots), as ``build_panel_ops`` lays them out."""
    cols = np.zeros((N, C), np.int64)
    panels = rng.standard_normal((nD, N, p, C))
    for e in range(N):
        k = rng.integers(C // 2, C + 1)
        c = np.sort(rng.choice(n_J, k, replace=False))
        cols[e, :k] = c
        cols[e, k:] = c[-1]
        panels[:, e, :, k:] = 0.0
    inv = inverse_incidence(cols, n_J)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(panels), t(cols), t(inv), n_J


@pytest.mark.parametrize("nD", [4, 9, 11])
def test_panel_fwd(dev, nD):
    """nD = 9 and 11: the phase-I rows of parabolic_solve and p_harmonic."""
    rng = np.random.default_rng(nD)
    panels, cols, _, n_J = _panels(rng, dev, nD=nD)
    nD, N, p, _ = panels.shape
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    before = K.panel_fwd.launches
    for d in (None, dz0):
        assert _rel(K.panel_fwd(panels, cols, s, d),
                    K.panel_fwd_plain(panels, cols, s, d)) <= TOL
    assert K.panel_fwd.launches == before + 2


def _same_bits(a, b):
    return a.shape == b.shape and bool((a.view(torch.int64)
                                        == b.view(torch.int64)).all())


# (n_J, N): coarse levels, each element touching half to all of the n_J
# columns (C = n_J), so a column has ~3N/4 slots: K ~ 100, K ~ 495 as at
# L=5 level 0, K ~ 8,192 as at L=7 level 0 (one block per column)
COARSE = [(16, 130), (4, 660), (2, 11000)]


@pytest.mark.parametrize("p", [7, 3])
@pytest.mark.parametrize("nD", [4, 11])
@pytest.mark.parametrize("coarse", [None] + COARSE)
def test_panel_adj(dev, nD, coarse, p):
    """Both phase-B forms, at the fine-level and the coarse-level shapes,
    phase A for the P2 element's p = 7 and for any other p; repeat calls
    give the same bits."""
    rng = np.random.default_rng(1)
    kw = {} if coarse is None else dict(n_J=coarse[0], N=coarse[1],
                                        C=coarse[0])
    panels, cols, inv, n_J = _panels(rng, dev, nD=nD, p=p, **kw)
    nD, N, p, _ = panels.shape
    if coarse is not None:
        assert inv.shape[1] > 32 and n_J <= 16
    Y = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    before = K.panel_adj.launches
    out = K.panel_adj(panels, cols, inv, Y, n_J)
    assert _rel(out, K.panel_adj_plain(panels, cols, inv, Y, n_J)) <= TOL
    assert _same_bits(out, K.panel_adj(panels, cols, inv, Y, n_J))
    assert K.panel_adj.launches == before + 2


@pytest.mark.parametrize("nD", [4, 11])
@pytest.mark.parametrize("coarse", [None, COARSE[1]])
def test_gram_matvec(dev, nD, coarse):
    rng = np.random.default_rng(2)
    kw = {} if coarse is None else dict(n_J=coarse[0], N=coarse[1],
                                        C=coarse[0])
    panels, cols, inv, n_J = _panels(rng, dev, nD=nD, **kw)
    nD, N, p, _ = panels.shape
    Ln = torch.as_tensor(np.tril(rng.standard_normal((N * p, nD, nD))),
                         device=dev)
    v = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    before = K.gram_matvec.launches
    out = K.gram_matvec(panels, cols, inv, Ln, v)
    assert _rel(out, K.gram_matvec_plain(panels, cols, inv, Ln, v)) <= TOL
    assert _same_bits(out, K.gram_matvec(panels, cols, inv, Ln, v))
    assert K.gram_matvec.launches == before + 2


@pytest.mark.parametrize("spec,p", [(2, 1.0), (1, 2.0), (0, 1.5), (0, 3.0)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_power_cone(dev, mode, spec, p):
    rng = np.random.default_rng(10 * mode + spec)
    m, nD, idx = 1000, 4, (1, 2, 3)
    Dz = rng.standard_normal((m, nD))
    Dz[:, 3] = np.sqrt((Dz[:, 1:3] ** 2).sum(axis=1)) ** p \
        + rng.uniform(1e-3, 1.0, m)
    Dz[:50, 3] = -rng.uniform(0.0, 1.0, 50)     # s < 0
    Dz[50:60, 3] = 0.0                           # s == 0
    Dz[60:80, 3] *= 0.1                          # inside |q|^p: log of < 0
    bw = np.full(m, 1.0 / m)
    bw[40:45] = 0.0                              # masked infeasible nodes
    bw[100:110] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    A = t(np.tile(np.eye(3).reshape(1, 9), (m, 1))
          + 0.01 * rng.standard_normal((m, 9)))
    b = t(0.01 * rng.standard_normal((m, 3)))
    pp, mu = t(np.full(m, p)), t(np.full(m, 0.0 if p <= 2 else 1.0))
    args = (t(Dz), A, b, pp, mu, t(bw), t(rng.standard_normal((m, nD))),
            idx, spec)
    before = K.power_cone_eval.launches
    assert _rel(K.power_cone_eval(mode, *args),
                K.power_cone_plain(mode, *args)) <= TOL
    assert K.power_cone_eval.launches == before + 1


def _tables(m, rng):
    """The piece tables of the zoo and parabolic_solve, and the kernel's
    widest cases, on random grids: name -> (Convex, D rows)."""
    x = np.zeros((m, 2))
    cone, lin = mt.convex_euclidian_power, mt.convex_linear

    def rand_A(n):
        return np.tile(np.eye(n).reshape(1, -1), (m, 1)) \
            + 0.01 * rng.standard_normal((m, n * n))

    return {
        "two_sided_obstacle": (mt.intersect(
            x, cone(x=x, idx=(1, 2, 3), p=2.0),
            lin(x=x, idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
                b=lambda _: np.array([0.1, 1.0]))), 4),
        "rof": (mt.intersect(
            x, cone(x=x, idx=(1, 2, 3), p=1.0),
            cone(x=x, idx=(0, 4), A_grid=rand_A(2),
                 b_grid=0.1 * rng.standard_normal((m, 2)), p=2.0)), 5),
        "p_harmonic": (cone(x=x, idx=(1, 2, 4, 5, 6), A_grid=rand_A(5),
                            p=1.5), 7),
        "parabolic": (mt.intersect(x, cone(x=x, idx=(0, 3), p=2.0),
                                   cone(x=x, idx=(1, 2, 4), p=3.0)), 5),
        # 4 pieces, nc = 4 and ni = 5, nz = 5: over 8 rows, so that the
        # phase-I form (8 + 1 + 3) has the kernel's widest 12 rows
        "four_pieces_widest": (mt.convex_piecewise(
            (lin(x=x, idx=(0, 1, 2, 3, 4),
                 A_grid=rng.standard_normal((m, 20)),
                 b_grid=rng.uniform(2.0, 4.0, (m, 4))),
             cone(x=x, idx=(1, 2, 5, 6, 7), A_grid=rand_A(5), p=1.0),
             cone(x=x, idx=(3, 7), p=2.0),
             lin(x=x, idx=(4,), A=lambda _: np.array([[1.0]]))),
            select_grid=(rng.uniform(size=(m, 4)) < 0.8).astype(float),
            x=x), 8),
    }


TABLES = ["two_sided_obstacle", "rof", "p_harmonic", "parabolic",
          "four_pieces_widest"]


@pytest.mark.parametrize("form", ["barrier", "cobarrier", "phase_one"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("table", TABLES)
def test_node_barrier(dev, table, mode, form):
    """K6 in every mode, as the barrier, the cobarrier (trailing slack) and
    the phase-I barrier (cobarrier + box over 3 component rows), with
    infeasible nodes, masked nodes and pieces switched off."""
    rng = np.random.default_rng(TABLES.index(table))
    m = 1000
    Q, nD = _tables(m, rng)[table]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, nD))
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == POWER})
    Dz[:, s_rows] = rng.uniform(1.0, 3.0, (m, len(s_rows)))  # cones' s
    Dz[:60] *= rng.choice([-4.0, 4.0], (60, nD))        # infeasible nodes
    Dz[60:70, nD - 1] = 0.0
    nu = 3
    co = box = None
    y = Dz
    if form != "barrier":
        y = np.concatenate([Dz, rng.uniform(-0.5, 0.5, (m, 1))], axis=1)
        co = nD + 1
        if form == "phase_one":
            y = np.concatenate([y, rng.uniform(-5.0, 5.0, (m, nu))], axis=1)
            y[:5, co] = 12.0                              # outside the box
            box = (t(np.full(m, 4.0)), t(np.full(m, 10.0)))
    bw = np.full(m, 1.0 / m)
    bw[10:20] = 0.0
    args = tuple(t(a) for a in Q.args)
    sel = args[0] if Q.select else None
    call = (mode, t(y), Q.pieces, args, sel, t(bw),
            t(rng.standard_normal(y.shape)), co, box)
    before = (K.node_barrier.launches, K.node_barrier.co_launches)
    assert _rel(K.node_barrier(*call), K.node_barrier_plain(*call)) <= TOL
    assert K.node_barrier.launches == before[0] + 1
    assert K.node_barrier.co_launches == before[1] + (co is not None)


def test_node_barrier_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(5)
    m = 16
    Q, nD = _tables(m, rng)["rof"]
    args = tuple(torch.as_tensor(a, device=dev) for a in Q.args)
    y = torch.zeros((m, 13), dtype=torch.float64, device=dev)
    ones = torch.ones(m, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="rows exceed"):
        K.node_barrier(0, y, Q.pieces, args, args[0], ones, y)
    y = y[:, :nD]
    with pytest.raises(ValueError, match="cobarrier form"):
        K.node_barrier(0, y, Q.pieces, args, args[0], ones, y,
                       box=(ones, ones))


def _fronts(rng, nk, a, b):
    """SPD fronts (nk, f+1, f+1) with a trailing dump slot, A slightly
    asymmetric (the factor symmetrizes it)."""
    f = a + b
    X = rng.standard_normal((nk, f, 2 * f))
    F = np.zeros((nk, f + 1, f + 1))
    F[:, :f, :f] = X @ X.transpose(0, 2, 1) / f + 0.5 * np.eye(f)
    F[:, :a, :a] += 1e-14 * rng.standard_normal((nk, a, a))
    return F


# (nk, amax, bmax): fem2d_P2 L=5 and L=7 nested-dissection levels
FRONTS = [(64, 73, 16), (32, 3, 24), (1, 31, 1), (7, 1, 18), (4, 91, 190)]


@pytest.mark.parametrize("nk,a,b", FRONTS)
def test_front_factor(dev, nk, a, b):
    rng = np.random.default_rng(a + b)
    F = _fronts(rng, nk, a, b)
    if nk > 1:
        F[1, a // 2, a // 2] = -1e3               # not positive definite
    F = torch.as_tensor(F, device=dev)
    before = K.front_factor.launches
    for out, ref in zip(K.front_factor(F, a, b), K.front_factor_plain(F, a, b)):
        assert _rel(out, ref) <= TOL
    assert K.front_factor.launches == before + 1


def _sweep(rng, dev, nk, a, b):
    """One tree level's factors, dof maps and padded vectors (n_J + 1,):
    assigned dofs distinct with one dump slot (n_J); boundary dofs from a
    shared separator pool (several fronts' updates land on one dof) with a
    dump slot of zero coupling; front 1, where there is one, all NaN, as
    K5a leaves a front that is not positive definite."""
    F = _fronts(rng, nk, a, b)
    Lf = np.linalg.cholesky(F[:, :a, :a])
    U = rng.standard_normal((nk, b, a))
    n_J = nk * a + b + 4
    perm = rng.permutation(n_J)
    adofs = perm[:nk * a].reshape(nk, a)
    adofs[nk // 2, a - 1] = n_J
    bdofs = np.stack([np.sort(rng.choice(perm[nk * a:], b, replace=False))
                      for _ in range(nk)])
    bdofs[0, b - 1] = n_J
    U[0, b - 1] = 0.0
    if nk > 1:
        Lf[1] = U[1] = np.nan
    rows, inc = boundary_incidence(bdofs, n_J)
    v = np.append(rng.standard_normal(n_J), 0.0)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (t(Lf), t(U), t(adofs), t(bdofs), t(rows), t(inc), t(v),
            t(rng.standard_normal((nk, a))))


# FRONTS and the widest fronts of L=7: a = 192, and f = a + b = 279
SWEEP_FRONTS = FRONTS + [(1, 192, 1), (8, 43, 236)]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nk,a,b", SWEEP_FRONTS)
def test_front_solve(dev, nk, a, b, transpose):
    """The fused level sweep against its plain version, forward (y, upd and
    the separator-updated r) and backward (xA and the written x), with the
    NaN front propagating as in the plain version; repeat calls give the
    same bits."""
    rng = np.random.default_rng(a * b)
    Lf, U, adofs, bdofs, rows, inc, v, y = _sweep(rng, dev, nk, a, b)
    before = K.front_solve.launches
    outs = []
    for fwd, bwd in ((K.front_forward, K.front_backward),) * 2 \
            + ((K.front_forward_plain, K.front_backward_plain),):
        w = v.clone()
        if transpose:
            outs.append((bwd(Lf, U, adofs, bdofs, y, w), w))
        else:
            outs.append((*fwd(Lf, U, adofs, w, rows, inc), w))
    assert K.front_solve.launches == before + 2
    for out, again, ref in zip(*outs):
        assert _rel(out, ref) <= TOL
        assert _same_bits(out, again)
    if nk > 1:                                   # the NaN front's slots
        assert torch.isnan(outs[0][0][1][adofs[1] < v.shape[0] - 1]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(3)
    panels, cols, inv, n_J = _panels(rng, dev)
    s = torch.zeros(n_J, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="float64"):
        K.panel_fwd(panels, cols, s)
    with pytest.raises(ValueError, match="devices"):
        K.panel_fwd(panels, cols.cpu(), s.double())
    # K3's C entry refuses an element whose p*nD values of Y exceed its stage
    cols = torch.tensor([[0, 1, 2], [0, 1, 2]], device=dev)
    inv = torch.as_tensor(inverse_incidence(cols.cpu().numpy(), 3), device=dev)
    wide = torch.zeros((4097, 2, 1, 3), dtype=torch.float64, device=dev)
    Y = torch.zeros((2, 4097), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="panel_adj launch failed"):
        K.panel_adj(wide, cols, inv, Y, 3)

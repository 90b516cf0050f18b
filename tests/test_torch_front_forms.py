"""PyTorch port, the large-front forms of K5a ``front_factor`` and K5b
``front_forward``/``front_backward`` on the CPU, where the kernels cannot
run: the shape rule that picks them (``form_of`` in each wrapper, which
passes the form to its C entry), on the nested-dissection plans the solves
build; and
the large forms' blocked orders in plain torch (``csrc/front_factor.cu``:
a left-looking factorization in 64-column panels, right-looking for a
level of one front; ``csrc/front_solve.cu``:
32-row bands forward, 32-column bands backward) against the plain versions
and the JAX x64 front code of ``mgbtpu/ops/ndchol.py`` (cholesky +
triangular_solve + the Schur product; ``nd_factor``/``nd_solve``), 1e-12
relative to the largest entry, with a front that is not positive definite
all NaN in both."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import mgbtpu_torch as mt
from chip_smoke import FEM3D_L4, FEM3D_L5
from mgbtpu.ops import ndchol as NJ
from mgbtpu_torch.ops import ndchol as NT

FF = sys.modules["mgbtpu_torch.kernels.front_factor"]
FS = sys.modules["mgbtpu_torch.kernels.front_solve"]
torch.set_num_threads(1)
TOL = 1e-12

_PLANS: dict = {}


def _problems():
    P2 = lambda L: mt.amg(mt.subdivide(mt.fem2d_P2(), L))  # noqa: E731
    return {
        "fem2d_P2 L=5": lambda: mt.assemble(P2(5), p=1.0, device="cpu"),
        "fem2d_P2 L=7": lambda: mt.assemble(P2(7), p=1.0, device="cpu"),
        "fem2d_P1 L=5": lambda: mt.assemble(
            mt.amg(mt.subdivide(mt.fem2d_P1(), 5)), p=1.0, device="cpu"),
        "two_sided_obstacle L=5": lambda: mt.zoo.two_sided_obstacle(
            P2(5), device="cpu"),
        "fem3d k=3 L=4": lambda: mt.assemble(
            mt.amg(mt.subdivide(mt.fem3d(k=3), 4)), p=1.0, device="cpu"),
    }


def plan_shapes(tag):
    """The (nk, amax, bmax) of the top level's ND plan of the main system
    and of the phase-I system of ``tag`` (host only), as the solves build
    them (``solver/mgb.py:nd_plan``)."""
    if tag not in _PLANS:
        from mgbtpu_torch.solver.levelops import build_panel_ops
        from mgbtpu_torch.solver.mgb import ProblemKernels, nd_plan

        cpu = torch.device("cpu")
        out = []
        for M in _problems()[tag]().M:
            ops = build_panel_ops(M.D_fine, M.nu, M.R_fine[-1],
                                  M.geometry.x.shape[0], cpu)
            nd = nd_plan(M, ops, ProblemKernels.ND_LEAF_ELEMS, cpu)
            out += [(L.nk, L.amax, L.bmax) for L in nd.levels]
        _PLANS[tag] = out
    return _PLANS[tag]


@pytest.mark.parametrize("tag", ["fem2d_P2 L=5", "fem2d_P2 L=7",
                                 "fem2d_P1 L=5", "two_sided_obstacle L=5"])
def test_fem2d_fronts_keep_their_forms(tag):
    """Every front of the fem2d plans (main and phase-I systems; f <= 190)
    takes the one-panel K5a form and the one-block K5b form, as before."""
    shapes = plan_shapes(tag)
    assert max(a + b for _, a, b in shapes) <= 190
    for nk, a, b in shapes:
        assert FF.form_of(nk, a, b) == FF.ONE_PANEL
        assert FS.form_of(nk, a, b) == FS.ONE_BLOCK


def test_fem3d_fronts_take_the_large_forms():
    """Every front of the fem3d k=3 L=4 plan (built here on the host, its
    main system's levels those ``chip_smoke.py`` takes as ``FEM3D_L4``; the
    phase-I system's leaves f = 1,367) and of the L=5 plan (``FEM3D_L5``,
    which ``chip_smoke.py --fem3d-level 5`` checks against the plan it
    builds; ~1 minute of host setup) takes both large forms."""
    shapes = plan_shapes("fem3d k=3 L=4")
    assert shapes[:7] == FEM3D_L4
    for nk, a, b in shapes + FEM3D_L5:
        assert FF.form_of(nk, a, b) == FF.LARGE
        assert FS.form_of(nk, a, b) == FS.LARGE


@pytest.mark.parametrize("nk,a,b,k5a,k5b", [
    (4, 100, 219, 1, 1), (4, 100, 220, 2, 2), (1, 319, 0, 1, 1),
    (1, 320, 0, 2, 2), (3, 1, 400, 2, 2), (2, 700, 91, 2, 2)])
def test_form_rule_edges(nk, a, b, k5a, k5b):
    """The large forms from f = a + b = 320 on, whatever a, b and nk."""
    assert FF.form_of(nk, a, b) == k5a
    assert FS.form_of(nk, a, b) == k5b


# ---------------------------------------------------------------------------
# the large forms' blocked orders in plain torch
# ---------------------------------------------------------------------------

def large_factor(F, a, b, T=64):
    """K5a's large form (``csrc/front_factor.cu``) in plain torch: W =
    [sym(A), B, C] lower, then T-column panels, each its diagonal tile
    factored and its rows below solved against it. More than one front
    (left-looking): a panel's rows first less their products with the
    earlier panels, and S = C - U U' at the end; one front (right-looking):
    each panel's product taken off the trailing lower triangle and the
    whole of S after it. S starts from the whole of C, so C need not be
    symmetric; a front with a pivot that is not > 0 comes back all NaN."""
    nk, f = F.shape[0], a + b
    right = nk == 1
    W = F[:, :f, :f].clone()
    W[:, :a, :a] = (W[:, :a, :a] + W[:, :a, :a].mT) / 2
    W = torch.tril(W)
    W[:, a:f, a:f] = F[:, a:f, a:f]
    bad = torch.zeros(nk, dtype=torch.bool)
    eye = torch.eye(T, dtype=F.dtype)
    for j0 in range(0, a, T):
        c0 = min(j0 + T, a)
        if not right:
            W[:, j0:f, j0:c0] -= W[:, j0:f, :j0] @ W[:, j0:c0, :j0].mT
        Lt, info = torch.linalg.cholesky_ex(W[:, j0:c0, j0:c0])
        bad |= info != 0
        Lt = torch.where(bad[:, None, None], eye[:c0 - j0, :c0 - j0], Lt)
        W[:, j0:c0, j0:c0] = Lt
        X = torch.linalg.solve_triangular(Lt.mT, W[:, c0:f, j0:c0],
                                          upper=True, left=False)
        W[:, c0:f, j0:c0] = X
        if right:
            P = X @ X.mT
            M = torch.tril(P)
            M[:, a - c0:, a - c0:] = P[:, a - c0:, a - c0:]
            W[:, c0:f, c0:f] -= M
    U = W[:, a:f, :a]
    S = W[:, a:f, a:f] if right else W[:, a:f, a:f] - U @ U.mT
    out = [W[:, :a, :a], U, S]
    return [torch.where(bad[:, None, None], float("nan"), t) for t in out]


def band_forward(Lf, U, adofs, r, rows, inc, T=32):
    """K5b's large forward form in plain torch: y by bands of T rows, each
    its products with the bands before it then its diagonal tile's solve;
    upd = U y; the separator update as the plain version's."""
    nk, a = adofs.shape
    rhs = r[adofs]
    y = torch.zeros((nk, a), dtype=r.dtype)
    for j0 in range(0, a, T):
        j1 = min(j0 + T, a)
        s = rhs[:, j0:j1] - torch.einsum("nik,nk->ni", Lf[:, j0:j1, :j0],
                                         y[:, :j0])
        y[:, j0:j1] = torch.linalg.solve_triangular(
            Lf[:, j0:j1, j0:j1], s[:, :, None], upper=False)[:, :, 0]
    upd = torch.einsum("nba,na->nb", U, y)
    flat = torch.cat([upd.reshape(-1), upd.new_zeros(1)])
    acc = r[rows]
    for t in range(inc.shape[1]):
        acc = acc - flat[inc[:, t]]
    r[rows] = acc
    return y, upd


def band_backward(Lf, U, adofs, bdofs, y, x, T=32):
    """K5b's large backward form in plain torch: Lf's columns by bands of T
    from the last, each its columns of U' x_B and Lf' x_A below its tile,
    then its transposed diagonal solve; the dump mask and the write."""
    nk, a = adofs.shape
    xB = x[bdofs]
    xs = torch.zeros((nk, a), dtype=x.dtype)
    for j0 in reversed(range(0, a, T)):
        j1 = min(j0 + T, a)
        s = torch.einsum("nbc,nb->nc", U[:, :, j0:j1], xB) + torch.einsum(
            "nkc,nk->nc", Lf[:, j1:, j0:j1], xs[:, j1:])
        xs[:, j0:j1] = torch.linalg.solve_triangular(
            Lf[:, j0:j1, j0:j1].mT, (y[:, j0:j1] - s)[:, :, None],
            upper=True)[:, :, 0]
    xA = torch.where(adofs < x.shape[0] - 1, xs, torch.zeros_like(xs))
    x[adofs.reshape(-1)] = xA.reshape(-1)
    return xA


def _fronts(nk, a, b, seed):
    """SPD fronts (nk, f+1, f+1) with a trailing dump slot, A slightly
    asymmetric as the assembled fronts are (the factor symmetrizes), C's
    upper triangle perturbed by 1e-3 (S = C - U U' takes C as it is, so a
    form that read one triangle of C would miss the tolerance by far)."""
    rng = np.random.default_rng(seed)
    f = a + b
    X = rng.standard_normal((nk, f, 2 * f))
    F = np.zeros((nk, f + 1, f + 1))
    F[:, :f, :f] = X @ X.transpose(0, 2, 1) / f + 0.5 * np.eye(f)
    F[:, :a, :a] += 1e-14 * rng.standard_normal((nk, a, a))
    F[:, a:f, a:f] += 1e-3 * np.triu(rng.standard_normal((nk, b, b)), 1)
    return F


@jax.jit
def _jax_front(A, Bc, C):
    Lf = jnp.linalg.cholesky(A)
    U = lax.linalg.triangular_solve(Lf, Bc, left_side=False, lower=True,
                                    transpose_a=True)
    return Lf, U, C - jnp.einsum("nba,nca->nbc", U, U)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if not fin.any():
        return 0.0
    return np.abs(got[fin] - ref[fin]).max() / max(np.abs(ref[fin]).max(),
                                                   1e-300)


# the fem3d L=4 plan's levels, nk cut to 3 (front 1 made not positive
# definite where a > 64), two L=5 levels, a front one column past a panel,
# and one front of a = 300 (the right-looking order)
LARGE_FRONTS = [(3, 637, 218), (3, 25, 313), (3, 55, 403), (3, 121, 397),
                (3, 121, 529), (3, 253, 529), (1, 529, 1), (3, 55, 578),
                (3, 121, 866), (3, 65, 300), (1, 300, 200)]


@pytest.mark.parametrize("nk,a,b", LARGE_FRONTS)
def test_large_factor_order_matches_plain_and_jax(nk, a, b):
    """The large form's panel order against ``front_factor_plain`` (the
    NaN pattern included) and JAX's front code (its finite fronts: JAX's
    cholesky leaves a failed front's upper triangle as it is), 1e-12; with
    nk = 3 and a > 64, front 1 is not positive definite in the second panel
    (column 70, or a - 1) and front 2 at column a - 3: each comes back all
    NaN, front 0 finite; Lf's upper triangle is zero."""
    F = _fronts(nk, a, b, seed=a * 3 + b)
    if nk == 3 and a > 64:
        F[1, min(70, a - 1), min(70, a - 1)] = -1e3
        F[2, a - 3, a - 3] = -1e3
    ref = _jax_front(F[:, :a, :a], F[:, a:a + b, :a], F[:, a:a + b, a:a + b])
    T = torch.tensor(F)
    got = large_factor(T, a, b)
    plain = FF.front_factor_plain(T, a, b)
    ok = [0] if nk == 3 and a > 64 else list(range(nk))
    for g, p, r in zip(got, plain, ref):
        assert _rel(g.numpy()[ok], np.asarray(r)[ok]) <= TOL
        assert _rel(g.numpy(), p.numpy()) <= TOL
        assert torch.isfinite(g[0]).all()
        if nk == 3 and a > 64:
            assert torch.isnan(g[1:]).all()
    assert np.all(np.triu(got[0].numpy()[0], 1) == 0.0)


def _sweep_case(nk, a, b, seed):
    """A tree level's factors, dof maps and padded vectors (n_J + 1,):
    assigned dofs distinct with one dump slot; boundary dofs from a shared
    separator pool (several fronts' updates land on one dof), one a dump
    slot with zero coupling."""
    rng = np.random.default_rng(seed)
    F = _fronts(nk, a, b, seed)
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
    r = np.append(rng.standard_normal(n_J), 0.0)
    return Lf, U, adofs, bdofs, r, rng.standard_normal((nk, a)), n_J


@jax.jit
def _jax_forward(Lf, U, adofs, bdofs, r):
    """``nd_solve``'s forward step of one level (mgbtpu/ops/ndchol.py:
    544-549)."""
    y = lax.linalg.triangular_solve(Lf, r[adofs][:, :, None], left_side=True,
                                    lower=True)[:, :, 0]
    upd = jnp.einsum("nba,na->nb", U, y)
    return y, upd, r.at[bdofs].add(-upd)


@jax.jit
def _jax_backward(Lf, U, adofs, bdofs, y, x):
    """``nd_solve``'s backward step of one level (mgbtpu/ops/ndchol.py:
    554-558)."""
    n_J = x.shape[0] - 1
    t = y - jnp.einsum("nba,nb->na", U, x[bdofs])
    xA = lax.linalg.triangular_solve(Lf, t[:, :, None], left_side=True,
                                     lower=True, transpose_a=True)[:, :, 0]
    xA = jnp.where(adofs < n_J, xA, 0.0)
    return xA, x.at[adofs].set(xA)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nk,a,b", [(3, 637, 218), (2, 25, 313),
                                    (2, 253, 529), (1, 529, 1),
                                    (2, 65, 300)])
def test_band_sweeps_match_plain_and_jax(nk, a, b, transpose):
    """The large forms' band orders, forward (y, upd and the separator-
    updated r) and backward (xA and the written x), against the plain
    versions and JAX's level steps, 1e-12."""
    from mgbtpu_torch.ops.ndchol import boundary_incidence

    Lf, U, adofs, bdofs, r, y, n_J = _sweep_case(nk, a, b, seed=a + 7 * b)
    rows, inc = boundary_incidence(bdofs, n_J)
    T = torch.tensor
    args = (T(Lf), T(U), T(adofs))
    v, w = T(r), T(r)
    if not transpose:
        ref = _jax_forward(Lf, U, adofs, bdofs, r)
        got = (*band_forward(*args, v, T(rows), T(inc)), v)
        plain = (*FS.front_forward_plain(*args, w, T(rows), T(inc)), w)
    else:
        ref = _jax_backward(Lf, U, adofs, bdofs, y, r)
        got = (band_backward(*args, T(bdofs), T(y), v), v)
        plain = (FS.front_backward_plain(*args, T(bdofs), T(y), w), w)
    for g, p, rf in zip(got, plain, ref):
        assert _rel(g.numpy(), np.asarray(rf)) <= TOL
        assert _rel(g.numpy(), p.numpy()) <= TOL


def _grid_case(nx, ny, seed=0):
    """P1 triangles on an nx x ny grid with seeded SPD element blocks (the
    dense-oracle case of tests/test_torch_ndchol.py)."""
    rng = np.random.default_rng(seed)
    elems = []
    for i in range(nx):
        for j in range(ny):
            p = i * (ny + 1) + j
            q = (i + 1) * (ny + 1) + j
            elems += [[p, q, p + 1], [q, q + 1, p + 1]]
    t = np.array(elems)
    xy = np.stack([(t // (ny + 1)).mean(axis=1),
                   (t % (ny + 1)).mean(axis=1)], axis=1)
    He = np.zeros((len(t), 3, 3))
    for e in range(len(t)):
        Bm = rng.standard_normal((5, 3))
        He[e] = Bm.T @ Bm + 0.1 * np.eye(3)
    return t, (nx + 1) * (ny + 1), xy, He


@jax.jit
def _jax_factor_solve(dp, He, rhs):
    fact = NJ.nd_factor(dp, He, 1e-12)
    return fact, NJ.nd_solve(dp, fact, rhs)


def test_large_orders_through_nd_factor_and_nd_solve(monkeypatch):
    """The blocked orders as the port's ``nd_factor`` and ``nd_solve`` run
    them on a whole tree (panels and bands of 4 so that the small fronts of
    a 20 x 20 grid take several), against JAX's ``nd_factor``/``nd_solve``
    (1e-10 of the largest entry, the bar of tests/test_torch_ndchol.py)."""
    cols, n, xy, He = _grid_case(20, 20)
    rhs = np.random.default_rng(1).standard_normal(n)
    dj = NJ.NDDevicePlan(NJ.NDPlan(cols, n, xy, leaf_elems=6)).to_device()
    fj, xj = _jax_factor_solve(dj, jnp.asarray(He), jnp.asarray(rhs))
    dt = NT.NDDevicePlan(NT.NDPlan(cols, n, xy, leaf_elems=6)).to_device("cpu")
    assert max(L.amax for L in dt.levels) > 8
    ft = NT.nd_factor(dt, torch.tensor(He), 1e-12,
                      factor=lambda F, a, b: large_factor(F, a, b, T=4))
    assert NT.nd_finite(ft)
    for (Lt, Ut), (Lj, Uj) in zip(ft, fj):
        scale = max(np.abs(np.asarray(Lj)).max(), 1.0)
        assert np.abs(Lt.numpy() - np.asarray(Lj)).max() <= 1e-10 * scale
        if Uj.size:
            assert np.abs(Ut.numpy() - np.asarray(Uj)).max() <= 1e-10 * scale
    monkeypatch.setattr(NT, "front_forward",
                        lambda *a: band_forward(*a, T=4))
    monkeypatch.setattr(NT, "front_backward",
                        lambda *a: band_backward(*a, T=4))
    xt = NT.nd_solve(dt, ft, torch.tensor(rhs)).numpy()
    xj = np.asarray(xj)
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()

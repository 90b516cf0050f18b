"""PyTorch port: K4's cluster-form sum order and ``Convex``'s per-node
barrier callables, on the CPU against the JAX package in float64.

``gram_matvec_cluster_plain`` is the order the card's cluster form sums H v
in (R CTAs an element: P v in K1's split order, each rank's partial of a
slot over its nodes, the partials added in rank order; phase B as
``adjoint.cuh``). For R in {1, 2, 4, 8} it is held to the einsum
``gram_matvec_plain`` and to JAX's x64 ``levelops.gram_matvec`` on seeded
inputs at the fem3d Q3 shapes (p = 64 with nD = 5, C = 128 and nD = 8,
C = 192) and at ``subdivide(fem3d(k=3), 1)``'s top level. Tolerance: each
entry within 2 (C + 2 nD + p nD + K) eps of |P|'|L||L'||P||v| at that entry
(two orders of the same products, each a recursive sum of at most that many
terms), K the most slots a column has.

``Q.barrier[i]`` and ``Q.cobarrier[i]`` of the port, at one node and over
a batch, are held to JAX's callables (one node, and under ``jax.vmap``) to
1e-12 relative to the largest finite entry, with the same non-finite
pattern, for every constructor: linear, euclidian_power at p = 1, 1.5 and
2, piecewise, intersect and the Model torsion's table; F0 is +inf outside
the set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt
import port_models
from mgbtpu.solver.levelops import build_panel_ops as build_ref
from mgbtpu.solver.levelops import gram_matvec as gram_ref
from mgbtpu_torch.interop import from_reference_arrays
from mgbtpu_torch.kernels import gram_matvec_cluster_plain, gram_matvec_plain
from mgbtpu_torch.kernels.gram_matvec import gram_matvec_cluster_contrib_plain
from mgbtpu_torch.solver.levelops import inverse_incidence

torch.set_num_threads(1)
EPS = np.finfo(np.float64).eps
RS = (1, 2, 4, 8)


def _seeded(rng, nD, C, N=3, p=64, n_J=400):
    """N elements of p nodes over n_J columns, as ``build_panel_ops`` lays
    them out (sorted slots, the last repeated with zero panels), seeded
    factors and v."""
    cols = np.zeros((N, C), np.int64)
    panels = rng.standard_normal((nD, N, p, C))
    for e in range(N):
        k = rng.integers(C - C // 4, C + 1)
        c = np.sort(rng.choice(n_J, k, replace=False))
        cols[e, :k] = c
        cols[e, k:] = c[-1]
        panels[:, e, :, k:] = 0.0
    Ln = np.tril(rng.standard_normal((N * p, nD, nD)))
    return panels, cols, Ln, rng.standard_normal(n_J), n_J


def _ref_ops(panels, cols, n_J):
    """JAX's PanelOps over the same panels and columns."""
    from mgbtpu.solver.levelops import PanelOps

    nD, N, p, C = panels.shape
    return PanelOps(cols=jnp.asarray(cols), panels=jnp.asarray(panels),
                    n_nodes=N * p, nD=nD, n_J=n_J, p=p, N=N, C=C)


def _hold(panels, cols, Ln, v, n_J, ref_ops):
    t = torch.as_tensor
    P, c, L, vt = t(panels), t(cols), t(Ln), t(v)
    inv = t(inverse_incidence(cols, n_J))
    nD, N, p, C = panels.shape
    K = inv.shape[1]
    bound = gram_matvec_plain(P.abs(), c, inv, L.abs(), vt.abs()).numpy()
    tol = 2 * (C + 2 * nD + p * nD + K) * EPS * bound
    plain = gram_matvec_plain(P, c, inv, L, vt).numpy()
    jax_out = np.asarray(gram_ref(ref_ops, jnp.asarray(Ln), jnp.asarray(v)))
    assert np.all(np.abs(plain - jax_out) <= tol)
    for R in RS:
        got = gram_matvec_cluster_plain(P, c, inv, L, vt, R).numpy()
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - plain) <= tol), R
        assert np.all(np.abs(got - jax_out) <= tol), R


@pytest.mark.parametrize("nD,C", [(5, 128), (8, 192)])
def test_cluster_order_at_fem3d_shapes(nD, C):
    """The main system's top-level shape (nD = 5, C = 128) and the phase-I
    system's (nD = 8, C = 192), a few elements of p = 64."""
    rng = np.random.default_rng(nD * 1000 + C)
    panels, cols, Ln, v, n_J = _seeded(rng, nD, C)
    _hold(panels, cols, Ln, v, n_J, _ref_ops(panels, cols, n_J))


@pytest.mark.parametrize("p,nD,C", [(7, 4, 13), (3, 11, 14), (64, 13, 10)])
def test_cluster_order_at_ragged_shapes(p, nD, C):
    """R that does not divide p (ranks of floor(r p / R) nodes: empty
    ranks at R = 8 > p = 7 and p = 3), an odd C, wide rows."""
    rng = np.random.default_rng(p + nD + C)
    panels, cols, Ln, v, n_J = _seeded(rng, nD, C, N=5, p=p, n_J=60)
    _hold(panels, cols, Ln, v, n_J, _ref_ops(panels, cols, n_J))


def test_cluster_order_at_fem3d_level():
    """subdivide(fem3d(k=3), 1)'s top level: JAX's panel plan carried into
    the port by ``from_reference_arrays``, seeded factors and v."""
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem3d(k=3), 1)),
                         p=1.0)
    M = pj.M[0]
    oj = build_ref(M.D_fine, M.nu, M.R_fine[-1], 64, np.float64)
    ot = from_reference_arrays(device="cpu", panel_ops=dict(
        cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
        n_J=oj.n_J))["panel_ops"]
    nD, N, p, C = ot.panels.shape
    assert (p, nD) == (64, 5)
    rng = np.random.default_rng(31)
    Ln = np.tril(rng.standard_normal((N * p, nD, nD)))
    v = rng.standard_normal(ot.n_J)
    _hold(ot.panels.numpy(), ot.cols.numpy(), Ln, v, ot.n_J, oj)


def test_cluster_order_is_its_own():
    """The order changes the last bits (R = 1 against R = 8, and both
    against the einsum), and the per-slot sums are those of phase B's
    input: the cluster plain version sums its contributions by ``inv``."""
    rng = np.random.default_rng(7)
    panels, cols, Ln, v, n_J = _seeded(rng, 5, 128)
    t = torch.as_tensor
    P, c, L, vt = t(panels), t(cols), t(Ln), t(v)
    inv = t(inverse_incidence(cols, n_J))
    a = gram_matvec_cluster_plain(P, c, inv, L, vt, 1)
    b = gram_matvec_cluster_plain(P, c, inv, L, vt, 8)
    assert not torch.equal(a, b)
    assert not torch.equal(a, gram_matvec_plain(P, c, inv, L, vt))
    contrib = gram_matvec_cluster_contrib_plain(P, c, L, vt, 8)
    out = torch.zeros(n_J, dtype=torch.float64)
    for j in range(n_J):
        for f in inv[j].tolist():
            if f < contrib.numel():
                out[j] = out[j] + contrib[f]
    assert torch.equal(out, b)


# -- Convex.barrier / cobarrier: JAX's per-node callables -------------------

N_NODES = 40


def _convex_cases(pkg, rng):
    """name -> (Convex, D-row count), the same grids in both packages."""
    x = np.zeros((N_NODES, 2))
    kw = dict(x=x, dtype=np.float64)
    out = {}
    A = rng.standard_normal((N_NODES, 6))
    b = rng.uniform(0.5, 2.0, (N_NODES, 3))
    out["linear"] = (pkg.convex_linear(idx=(0, 2), A_grid=A, b_grid=b,
                                       **kw), 3)
    for p in (1.0, 1.5, 2.0):
        out[f"power_p{p}"] = (pkg.convex_euclidian_power(
            idx=(1, 2, 3), p=p, **kw), 4)
    cone = pkg.convex_euclidian_power(idx=(1, 2), p=2.0, **kw)
    lin = pkg.convex_linear(idx=(0,), A=lambda _: np.array([[1.0]]),
                            b=lambda _: np.array([1.0]), **kw)
    sel = np.ones((N_NODES, 2))
    sel[: N_NODES // 2, 1] = 0.0
    out["piecewise"] = (pkg.convex_piecewise((cone, lin), select_grid=sel,
                                             **kw), 3)
    out["intersect"] = (pkg.intersect(
        x, pkg.convex_euclidian_power(idx=(1, 2, 3), p=2.0, **kw),
        pkg.convex_linear(idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
                          b=lambda _: np.array([0.1, 1.0]), **kw)), 4)
    return out


def _model_table(pkg):
    """The Model torsion's lowered table (a cone nz = 3 over rows (2, 3, 1)
    and a linear block on row 1) at L=1, and its D-row count."""
    mg = pkg.amg(pkg.subdivide(pkg.fem2d_P2(), 1))
    kw = {} if pkg is mgbtpu else dict(device="cpu")
    prob = port_models.torsion(pkg, mg, **kw)[0]._lower()
    return prob.Q, 4


CONVEX = ["linear", "power_p1.0", "power_p1.5", "power_p2.0", "piecewise",
          "intersect", "model_torsion"]


def _pair(name):
    """(JAX's Convex, D-row count, the port's)."""
    if name == "model_torsion":
        return _model_table(mgbtpu) + (_model_table(mt)[0],)
    Qj, nD = _convex_cases(mgbtpu, np.random.default_rng(0))[name]
    Qt, _ = _convex_cases(mt, np.random.default_rng(0))[name]
    return Qj, nD, Qt


def _rows(name, rng, n, nD, extra=0):
    """Rows inside the set at most nodes (the cone's s row large against
    its q rows; torsion's s in (0.3, 0.9), under its bound 1), a quarter
    pushed outside, and ``extra`` slack rows."""
    Y = rng.uniform(-0.3, 0.3, (n, nD + extra))
    if name == "model_torsion":
        Y[:, 1] = rng.uniform(0.3, 0.9, n)
    else:
        Y[:, nD - 1] = rng.uniform(1.0, 2.0, n)
    k = n // 4
    Y[:k, :nD] *= rng.choice([-5.0, 5.0], (k, nD))
    if extra:
        Y[:, nD:] = rng.uniform(0.1, 0.5, (n, extra))
    return Y


def _outside(name, Qt, node, nD):
    """A row outside the set at ``node``: every cone's q rows at 3 and its
    s row at 0.5 (s^(2/p) < |q|^2, s > 0: the barrier's log of a negative
    residual, +inf; the linear case: y = -100 times the first row of its A
    there)."""
    y = np.full(nD, 3.0)
    if name == "linear":
        A = np.asarray(Qt.args[0])[node].reshape(3, 2)
        y[[0, 2]] = -100.0 * A[0]
    else:
        y[{"piecewise": 2, "model_torsion": 1}.get(name, 3)] = 0.5
    return y


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    if fin.any():
        scale = max(np.abs(ref[fin]).max(), 1e-300)
        assert np.abs(got[fin] - ref[fin]).max() <= 1e-12 * scale


@pytest.mark.parametrize("co", [False, True])
@pytest.mark.parametrize("name", CONVEX)
def test_per_node_callables_match_jax(name, co):
    """Q.barrier[i] (Q.cobarrier[i] with a slack row appended) of the
    port at one node and over every node, against JAX's at each node and
    under jax.vmap."""
    Qj, nD, Qt = _pair(name)
    n = np.asarray(Qj.args[0]).shape[0]
    Y = _rows(name, np.random.default_rng(len(name) + co), n, nD, int(co))
    Fj = Qj.cobarrier if co else Qj.barrier
    Ft = Qt.cobarrier if co else Qt.barrier
    assert len(Ft) == 3
    argsj = tuple(np.asarray(a) for a in Qj.args)
    for i in range(3):
        ref = np.asarray(jax.vmap(Fj[i])(*argsj, jnp.asarray(Y)))
        _close(Ft[i](*Qt.args, Y).numpy(), ref)
        _close(Ft[i](*(torch.as_tensor(a) for a in Qt.args),
                     torch.as_tensor(Y)).numpy(), ref)
        for node in (0, n // 4, n - 1):
            rows = [a[node] for a in argsj]
            one = np.asarray(Fj[i](*rows, jnp.asarray(Y[node])))
            got = Ft[i](*(a[node] for a in Qt.args), Y[node]).numpy()
            _close(got, one)
            _close(got, ref[node])


@pytest.mark.parametrize("name", CONVEX)
def test_per_node_value_is_inf_outside(name):
    """F0 is +inf at a point outside the set, one node and batched, as JAX's
    is (tests/test_convex.py:49-55 asks it to be non-finite)."""
    Qj, nD, Qt = _pair(name)
    n = np.asarray(Qj.args[0]).shape[0]
    node = n - 1                     # a piecewise set's pieces all on
    Y = np.tile(_outside(name, Qt, node, nD), (n, 1))
    out = Qt.barrier[0](*Qt.args, Y).numpy()
    assert np.isposinf(out[node])
    assert np.isposinf(Qt.barrier[0](*(a[node] for a in Qt.args),
                                     Y[node]).item())
    ref = np.asarray(Qj.barrier[0](*(np.asarray(a)[node] for a in Qj.args),
                                   jnp.asarray(Y[node])))
    assert np.isposinf(ref)


def test_per_node_callables_take_the_batched_routes():
    """The callables run the batched methods (renamed ``barrier_terms`` and
    ``cobarrier_terms``) with bw = 1 and wc = 0: the same bits."""
    _, nD, Qt = _pair("intersect")
    Y = torch.as_tensor(_rows("intersect", np.random.default_rng(5),
                              N_NODES, nD))
    args = tuple(torch.as_tensor(a) for a in Qt.args)
    ones, zeros = torch.ones(N_NODES, dtype=torch.float64), torch.zeros_like(Y)
    for i in range(3):
        assert _bits(Qt.barrier[i](*args, Y),
                     Qt.barrier_terms(i, args, Y, ones, zeros))
    Yc = torch.cat([Y, torch.full((N_NODES, 1), 0.2, dtype=torch.float64)], 1)
    zc = torch.zeros_like(Yc)
    for i in range(3):
        assert _bits(Qt.cobarrier[i](*args, Yc),
                     Qt.cobarrier_terms(i, args, Yc, ones, zc))


def _bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))

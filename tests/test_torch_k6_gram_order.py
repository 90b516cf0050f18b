"""PyTorch port, K6's runtime-width cone in the Gram order on the CPU.

On the card, K6's wide and table kernels make a runtime-width cone's
Hessian A' Hz A as a Gram product and rank-one terms (``power_cone.
at_h_a_gram``), in an order of their own; ``node_barrier_gram_plain`` is
the plain version of that order, which the card tests hold the kernels to
bit for bit. The CPU path keeps the reference's order
(``node_barrier_plain``). Here:

(a) the Gram order against the reference's in mode 2, as the barrier, the
    cobarrier and the phase-I barrier with the box, on cones of nz = 2
    (inside a table of 17 pieces), 6, 7, 9, 17 and 33, with infeasible
    nodes, masked nodes (bw = 0) and pieces switched off: each finite entry
    within ``gram_order_bound``, (nz^2 + nz + 8) eps (eps = 2^-52) times
    the entry's sum of absolute terms, the terms taken part by part
    (|two_ir|, |4 u_k u_l|, |cv u_k|, |H_ss|). That is the
    recursive-summation bound for two orders of the same products. The
    entries are non-finite exactly where the reference's are, and the two
    orders differ in most entries (the case is live);
(b) modes 0 and 1 give the same bits in both;
(c) the Gram order at nz = 7 and 9 against ``jax.vmap`` of the JAX cone's
    F2, to 1e-13 as ``test_wide_table_matches_jax``;
(d) tables whose pieces all have register instances keep ``at_h_a``'s
    bits in the Gram plain version;
(e) ``at_h_a_gram`` is the scalar transcription of the order written in
    ``csrc/power_cone.cuh`` (``pcw_w_i``, ``pcw_h_ij``), bitwise;
(f) the Gram-order Hessian is bitwise symmetric.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt
from mgbtpu_torch.convex._common import ssum
from mgbtpu_torch.kernels import power_cone as K2

# the module (the package exports the function of the same name)
K6 = importlib.import_module("mgbtpu_torch.kernels.node_barrier")

torch.set_num_threads(1)
N = 24
TOL = 1e-13
FORMS = ("barrier", "cobarrier", "phase_one")


def _rand_A(rng, m, n, scale=0.3):
    return np.tile(np.eye(n).reshape(1, -1), (m, 1)) \
        + scale * rng.standard_normal((m, n * n))


def _table(pkg, name, rng, m=N):
    """name -> (Convex, D rows), from the same seeded grids in either
    package."""
    x = np.zeros((m, 2))
    kw = dict(x=x, dtype=np.float64)
    cone, lin = pkg.convex_euclidian_power, pkg.convex_linear
    if name == "nz2_table":     # 17 pieces: the table kernels
        bounds = [lin(idx=(k % 3,), A=lambda _: np.array([[-1.0]]),
                      b=lambda _, c=k: np.array([3.0 + c]), **kw)
                  for k in range(16)]
        return pkg.intersect(x, cone(idx=(1, 2), A_grid=_rand_A(rng, m, 2),
                                     p=1.0, **kw), *bounds), 3
    nz, ny, p = {"nz6": (6, 8, 2.0), "nz7": (7, 9, 1.5), "nz9": (9, 9, 2.0),
                 "nz17": (17, 33, 1.0), "nz33": (33, 65, 1.5)}[name]
    rows = tuple(int(i) for i in rng.permutation(ny - 1)[:nz - 1]) \
        + (ny - 1,)
    return cone(idx=rows, A_grid=_rand_A(rng, m, nz), p=p, **kw), ny


CASES = ["nz2_table", "nz6", "nz7", "nz9", "nz17", "nz33"]


def _call(mode, form, Q, ny, rng):
    """K6's call in ``form`` on seeded rows: the cones' s rows in (2, 4), a
    quarter of the nodes pushed across a wall, bw = 0 at three nodes, the
    phase-I box with one node outside it."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (N, ny))
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == K6.POWER})
    Dz[:, s_rows] = rng.uniform(2.0, 4.0, (N, len(s_rows)))
    Dz[:N // 4] *= rng.choice([-6.0, 6.0], (N // 4, ny))
    y, co, box = Dz, None, None
    if form != "barrier":
        y = np.concatenate([Dz, rng.uniform(-0.5, 0.5, (N, 1))], axis=1)
        co = ny + 1
        if form == "phase_one":
            y = np.concatenate([y, rng.uniform(-5.0, 5.0, (N, 3))], axis=1)
            y[:2, co] = 12.0                              # outside the box
            box = (t(np.full(N, 4.0)), t(np.full(N, 10.0)))
    bw = np.full(N, 1.0 / N)
    bw[7:10] = 0.0
    args = tuple(t(a) for a in Q.args)
    sel = args[0] if Q.select else None
    if sel is not None:
        sel = sel.clone()
        sel[::5, 0] = 0.0                                 # the cone off
    return (mode, t(y), Q.pieces, args, sel, t(bw),
            t(rng.standard_normal(y.shape)), co, box)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", CASES)
def test_gram_order_within_the_summation_bound(name, form):
    rng = np.random.default_rng(CASES.index(name))
    Q, ny = _table(mt, name, rng)
    call = _call(2, form, Q, ny, rng)
    codes = K6.instance(Q.pieces, 2, call[1].shape[1], call[7],
                        call[8] is not None).codes
    assert K6.CONE_WIDE <= codes[0] < K6.LINEAR_WIDE
    got = K6.node_barrier_gram_plain(*call)
    ref = K6.node_barrier_plain(*call)
    bound = K6.gram_order_bound(*call[1:6], call[7], call[8])
    np.testing.assert_array_equal(torch.isfinite(got), torch.isfinite(ref))
    np.testing.assert_array_equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    err = (got - ref).abs()
    assert bool((err[fin] <= bound[fin]).all()), \
        float((err[fin] / bound[fin].clamp_min(1e-300)).max())
    assert bool((got != ref).any())                       # the orders differ
    assert bool((bound[fin] > 0).any())


@pytest.mark.parametrize("name", ["nz2_table", "nz7", "nz33"])
def test_modes_0_and_1_keep_their_bits(name):
    rng = np.random.default_rng(40 + CASES.index(name))
    Q, ny = _table(mt, name, rng)
    for form in FORMS:
        for mode in (0, 1):
            call = _call(mode, form, Q, ny, rng)
            assert _same_bits(K6.node_barrier_gram_plain(*call),
                              K6.node_barrier_plain(*call))


@pytest.mark.parametrize("name,form", [("nz7", "barrier"),
                                       ("nz9", "cobarrier")])
def test_gram_order_matches_jax(name, form):
    """The JAX cone's F2 (eager ``jax.vmap``: ~5 s at nz = 7, ~11 s at
    nz = 9) against the Gram order, 1e-13 relative to the largest entry."""
    Qj, ny = _table(mgbtpu, name, np.random.default_rng(60))
    Qt, _ = _table(mt, name, np.random.default_rng(60))
    call = _call(2, form, Qt, ny, np.random.default_rng(61))
    y = jnp.asarray(call[1].numpy())
    F = Qj.barrier[2] if form == "barrier" else Qj.cobarrier[2]
    ref = np.asarray(jax.vmap(F)(*Qj.args, y))
    ones, zeros = torch.ones(N, dtype=torch.float64), torch.zeros_like(call[1])
    got = K6.node_barrier_gram_plain(2, call[1], Qt.pieces,
                                     tuple(torch.as_tensor(a)
                                           for a in Qt.args),
                                     None, ones, zeros, call[7]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    err = np.abs(got[fin] - ref[fin]).max()
    assert err <= TOL * max(np.abs(ref[fin]).max(), 1.0)


def _register_tables(rng, m=N):
    x = np.zeros((m, 2))
    cone, lin = mt.convex_euclidian_power, mt.convex_linear
    return {
        "obstacle": (mt.intersect(
            x, cone(x=x, idx=(1, 2, 3), p=2.0),
            lin(x=x, idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
                b=lambda _: np.array([0.1, 1.0]))), 4),
        "rof": (mt.intersect(
            x, cone(x=x, idx=(1, 2, 3), p=1.0),
            cone(x=x, idx=(0, 4), A_grid=_rand_A(rng, m, 2), p=2.0)), 5),
        "nz5": (cone(x=x, idx=(1, 2, 4, 5, 6), A_grid=_rand_A(rng, m, 5),
                     p=1.5), 7),
    }


@pytest.mark.parametrize("name", ["obstacle", "rof", "nz5"])
def test_register_pieces_keep_at_h_a(name):
    rng = np.random.default_rng(70)
    Q, ny = _register_tables(rng)[name]
    for form in FORMS:
        call = _call(2, form, Q, ny, rng)
        inst = K6.instance(Q.pieces, 2, call[1].shape[1], call[7],
                           call[8] is not None)
        assert max(inst.codes) < K6.CONE_WIDE
        assert _same_bits(K6.node_barrier_gram_plain(*call),
                          K6.node_barrier_plain(*call))


def _parts(rng, nz, m=N):
    A = torch.tensor(rng.standard_normal((m, nz * nz)))
    u = [torch.tensor(rng.standard_normal(m)) for _ in range(nz - 1)]
    two_ir, cv, H_ss = (torch.tensor(rng.standard_normal(m))
                        for _ in range(3))
    return A, u, two_ir, cv, H_ss


@pytest.mark.parametrize("nz", [2, 6, 9])
def test_at_h_a_gram_is_the_source_order(nz):
    """pcw_w_i and pcw_h_ij of csrc/power_cone.cuh, transcribed over
    (m,) columns: every product and sum in the source's order."""
    rng = np.random.default_rng(80 + nz)
    A, u, two_ir, cv, H_ss = _parts(rng, nz)
    H, cr = K2.at_h_a_gram(A, u, two_ir, cv, H_ss, nz)
    nq = nz - 1
    a = lambda k, i: A[:, k * nz + i]  # noqa: E731
    w = [ssum([a(k, i) * u[k] for k in range(nq)]) for i in range(nz)]
    for i in range(nz):
        assert torch.equal(cr[:, i], cv * w[i] + H_ss * a(nq, i))
        for j in range(nz):
            g = ssum([a(k, i) * a(k, j) for k in range(nq)])
            h = ((two_ir * g + 4.0 * (w[i] * w[j]))
                 + cv * (w[i] * a(nq, j) + a(nq, i) * w[j])) \
                + H_ss * (a(nq, i) * a(nq, j))
            assert torch.equal(H[:, i, j], h)


@pytest.mark.parametrize("name", ["nz6", "nz17", "nz33"])
def test_gram_hessian_is_bitwise_symmetric(name):
    rng = np.random.default_rng(90 + CASES.index(name))
    A, u, two_ir, cv, H_ss = _parts(rng, int(name[2:]))
    H, _ = K2.at_h_a_gram(A, u, two_ir, cv, H_ss, int(name[2:]))
    assert _same_bits(H, H.transpose(1, 2).contiguous())
    Q, ny = _table(mt, name, rng)
    for form in FORMS:
        out = K6.node_barrier_gram_plain(*_call(2, form, Q, ny, rng))
        assert _same_bits(out, out.transpose(1, 2).contiguous())

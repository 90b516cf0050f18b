"""PyTorch port, convex sets: the per-node barrier F0/F1/F2, cobarrier
C0/C1/C2, phase-I feasibility barrier and slack estimate of
``convex_linear``, ``convex_piecewise`` (a select mask that switches off a
piece where it is infinite), ``intersect`` (the zoo's and the parabolic
solver's piece tables) and the nz=5 power cone with Norton-Hoff's A match
``jax.vmap`` of the JAX constructors on the same seeded grids and points:
<= 1e-13 relative to the largest finite entry, with the identical
non-finite pattern (NaN vs +-inf, entry by entry). On the CPU the port's
barriers are the plain versions of kernels K2 and K6. The cases mirror
``tests/test_convex.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
from mgbtpu.solver.mgb import make_feasibility_fs as feas_ref
from mgbtpu_torch.solver.mgb import make_feasibility_fs

torch.set_num_threads(1)
TOL = 1e-13
N = 64


def _nh_A():
    """Norton-Hoff's packing matrix in 2D (``zoo.norton_hoff``)."""
    A = np.zeros((5, 5))
    A[0, 0] = A[1, 3] = A[4, 4] = 1.0
    A[2, 1] = A[2, 2] = 1.0 / np.sqrt(2.0)
    return A


def _cases(pkg, rng):
    """name -> (Convex, D-row count): each built from the same seeded grids
    in both packages (``pkg`` is mgbtpu or mgbtpu_torch)."""
    x = np.zeros((N, 2))
    kw = dict(x=x, dtype=np.float64)
    out = {}
    A = rng.standard_normal((N, 6))
    b = rng.uniform(0.5, 2.0, (N, 3))
    out["linear"] = (pkg.convex_linear(idx=(0, 2), A_grid=A, b_grid=b, **kw),
                     3)
    out["power_nz5_norton_hoff"] = (pkg.convex_euclidian_power(
        idx=(1, 2, 3, 4, 6), A=lambda _: _nh_A(), p=1.5, **kw), 7)
    cone = pkg.convex_euclidian_power(idx=(1, 2), p=2.0, **kw)
    lin = pkg.convex_linear(idx=(0,), A=lambda _: np.array([[1.0]]),
                            b=lambda _: np.array([1.0]), **kw)
    sel = np.ones((N, 2))
    sel[: N // 2, 1] = 0.0          # piece 2 off on the first half
    out["piecewise_masked"] = (pkg.convex_piecewise(
        (cone, lin), select_grid=sel, **kw), 3)
    # two_sided_obstacle: power p=2 nz=3 + linear nc=2
    out["intersect_obstacle"] = (pkg.intersect(
        x, pkg.convex_euclidian_power(idx=(1, 2, 3), p=2.0, **kw),
        pkg.convex_linear(idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
                          b=lambda _: np.array([0.1, 1.0]), **kw)), 4)
    # rof: p=1 cone and a shifted p=2 cone
    out["intersect_rof"] = (pkg.intersect(
        x, pkg.convex_euclidian_power(idx=(1, 2, 3), p=1.0, **kw),
        pkg.convex_euclidian_power(idx=(0, 4), A=lambda _: np.eye(2),
                                   b=lambda _: np.array([-0.3, 0.0]), p=2.0,
                                   **kw)), 5)
    # parabolic_solve's pair on fem2d_P2 (p = 1.5 for the general power)
    out["intersect_parabolic"] = (pkg.intersect(
        x, pkg.convex_euclidian_power(idx=(0, 3), p=2.0, **kw),
        pkg.convex_euclidian_power(idx=(1, 2, 4), p=1.5, **kw)), 5)
    return out


NAMES = ["linear", "power_nz5_norton_hoff", "piecewise_masked",
         "intersect_obstacle", "intersect_rof", "intersect_parabolic"]


def _pair(name, seed=0):
    Qj, nD = _cases(mgbtpu, np.random.default_rng(seed))[name]
    Qt, _ = _cases(mgbtpu_torch, np.random.default_rng(seed))[name]
    return Qj, Qt, nD


def _points(rng, nD, extra=0):
    """Rows near the sets' walls: most nodes feasible for the cases above,
    a quarter pushed across a wall (some entries then non-finite)."""
    Y = rng.uniform(-0.4, 0.4, (N, nD + extra))
    Y[:, nD - 1] = rng.uniform(1.0, 3.0, N)            # the slack rows s
    Y[:, 3:nD] = np.abs(Y[:, 3:nD]) + 1.0
    k = N // 4
    Y[:k, :nD] *= rng.choice([-4.0, 4.0], (k, nD))     # across the walls
    Y[k:k + 4, nD - 1] = 0.0
    return Y


def _same(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    err = np.abs(got[fin] - ref[fin]).max(initial=0.0)
    assert err <= TOL * max(np.abs(ref[fin]).max(initial=0.0), 1.0)
    return fin


def _t(args):
    return tuple(torch.tensor(np.asarray(a)) for a in args)


def _ones_zeros(Y):
    return (torch.ones(Y.shape[0], dtype=torch.float64),
            torch.zeros(Y.shape, dtype=torch.float64))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_barrier_matches_jax(name, mode):
    Qj, Qt, nD = _pair(name)
    Y = _points(np.random.default_rng(10 + mode), nD)
    ref = np.asarray(jax.vmap(Qj.barrier[mode])(*Qj.args, jnp.asarray(Y)))
    got = Qt.barrier_terms(mode, _t(Qt.args), torch.tensor(Y),
                     *_ones_zeros(Y)).numpy()
    fin = _same(got, ref)
    assert fin.any()
    if mode == 0:               # some points lie outside the set
        assert not fin.all()


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_cobarrier_matches_jax(name, mode):
    Qj, Qt, nD = _pair(name)
    rng = np.random.default_rng(20 + mode)
    Y = _points(rng, nD, extra=1)
    Y[:, nD] = rng.uniform(-0.5, 0.5, N)               # the phase-I slack
    ref = np.asarray(jax.vmap(Qj.cobarrier[mode])(*Qj.args, jnp.asarray(Y)))
    got = Qt.cobarrier_terms(mode, _t(Qt.args), torch.tensor(Y),
                       *_ones_zeros(Y)).numpy()
    fin = _same(got, ref)
    assert fin.any()


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_feasibility_barrier_matches_jax(name, mode):
    """The phase-I barrier: cobarrier + box over (slack u, components v)."""
    Qj, Qt, nD = _pair(name)
    rng = np.random.default_rng(30 + mode)
    nu = 3
    Y = _points(rng, nD, extra=1 + nu)
    Y[:, nD] = rng.uniform(-0.5, 0.5, N)
    Y[:, nD + 1:] = rng.uniform(-5.0, 5.0, (N, nu))
    Y[:3, nD + 1] = 12.0                                # outside the box
    b, R = np.full(N, 4.0), np.full(N, 10.0)
    Fj = feas_ref(Qj.cobarrier, nD + 1)[mode]
    ref = np.asarray(jax.vmap(Fj)(*Qj.args, b, R, jnp.asarray(Y)))
    got = make_feasibility_fs(Qt, nD + 1)(
        mode, _t(Qt.args) + _t((b, R)), torch.tensor(Y),
        *_ones_zeros(Y)).numpy()
    _same(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_slack_matches_jax(name):
    Qj, Qt, nD = _pair(name)
    Y = _points(np.random.default_rng(40), nD)
    ref = np.asarray(jax.vmap(Qj.slack)(*Qj.args, jnp.asarray(Y)))
    got = Qt.slack(_t(Qt.args), torch.tensor(Y)).numpy()
    _same(got, ref)


def test_piecewise_inactive_infinite_piece_is_dropped():
    """Where piece 2 is off, a point that violates it keeps a finite
    barrier, and the slack is piece 1's alone (test_convex.py cases)."""
    _, Qt, _ = _pair("piecewise_masked")
    args = tuple(a[:2] for a in _t(Qt.args))     # piece 2 off at both
    Y = torch.tensor([[-5.0, 0.5, 2.0], [-5.0, 2.0, 1.0]],
                     dtype=torch.float64)       # u = -5 violates piece 2
    ones, zeros = _ones_zeros(Y)
    for mode in (0, 1, 2):
        assert torch.isfinite(Qt.barrier_terms(mode, args, Y, ones, zeros)[0]).all()
    np.testing.assert_allclose(Qt.slack(args, Y)[1].item(), 3.0)
    args_on = (torch.ones_like(args[0]),) + args[1:]
    assert not torch.isfinite(Qt.barrier_terms(0, args_on, Y, ones, zeros)).any()


def test_intersect_is_the_sum_of_its_pieces():
    x = np.zeros((4, 1))
    Q1 = mgbtpu_torch.convex_euclidian_power(x=x, idx=(1, 2), p=2.0)
    Q2 = mgbtpu_torch.convex_linear(x=x, idx=(0,),
                                    A=lambda _: np.array([[1.0]]),
                                    b=lambda _: np.array([1.0]))
    Qi = mgbtpu_torch.intersect(x, Q1, Q2)
    assert [p.offset for p in Qi.pieces] == [1, 5]
    assert Qi.input_spec == ("all", (("atleast", 3), ("atleast", 1)))
    Y = torch.tensor([[0.3, 0.5, 2.0]] * 4)
    ones, zeros = _ones_zeros(Y)
    v = Qi.barrier_terms(0, _t(Qi.args), Y, ones, zeros)
    v1 = Q1.barrier_terms(0, _t(Q1.args), Y, ones, zeros)
    v2 = Q2.barrier_terms(0, _t(Q2.args), Y, ones, zeros)
    torch.testing.assert_close(v, v1 + v2, rtol=1e-15, atol=0)


def test_validate_convex_inputs():
    x = np.zeros((2, 1))
    Qi = mgbtpu_torch.intersect(
        x, mgbtpu_torch.convex_euclidian_power(x=x, idx=(1, 2), p=2.0),
        mgbtpu_torch.convex_linear(x=x, idx=(3,),
                                   A=lambda _: np.array([[1.0]])))
    from mgbtpu_torch.convex import validate_convex_inputs
    validate_convex_inputs(Qi, 4)
    with pytest.raises(ValueError, match="input row 3"):
        validate_convex_inputs(Qi, 3)
    with pytest.raises(ValueError, match="single power cone or linear"):
        mgbtpu_torch.intersect(x, Qi, Qi)

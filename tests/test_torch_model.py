"""PyTorch port, the Model DSL (``mgbtpu_torch/frontends/model.py``) against
``mgbtpu/frontends/model.py`` on the CPU: every case of
``tests/test_model.py`` built by one function that takes either package,
solved by both (JAX x64 and the port's plain path), with the solutions to
1e-8, the Newton counts by ``PERF.md`` §2's rules (``port_parity.same_ramp``:
every ramp step but the last equal, the last within +-4), the statuses equal
and the duals to 1e-8 relative; and the lowering of the elastoplastic
torsion model (``examples/model_dsl.py``, ``chip_smoke.py``'s path (A)) at
L=2, identical to 1e-14. The JAX solves are cached per module."""
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt
import port_models
from port_parity import close, same_ramp

torch.set_num_threads(1)
DEV = "cpu"


def _model(pkg, mg):
    return pkg.Model(mg) if pkg is mgbtpu else pkg.Model(mg, device=DEV)


def _fem1d(pkg, n):
    return pkg.amg(pkg.fem1d(nodes=np.linspace(-1, 1, n)))


def p_laplacian(pkg):
    m = _model(pkg, _fem1d(pkg, 3))
    u = m.variable("u")
    s = m.variable("s", start=2.0)
    m.dirichlet(u, lambda x: x[0])
    m.epigraph(s, [u.dx()], p=1.0)
    m.minimize(s + 0.5 * u)
    return m, {}, {}


def obstacle(pkg):
    m = _model(pkg, _fem1d(pkg, 3))
    u = m.variable("u")
    s = m.variable("s", start=10.0)
    m.dirichlet(u, 0.0)
    m.epigraph(s, [u.dx()], p=2.0)
    lo = m.constrain(u >= -0.1)
    hi = m.constrain(u <= 1.0)
    m.minimize(0.5 * s + 1.0 * u)
    return m, dict(tol=1e-6), dict(lo=lo, hi=hi)


def region_restricted(pkg):
    m = _model(pkg, _fem1d(pkg, 3))
    u = m.variable("u")
    s = m.variable("s", start=10.0)
    m.dirichlet(u, 0.0)
    m.epigraph(s, [u.dx()], p=2.0)
    c = m.constrain(u >= -0.05, where=lambda x: x[0] >= 0)
    m.minimize(0.5 * s + 2.0 * u)
    return m, dict(tol=1e-5), dict(c=c)


def varying_coefficient(pkg):
    m = _model(pkg, _fem1d(pkg, 3))
    u = m.variable("u")
    s = m.variable("s", start=5.0)
    m.dirichlet(u, 0.0)
    cone = m.epigraph(s, [u.dx()], p=2.0)
    m.constrain(u >= -1.0)
    m.constrain(1.0 - u >= 0.0)
    m.minimize(s + u * (lambda x: float(x[0])))
    return m, dict(tol=1e-5), dict(cone=cone)


def equality_reaction(pkg):
    m = _model(pkg, _fem1d(pkg, 9))
    u = m.variable("u")
    s = m.variable("s", start=10.0)
    eq = m.dirichlet(u, 0.0)
    m.epigraph(s, [u.dx()], p=2.0)
    m.minimize(0.5 * s + 1.0 * u)
    return m, dict(tol=1e-8), dict(eq=eq)


def pair_region(pkg):
    mg = _fem1d(pkg, 5)
    m = _model(pkg, mg)
    u = m.variable("u")
    s = m.variable("s", start=10.0)
    m.dirichlet(u, 0.0)
    m.epigraph(s, [u.dx()], p=2.0)
    x = mg.geometry.xflat()
    c = m.constrain(u >= -0.02, where=[i for i in range(len(x))
                                       if x[i, 0] <= 0])
    m.minimize(0.5 * s + 2.0 * u)
    return m, dict(tol=1e-6), dict(c=c)


def warm_start(pkg):
    first, _, _ = p_laplacian(pkg)
    first.solve()
    u1 = first.value(first.variables["u"])
    s1 = first.value(first.variables["s"])
    m = _model(pkg, first.mg)
    u = m.variable("u")
    s = m.variable("s")
    m.dirichlet(u, lambda x: x[0])
    m.epigraph(s, [u.dx()], p=1.0)
    m.minimize(s + 0.5 * u)
    m.set_start(u, u1)
    m.set_start(s, s1 + 1.0)
    return m, {}, {}


def spectral_whole_boundary(pkg):
    m = _model(pkg, pkg.amg(pkg.spectral1d(n=8)))
    u = m.variable("u")
    s = m.variable("s", start=4.0)
    eq = m.dirichlet(u, lambda x: x[0])
    m.epigraph(s, [u.dx()], p=1.0)
    m.minimize(s + 0.5 * u)
    return m, dict(tol=1e-6), dict(eq=eq)


CASES = [p_laplacian, obstacle, region_restricted, varying_coefficient,
         equality_reaction, pair_region, warm_start, spectral_whole_boundary]
# The ramp step from which a case's Newton counts are held to +-1 each and
# +-4 in all (``same_ramp``'s floor_from; default the last step): the fem1d
# golden problem (3 nodes, p_laplacian and its warm start) from its 10th
# step, as tests/test_torch_tensorfem.py holds it; the 9-node equality case
# from its 5th (t = 178.5 of 1e8: steps 5, 6, 10 and 12 of 13 differ by one
# iteration, -2 in all, the solutions by 1.3e-16; ROADMAP Queue 3). From
# there each step's first iteration stops or not on the exact test's
# |g_new| >= theta |g_0|, two gradient norms of ~1e-11 at the roundoff
# floor (tools/trace_newton_stops.py; PERF.md section 7).
FLOOR = {"p_laplacian": 9, "warm_start": 9, "equality_reaction": 4}
_JAX: dict = {}


def _jax(build):
    if build.__name__ not in _JAX:
        m, kw, cons = build(mgbtpu)
        m.solve(**kw)
        _JAX[build.__name__] = (m, cons)
    return _JAX[build.__name__]


def _dual_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-8 * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("build", CASES, ids=lambda b: b.__name__)
def test_model_case_matches_jax(build):
    mj, cj = _jax(build)
    mt_, kw, ct = build(mt)
    sol = mt_.solve(**kw)
    assert mt_.status == mj.status == "optimal"
    assert mt_.mgb_solution() is sol and "mgb_solve" in mt_.solver_log()
    same_ramp(mj.sol, sol, floor_from=FLOOR.get(build.__name__, -1))
    for name, vj in mj.variables.items():
        vt = mt_.variables[name]
        assert np.abs(mt_.value(vt) - mj.value(vj)).max() <= 1e-8 * max(
            np.abs(mj.value(vj)).max(), 1.0)
    oj = mj.objective_value()
    assert abs(mt_.objective_value() - oj) <= 1e-8 * max(abs(oj), 1.0)
    for key in cj:
        _dual_close(mt_.dual(ct[key]), mj.dual(cj[key]))


def infeasible(pkg):
    m = _model(pkg, _fem1d(pkg, 3))
    u = m.variable("u")
    s = m.variable("s", start=5.0)
    m.epigraph(s, [u.dx()], p=2.0)
    m.constrain(u >= 1.0)
    m.constrain(-1.0 * u >= 0.0)
    m.constrain(10.0 - s >= 0.0)
    m.minimize(s + u)
    return m


def test_infeasible_status_matches_jax():
    codes = []
    for pkg in (mgbtpu, mt):
        m = infeasible(pkg)
        with pytest.raises(pkg.MGBConvergenceFailure) as e:
            m.solve()
        codes.append((m.status, e.value.code))
    assert codes[0] == codes[1] == ("infeasible", "infeasible")


def torsion(pkg, L):
    """examples/model_dsl.py's elastoplastic torsion at L
    (``port_models.py``, the description chip_smoke.py solves)."""
    mg = pkg.amg(pkg.subdivide(pkg.fem2d_P2(), L))
    kw = {} if pkg is mgbtpu else dict(device=DEV)
    return port_models.torsion(pkg, mg, **kw)[0]


def test_torsion_lowering_matches_jax():
    """The D table, the piece table (a cone nz = 3 and a linear block
    nc = 1 over nD = 4 rows), the f/g and select grids and the lowered
    hierarchy, identical."""
    from mgbtpu_torch.kernels.node_barrier import LINEAR, POWER

    pj, pt = torsion(mgbtpu, 2)._lower(), torsion(mt, 2)._lower()
    assert pt.M[0].D == pj.M[0].D
    assert pt.M[0].state_variables == pj.M[0].state_variables
    close(pt.f_grid, pj.f_grid)
    close(pt.g_grid, pj.g_grid)
    Qj, Qt = pj.Q, pt.Q
    assert [(p.kind, p.idx, p.width) for p in Qt.pieces] == [
        (POWER, (2, 3, 1), 3), (LINEAR, (1,), 1)]
    assert len(Qt.args) == len(Qj.args)
    for at, aj in zip(Qt.args, Qj.args):
        close(at, aj)
    for Mt, Mj in zip(pt.M, pj.M):
        close(Mt.w, Mj.w)
        for l in range(Mj.depth):
            close(Mt.R_fine[l].toarray(), Mj.R_fine[l].toarray())

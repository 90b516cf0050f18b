"""PyTorch port, the zoo end to end on the CPU: each of the six problems of
``mgbtpu_torch.zoo`` on fem2d_P2 L=2, solved with ``device="cpu"``, matches
the JAX x64 solve of ``mgbtpu.zoo``: the same solution to 1e-8, the same
accepted/attempted ramp steps, and the same Newton iterations per level on
every ramp step but the last. The last one ends in the exact-stopping
``finalize`` polish, whose stop is decided at the objective's roundoff floor
(ROADMAP Queue 3, ``tests/test_torch_solve.py::test_l2``); it is held to
+-4. One problem also starts infeasible (s = 0): both packages run phase I
with the same feasibility iterations. Plus the behavioural checks of
``tests/test_zoo.py`` on the port's solutions."""
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch

torch.set_num_threads(1)
TOL_Z = 1e-8
L = 2
NAMES = ["p_harmonic", "norton_hoff", "rof", "two_sided_obstacle",
         "elastoplastic_torsion", "minimal_surface"]


@pytest.fixture(scope="module")
def meshes():
    mt = mgbtpu_torch
    return (mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)),
            mt.amg(mt.subdivide(mt.fem2d_P2(), L)))


def _solve_both(meshes, name, floor_steps=1, **kw):
    mgj, mgt = meshes
    sj = mgbtpu.mgb_solve(getattr(mgbtpu.zoo, name)(mgj, **kw))
    st = mgbtpu_torch.mgb_solve(
        getattr(mgbtpu_torch.zoo, name)(mgt, device="cpu", **kw),
        device="cpu")
    assert st.z.shape == sj.z.shape
    assert np.linalg.norm(st.z - sj.z) <= TOL_Z * np.linalg.norm(sj.z)
    Sj, St = sj.SOL_main, st.SOL_main
    assert St["steps_accepted"] == Sj["steps_accepted"]
    assert St["steps_attempted"] == Sj["steps_attempted"]
    np.testing.assert_array_equal(St["its"][:, :-floor_steps],
                                  Sj["its"][:, :-floor_steps])
    last_t = int(St["its"][:, -floor_steps:].sum())
    last_j = int(Sj["its"][:, -floor_steps:].sum())
    assert abs(last_t - last_j) <= 4
    return sj, st


@pytest.mark.parametrize("name", NAMES)
def test_zoo_matches_jax(meshes, name):
    sj, st = _solve_both(meshes, name)
    assert st.SOL_feasibility is None and sj.SOL_feasibility is None


def test_obstacle_from_an_infeasible_start(meshes):
    """s = 0 lies on the cone's wall: both packages run phase I through the
    intersected set's cobarrier (K6's plain version here), then the main
    ramp. The last two ramp steps run at the roundoff floor."""
    sj, st = _solve_both(meshes, "two_sided_obstacle", floor_steps=2,
                         s_init=0.0)
    assert st.SOL_feasibility is not None and sj.SOL_feasibility is not None
    assert "entering phase I" in st.log
    np.testing.assert_array_equal(st.SOL_feasibility["its"],
                                  sj.SOL_feasibility["its"])
    np.testing.assert_allclose(st.SOL_main["ts"][0], sj.SOL_main["ts"][0],
                               rtol=1e-12)


def _grad(mgt, u):
    ops = mgt.geometry.operators
    return np.stack([ops["dx"].matvec(u), ops["dy"].matvec(u)], axis=1)


def test_behaviour_of_the_port_solutions(meshes):
    """tests/test_zoo.py's checks, in 2D on the port's solutions: the
    obstacles are respected and reached, the yield bound |grad u| <= smax
    holds, and s^2 >= |grad u|^2 + 1 on the minimal surface."""
    _, mgt = meshes

    def solve(name):
        prob = getattr(mgbtpu_torch.zoo, name)(mgt, device="cpu")
        sol = mgbtpu_torch.mgb_solve(prob, device="cpu", tol=1e-3)
        assert np.all(np.isfinite(sol.z))
        return sol.z

    u = solve("two_sided_obstacle")[:, 0]
    assert u.min() >= -0.1 - 1e-6 and u.max() <= 1.0 + 1e-6
    assert u.min() < -0.09
    du = _grad(mgt, solve("elastoplastic_torsion")[:, 0])
    assert np.sqrt((du ** 2).sum(axis=1)).max() <= 1.0 + 1e-3
    z = solve("minimal_surface")
    du = _grad(mgt, z[:, 0])
    assert np.all(z[:, 1] ** 2 >= (du ** 2).sum(axis=1) + 1 - 1e-3)
    z = solve("rof")
    assert z[:, 0].max() <= 0.5 + 1e-6 and z[:, 0].min() >= -0.5 - 1e-6


def test_zoo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    mg = mgbtpu_torch.amg(mgbtpu_torch.fem2d_P2())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgbtpu_torch.zoo.rof(mg)

"""The plain reference against the program's CPU path at tiny levels of
both elements: the same nodes, weights, derivatives, continuity and
boundary, and a CPU solve that it passes while the control and the planted
faults fail."""
import json
import os

import numpy as np
import pytest

from conftest import ROOT, TINY
from portbench import generator, reference
from portbench.reference import certify
from portbench.tools import readings as tool

CASES = {
    "fem2d_p2_L7": [2, 3],
    "fem3d_q3_L5": [1, 2],
}


def _cfg(name, level):
    with open(os.path.join(ROOT, TINY[name])) as fh:
        cfg = json.load(fh)
    cfg["level"] = level
    return cfg


def _geometry(mt, cfg):
    el = getattr(mt, cfg["element"])(**cfg["element_args"])
    return mt.subdivide(el, cfg["level"])


@pytest.mark.parametrize("name,level", [(n, L) for n, Ls in CASES.items()
                                        for L in Ls])
def test_discretization_equals_the_programs(name, level):
    import mgbtpu_torch as mt

    cfg = _cfg(name, level)
    geo = _geometry(mt, cfg)
    disc = reference.build(cfg)
    assert np.abs(geo.xflat() - disc.x).max() <= 1e-14
    assert np.abs(geo.w - disc.w).max() <= 1e-13 * geo.w.max()
    N, n = disc.elem.shape
    for a, sym in enumerate(["dx", "dy", "dz"][:disc.dim]):
        mine = np.broadcast_to(disc.deriv[a], (N, n, n))
        theirs = geo.operators[sym].data
        assert np.abs(mine - theirs).max() <= 1e-11 * np.abs(theirs).max()
    # the same continuous numbering, up to the names of the ids
    labels = geo.t.reshape(-1, order="F")
    assert len(set(zip(labels.tolist(), disc.dof.tolist()))) \
        == labels.max() + 1 == disc.dof.max() + 1
    # the same Dirichlet nodes
    pairs = mt.find_boundary(geo)
    theirs = np.zeros(disc.n_nodes, dtype=bool)
    theirs[[e * n + v for v, e in pairs]] = True
    assert np.array_equal(theirs, disc.boundary[disc.dof])


@pytest.fixture(scope="module", params=sorted(TINY))
def solved(request):
    import mgbtpu_torch as mt

    name = request.param
    with open(os.path.join(ROOT, TINY[name])) as fh:
        cfg = json.load(fh)
    disc = reference.build(cfg)
    f, g = generator.Mix(generator.load_mix("solve_stream"), disc.x,
                         2 ** 31 + 3).request(generator.Mix.PROBE)
    prob = mt.assemble(mt.amg(_geometry(mt, cfg)), p=1.0, f_grid=f,
                       g_grid=g, device="cpu")
    sol = mt.mgb_solve(prob, device="cpu", tol=cfg["tol"])
    return name, cfg, disc, f, g, np.asarray(sol.z)


def _limits(name):
    with open(os.path.join(ROOT, "portbench", "limits",
                           f"{name}.solve_stream.json")) as fh:
        return json.load(fh)


def test_sound_answer_passes(solved):
    name, cfg, disc, f, g, z = solved
    got = certify.readings(disc, f, g, z, 1 / cfg["tol"])
    for k, lim in _limits(name).items():
        assert got[k] <= lim, (k, got[k], lim)


@pytest.mark.parametrize("fault", ["control", "unchanged", "half",
                                   "altered"])
def test_control_and_faults_fail(solved, fault):
    name, cfg, disc, f, g, z = solved
    zf = tool.faults(disc, z, g, np.random.default_rng(5))[fault]
    got = certify.readings(disc, f, g, zf, 1 / cfg["tol"])
    assert any(got[k] > lim for k, lim in _limits(name).items()), got

"""PyTorch port, the plots (``mgbtpu_torch/plot/``) on the CPU: ``plot``
returns matplotlib Axes for a 1D solution, P1 and P2 triangles, quads and
the fem3d boundary shell (its face colours equal to the JAX package's), and
a ``ParabolicSOL`` animates; ``plot3d_html``'s JSON payload equals the JAX
package's for the same geometry and values (1e-14) on every geometry
family, and it runs without matplotlib where the geometry has triangles or
tensor quads (the card's host has no matplotlib)."""
import json
import re
import sys

import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt

torch.set_num_threads(1)


def _geoms(pkg):
    return {
        "fem1d": pkg.fem1d(nodes=np.linspace(-1, 1, 5)),
        "p1": pkg.subdivide(pkg.fem2d_P1(), 1),
        "p2": pkg.subdivide(pkg.fem2d_P2(), 1),
        "quad": pkg.subdivide(pkg.fem2d(k=2), 1),
        "surface": pkg.fem2d(k=2, K=np.array(
            [[[-1.0, -1.0, 0.0]], [[1.0, -1.0, 0.2]], [[-1.0, 1.0, -0.1]],
             [[1.0, 1.0, 0.3]]]), ambient=3),
        "fem3d": pkg.fem3d(k=2),
        "spectral2d": pkg.spectral2d(n=5),
    }


def _values(g):
    x = g.xflat()
    return np.sin(x[:, 0]) + x[:, -1] ** 2 + 0.5 * x[:, 0] * x[:, -1]


def _payload(path):
    text = open(path).read()
    mesh = json.loads(re.search(r"const MESH=(.*?);\n", text).group(1))
    return text, mesh


@pytest.mark.parametrize("name", ["p1", "p2", "quad", "surface", "fem3d",
                                  "spectral2d"])
def test_plot3d_html_payload_matches_jax(tmp_path, name):
    gj, gt = _geoms(mgbtpu)[name], _geoms(mt)[name]
    z = _values(gt)
    pj = mgbtpu.plot3d_html(gj, str(tmp_path / "j.html"), z=z)
    pt = mt.plot3d_html(gt, str(tmp_path / "t.html"), z=z)
    tj, mj = _payload(pj)
    tt, mtt = _payload(pt)
    assert mtt["t"] == mj["t"]
    for key in ("v", "c"):
        a, b = np.asarray(mtt[key]), np.asarray(mj[key])
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-14
    js = re.search(r"<script>(.*)</script>", tt, re.S).group(1)
    for a, b in (("(", ")"), ("{", "}"), ("[", "]")):
        assert js.count(a) == js.count(b)


def test_plot3d_html_runs_without_matplotlib(tmp_path, monkeypatch):
    """A solve's HTML view where matplotlib cannot be imported, and the same
    file as with it."""
    sol = mt.mgb_solve(mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 1)),
                                   p=2.0, device="cpu"), tol=1e-4,
                       device="cpu")
    with_mpl = open(mt.plot3d_html(sol, str(tmp_path / "a.html"))).read()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    without = open(mt.plot3d_html(sol, str(tmp_path / "b.html"))).read()
    assert without == with_mpl
    assert '"v":' in without and '"t":' in without and '"c":' in without


@pytest.mark.parametrize("name", ["fem1d", "p1", "p2", "quad", "surface",
                                  "fem3d", "spectral2d"])
def test_plot_returns_axes(name):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    g = _geoms(mt)[name]
    ax = mt.plot(g, _values(g))
    assert ax is not None and hasattr(ax, "collections")
    if name in ("fem3d", "surface"):   # per-face colours, as the JAX plot's
        gj = _geoms(mgbtpu)[name]
        axj = mgbtpu.plot(gj, _values(gj))
        fc = np.asarray(ax.collections[0].get_facecolors())
        fj = np.asarray(axj.collections[0].get_facecolors())
        assert fc.shape == fj.shape and fc.shape[1] == 4
        assert np.abs(fc - fj).max() <= 1e-14
    plt.close("all")


def test_plot_of_a_solution_and_a_parabolic_animation():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    mg = mt.amg(mt.fem1d(nodes=np.linspace(-1, 1, 3)))
    sol = mt.mgb_solve(mt.assemble(mg, p=1.0, device="cpu"), device="cpu")
    assert mt.plot(sol) is not None
    psol = mt.parabolic_solve(mg, h=0.5, t0=0.0, t1=1.0, p=1.0, device="cpu")
    html = mt.animation_html(psol)
    assert isinstance(html, str) and ("<video" in html or "<script" in html)
    plt.close("all")

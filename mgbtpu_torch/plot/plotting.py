"""Visualization via matplotlib (direct; the reference routes through PyPlot/
PyVista extensions, ``ext/MultiGridBarrierPyPlotExt``).

- 1D (FEM/spectral): lines through the interpolant
- 2D triangles (P1/P2): trisurf over the triangle fans
- 2D quads / spectral2d: surface over the node cloud (triangulated)
- parabolic solutions: HTML5 <video> animation string or saved file

Port of ``mgbtpu/plot/plotting.py`` on the port's ``MGBSOL``,
``ParabolicSOL`` and geometries. matplotlib is imported only when a plot is
drawn (``_mpl``), so the package imports without it.
"""
from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot(obj, z=None, component=0, ax=None, **kwargs):
    """Plot a Geometry + values, an MGBSOL, or a ParabolicSOL frame.

    Returns the matplotlib Axes (or an animation object for ParabolicSOL).
    """
    from ..solver.mgb import MGBSOL
    from ..solver.parabolic import ParabolicSOL

    if isinstance(obj, ParabolicSOL):
        return animate(obj, component=component, **kwargs)
    if isinstance(obj, MGBSOL):
        geom = obj.geometry
        zz = np.asarray(obj.z)[:, component]
    else:
        geom = obj
        if z is None:
            raise ValueError("plot(geometry, z) needs values z")
        zz = np.asarray(z).reshape(-1)
    return _plot_geom(geom, zz, ax=ax, **kwargs)


def _plot_geom(geom, z, ax=None, **kwargs):
    from ..discretize.spectral import Spectral1D, Spectral2D
    from ..discretize.tensorfem import TensorFEM
    from ..discretize.fem2d_p1 import FEM2DP1
    from ..discretize.fem2d_p2 import FEM2DP2
    from ..utils.interpolate import interpolate

    plt = _mpl()
    disc = geom.discretization
    xf = geom.xflat()
    if ax is None:
        fig = plt.figure()
        is3d = not ((isinstance(disc, TensorFEM) and disc.d == 1 and disc.e == 1)
                    or isinstance(disc, Spectral1D))
        ax = fig.add_subplot(111, projection="3d" if is3d else None)

    if isinstance(disc, Spectral1D) or (isinstance(disc, TensorFEM)
                                        and disc.d == 1 and disc.e == 1):
        ts = np.linspace(xf[:, 0].min(), xf[:, 0].max(), 257)
        ax.plot(ts, interpolate(geom, z, ts), **kwargs)
        ax.plot(xf[:, 0], z, ".", ms=3)
        return ax
    if isinstance(disc, (FEM2DP1, FEM2DP2)):
        V = geom.x.shape[0]
        N = geom.x.shape[1]
        tris = []
        if V == 3:
            fans = [(0, 1, 2)]
        else:  # P2(+bubble) layout c1,m12,c2,m23,c3,m31[,ctr]
            fans = [(0, 1, 5), (1, 2, 3), (3, 4, 5), (1, 3, 5)]
        for e in range(N):
            for f in fans:
                tris.append([e * V + v for v in f])
        ax.plot_trisurf(xf[:, 0], xf[:, 1], z, triangles=tris,
                        cmap=kwargs.pop("cmap", "viridis"), **kwargs)
        return ax
    import matplotlib.tri as mtri

    from ..discretize.tensorfem import TensorFEM

    if isinstance(disc, TensorFEM) and disc.d == 3:
        # volumetric 3D: render the domain boundary colored by the solution
        # (the reference's PyVista path, ext/.../plot3d.jl, draws the same
        # exterior-surface view; matplotlib gets the triangulated shell)
        from matplotlib import colormaps, colors

        tarr = np.asarray(_hex_boundary_tris(geom), dtype=np.int64)
        surf = ax.plot_trisurf(xf[:, 0], xf[:, 1], xf[:, 2],
                               triangles=tarr, **kwargs)
        zt = z[tarr].mean(axis=1)
        norm = colors.Normalize(zt.min(), zt.max() if zt.max() > zt.min()
                                else zt.min() + 1)
        surf.set_fc(colormaps["viridis"](norm(zt)))
        return ax

    # quads / embedded: per-element fan triangulation in broken-node space
    # (quads are V = (k+1)^2 tensor nodes per element; fan each sub-quad)
    tris = _quad_fans(geom)
    if xf.shape[1] >= 3:
        # embedded surface: geometry gives the surface, the solution colors it
        from matplotlib import colormaps, colors

        if tris is None:
            tris = mtri.Triangulation(
                xf[:, 0] + 1e-9 * np.arange(len(z)), xf[:, 1]).triangles
        tarr = np.asarray(tris, dtype=np.int64)
        surf = ax.plot_trisurf(xf[:, 0], xf[:, 1], xf[:, 2],
                               triangles=tarr, **kwargs)
        zt = z[tarr].mean(axis=1)
        norm = colors.Normalize(zt.min(), zt.max() if zt.max() > zt.min()
                                else zt.min() + 1)
        surf.set_fc(colormaps["viridis"](norm(zt)))
        return ax
    if tris is not None:
        ax.plot_trisurf(xf[:, 0], xf[:, 1], z, triangles=tris,
                        cmap=kwargs.pop("cmap", "viridis"), **kwargs)
        return ax
    tri = mtri.Triangulation(xf[:, 0] + 1e-9 * np.arange(len(z)), xf[:, 1])
    ax.plot_trisurf(tri, z, cmap=kwargs.pop("cmap", "viridis"), **kwargs)
    return ax


def _quad_fans(geom):
    """Triangles over the broken nodes of a 2D tensor (quad) geometry: two
    triangles per (k x k) sub-quad of each element; None if not tensor-2D."""
    from ..discretize.tensorfem import TensorFEM

    disc = geom.discretization
    if not (isinstance(disc, TensorFEM) and disc.d == 2):
        return None
    k1 = disc.k + 1
    N = geom.x.shape[1]
    tris = []
    for e in range(N):
        base = e * k1 * k1
        for i in range(disc.k):
            for j in range(disc.k):
                a = base + i * k1 + j
                b, c2, d2 = a + 1, a + k1, a + k1 + 1
                tris.append([a, b, d2])
                tris.append([a, d2, c2])
    return tris


def _hex_boundary_tris(geom):
    """Triangles over the exterior faces of a 3D tensor (hex) geometry.

    Broken nodes are (k+1)^3 per element; a face is exterior iff its set of
    physical node positions appears on exactly one element (interior faces
    are shared by two). Each exterior face is split into 2 triangles per
    (k x k) sub-quad, indices into the broken node array.
    """
    disc = geom.discretization
    k1 = disc.k + 1
    N = geom.x.shape[1]
    xf = geom.xflat()
    # local index grids for the 6 faces of the reference hex (i fast, then
    # j, then l — matching tensorfem's lexicographic broken-node layout)
    idx = np.arange(k1 ** 3).reshape(k1, k1, k1)   # [l, j, i]
    faces_local = [idx[0, :, :], idx[-1, :, :],     # l = 0, k
                   idx[:, 0, :], idx[:, -1, :],     # j = 0, k
                   idx[:, :, 0], idx[:, :, -1]]     # i = 0, k
    face_key = {}
    for e in range(N):
        base = e * k1 ** 3
        for f in faces_local:
            gi = base + f.reshape(-1)
            key = tuple(sorted(map(tuple, np.round(xf[gi], 9).tolist())))
            face_key.setdefault(key, []).append((base, f))
    tris = []
    for key, hits in face_key.items():
        if len(hits) != 1:
            continue  # interior face (shared) — skip
        base, f = hits[0]
        for i in range(disc.k):
            for j in range(disc.k):
                a, b = base + f[i, j], base + f[i, j + 1]
                c2, d2 = base + f[i + 1, j], base + f[i + 1, j + 1]
                tris.append([a, b, d2])
                tris.append([a, d2, c2])
    return tris


def animation_html(psol, component=0, interval=200):
    """HTML string (self-contained JS player) for a ParabolicSOL animation —
    the matplotlib analogue of the reference's HTML5 ``<video>`` return
    (``ext/MultiGridBarrierPyPlotExt/plot3d.jl``)."""
    anim = animate(psol, component=component, interval=interval)
    try:
        return anim.to_html5_video()       # needs ffmpeg
    except Exception:
        return anim.to_jshtml()


def animate(psol, component=0, interval=200):
    """Matplotlib animation of a ParabolicSOL component."""
    plt = _mpl()
    from matplotlib import animation as manim

    fig = plt.figure()
    frames = len(psol.u)

    def draw(i):
        fig.clf()
        is1d = psol.geometry.xflat().shape[1] == 1
        ax = fig.add_subplot(111, projection=None if is1d else "3d")
        _plot_geom(psol.geometry, np.asarray(psol.u[i])[:, component], ax=ax)
        ax.set_title(f"t = {psol.ts[i]:.3f}")

    anim = manim.FuncAnimation(fig, draw, frames=frames, interval=interval)
    return anim


def save_animation(psol, path, component=0, fps=5):  # pragma: no cover
    anim = animate(psol, component=component)
    try:
        anim.save(path, fps=fps)
    except Exception:
        # ffmpeg may be missing; fall back to per-frame PNGs
        plt = _mpl()
        for i in range(len(psol.u)):
            fig = plt.figure()
            ax = fig.add_subplot(111)
            _plot_geom(psol.geometry, np.asarray(psol.u[i])[:, component], ax=ax)
            fig.savefig(f"{path}.{i:03d}.png")
            plt.close(fig)
    return path

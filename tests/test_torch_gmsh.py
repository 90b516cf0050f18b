"""PyTorch port, Gmsh import (``mgbtpu_torch/frontends/gmsh.py``) against
``mgbtpu/frontends/gmsh.py`` on the CPU: every mesh of ``tests/test_gmsh.py``
(ASCII 2.2 and 4.1, binary 4.1, P1 and P2 triangles, Q1 and high-order
quads), a 6-node triangle mesh with and without the bubble, hexes, and a
non-planar quad surface (the embedded branch, ambient 3), imported by both
packages: nodes, weights, connectivity, every operator and the regions
equal to 1e-14, and the same rejections. Also the committed L-shaped mesh
(``mgbtpu_torch/data/lshape_tri6.msh``) imported identically, and the
tri3 solve of ``tests/test_gmsh.py`` on the port against JAX x64 (1e-8)."""
import os
import struct

import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu.frontends.gmsh as GJ
import mgbtpu_torch as mt
import mgbtpu_torch.frontends.gmsh as GT
from port_parity import close
from test_gmsh import MSH22_QUAD, MSH22_TRI, MSH41_TRI

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSHAPE = os.path.join(ROOT, "mgbtpu_torch", "data", "lshape_tri6.msh")


def _lattice_quads(k, z=None):
    """Two order-k quads [0,1]x[0,1] and [1,2]x[0,1] in gmsh's numbering
    (tests/test_gmsh.py's high-order meshes); z(x, y) lifts them off the
    plane."""
    coords = GJ._gmsh_quad_coords(k)
    tag_of = {}
    elems = []
    for ox in (0, 1):
        elems.append([tag_of.setdefault((k * ox + i, j), len(tag_of) + 1)
                      for (i, j) in coords])
    etype = {1: 3, 2: 10, 3: 36, 7: 48}[k]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(len(tag_of))]
    for (i, j), tg in sorted(tag_of.items(), key=lambda kv: kv[1]):
        x, y = i / k, j / k
        lines.append(f"{tg} {x:.17g} {y:.17g} "
                     f"{0.0 if z is None else z(x, y):.17g}")
    lines += ["$EndNodes", "$Elements", str(len(elems))]
    for e, conn in enumerate(elems):
        lines.append(f"{e + 1} {etype} 2 0 1 " + " ".join(map(str, conn)))
    return "\n".join(lines + ["$EndElements"]) + "\n"


def _tri6():
    """Two 6-node triangles of the unit square, one of them clockwise (the
    orientation repair), with a physical line on the bottom edge."""
    return """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
1
1 3 "bottom"
$EndPhysicalNames
$Nodes
9
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
5 0.5 0 0
6 1 0.5 0
7 0.5 0.5 0
8 0 0.5 0
9 0.5 1 0
$EndNodes
$Elements
3
1 8 2 3 1 1 2 5
2 9 2 0 1 1 2 3 5 6 7
3 9 2 0 1 1 4 3 8 9 7
$EndElements
"""


def _hex(order):
    """One hexahedron of [0,1]^3 in gmsh's corner order (hex8), or its
    27-node form (gmsh's hex27 positions, tests of the reorder table)."""
    if order == 1:
        pos = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
               (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
        etype = 5
    else:
        pos = [tuple((c + 1) / 2 for c in GJ._HEX27_GMSH_POS[g])
               for g in range(27)]
        etype = 12
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(len(pos))]
    lines += [f"{i + 1} {x:.17g} {y:.17g} {z:.17g}"
              for i, (x, y, z) in enumerate(pos)]
    lines += ["$EndNodes", "$Elements", "1",
              f"1 {etype} 2 0 1 " + " ".join(str(i + 1)
                                            for i in range(len(pos))),
              "$EndElements"]
    return "\n".join(lines) + "\n"


def _binary41():
    """tests/test_gmsh.py's binary v4.1 triangle."""
    buf = b"$MeshFormat\n4.1 1 8\n" + struct.pack("<i", 1)
    buf += b"\n$EndMeshFormat\n$Entities\n" + struct.pack("<4q", 0, 0, 1, 0)
    buf += struct.pack("<i", 1) + struct.pack("<6d", 0, 0, 0, 1, 1, 0)
    buf += struct.pack("<q", 1) + struct.pack("<i", 5) + struct.pack("<q", 0)
    buf += b"\n$EndEntities\n$Nodes\n" + struct.pack("<4q", 1, 3, 1, 3)
    buf += struct.pack("<iiiq", 2, 1, 0, 3) + struct.pack("<3q", 1, 2, 3)
    buf += struct.pack("<9d", 0, 0, 0, 1, 0, 0, 0, 1, 0)
    buf += b"\n$EndNodes\n$Elements\n" + struct.pack("<4q", 1, 1, 1, 1)
    buf += struct.pack("<iiiq", 2, 1, 2, 1) + struct.pack("<4q", 1, 1, 2, 3)
    return buf + b"\n$EndElements\n"


MESHES = {
    "msh22_tri": MSH22_TRI, "msh22_quad": MSH22_QUAD, "msh41_tri": MSH41_TRI,
    "quad9": _lattice_quads(2), "quad16": _lattice_quads(3),
    "quad64": _lattice_quads(7), "tri6": _tri6(),
    "surface": _lattice_quads(2, z=lambda x, y: 0.25 * x * x - 0.1 * y),
    "hex8": _hex(1), "hex27": _hex(2), "binary41": _binary41(),
}


def _write(tmp_path, name, body):
    p = tmp_path / f"{name}.msh"
    if isinstance(body, bytes):
        p.write_bytes(body)
    else:
        p.write_text(body)
    return str(p)


def _same_import(oj, ot):
    gj, gt = oj.geometry, ot.geometry
    assert type(gt.discretization).__name__ == \
        type(gj.discretization).__name__
    close(gt.x, gj.x)
    close(gt.w, gj.w)
    np.testing.assert_array_equal(gt.t, gj.t)
    assert sorted(gt.operators) == sorted(gj.operators)
    for k, op in gj.operators.items():
        close(gt.operators[k].data, op.data)
    assert ot.regions == oj.regions


@pytest.mark.parametrize("bubble", [True, False])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_import_matches_jax(tmp_path, name, bubble):
    path = _write(tmp_path, name, MESHES[name])
    oj = GJ.gmsh_import(path, bubble=bubble)
    ot = GT.gmsh_import(path, bubble=bubble)
    _same_import(oj, ot)
    if name == "surface":        # non-planar quads: the embedded branch
        d = ot.geometry.discretization
        assert isinstance(d, mt.discretize.TensorFEM)
        assert ot.geometry.x.shape[2] == 3 and (d.d, d.e) == (2, 3)


def test_lshape_imports_identically():
    oj, ot = GJ.gmsh_import(LSHAPE), GT.gmsh_import(LSHAPE)
    _same_import(oj, ot)
    assert ot.geometry.x.shape == (7, 1536, 2)
    assert {k: len(v) for k, v in ot.regions.items()} == {
        "boundary": 506, "domain": 9216}
    assert abs(ot.geometry.w.sum() - 3.0) < 1e-13


REJECT = {
    "serendipity": MSH22_QUAD.replace("1 3 0 1 2 5 4", "1 16 0 1 2 5 4 1 2 5 4")
    .replace("2 3 0 2 3 6 5", "2 16 0 2 3 6 5 2 3 6 5"),
    "tetrahedra": _hex(1).replace("1 5 2 0 1 1 2 3 4 5 6 7 8",
                                  "1 4 2 0 1 1 2 3 5"),
    "mixed element types": MSH22_QUAD.replace("2 3 0 2 3 6 5",
                                              "2 2 0 2 3 6"),
    "no mesh elements": MSH22_TRI.replace("1 1 2 10 1 1 4\n", "")
    .replace("2 2 2 20 1 1 2 4\n", "").replace("3 2 2 20 1 2 3 4\n", "")
    .replace("$Elements\n3", "$Elements\n0"),
    "not a Gmsh": "a mesh of nothing\n",
}


@pytest.mark.parametrize("what", sorted(REJECT))
def test_rejections_match_jax(tmp_path, what):
    path = _write(tmp_path, "r", REJECT[what])
    msgs = []
    for imp in (GJ.gmsh_import, GT.gmsh_import):
        with pytest.raises(ValueError, match=what) as e:
            imp(path)
        msgs.append(str(e.value).replace(path, ""))
    assert msgs[0] == msgs[1]


def test_tri3_solve_matches_jax(tmp_path):
    """tests/test_gmsh.py's tri3 import and solve on both packages."""
    path = _write(tmp_path, "t", MSH22_TRI)
    sj = mgbtpu.mgb_solve(mgbtpu.assemble(
        mgbtpu.amg(GJ.gmsh_import(path).geometry), p=1.0), tol=1e-4)
    st = mt.mgb_solve(mt.assemble(mt.amg(GT.gmsh_import(path).geometry),
                                  p=1.0, device="cpu"), tol=1e-4,
                      device="cpu")
    zj = np.asarray(sj.z)
    assert np.linalg.norm(st.z - zj) <= 1e-8 * np.linalg.norm(zj)

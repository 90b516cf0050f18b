"""Gmsh mesh import: a native .msh parser (ASCII v2.2 and v4.1).

Port of ``mgbtpu/frontends/gmsh.py`` (numpy only, a copy of its parsers,
reorder tables and resampling) that builds the port's geometries:
``fem2d_P1``, ``fem2d_P2``, ``fem2d`` (embedded surfaces included) and
``fem3d``.

Reads the highest-dimensional elements of a Gmsh mesh, chooses the matching
FEM family, reorders nodes into the tensor/triangle local layouts, builds
exact connectivity from the Gmsh node tags, and converts every physical
group into a (vertex, element) node-pair list — the same format as
``find_boundary``, so it feeds ``amg(dirichlet_nodes=...)`` directly.
Capability parity with reference ``ext/MultiGridBarrierGmshExt`` (family
table in its header comment); unlike the reference this does not require the
gmsh library — the MSH file format is parsed directly.

Family selection (single element type required):
    3-node triangles   -> fem2d_P1
    6-node triangles   -> fem2d_P2 (bubble synthesized at the barycenter
                          image by default; bubble=False imports pure P2)
    4/9-node quads     -> fem2d, order 1/2 (non-planar -> embedded surface)
    8/27-node hexes    -> fem3d, order 1/2

High-order (order >= 3) full-Lagrange tensor elements are supported at
every order Gmsh defines (quads to order 10, hexes to order 9): Gmsh
stores equispaced nodes, which are resampled exactly onto the
Chebyshev-Lobatto reference lattice via 1D Lagrange evaluation — the same
resampling the reference performs with getJacobians
(ext/MultiGridBarrierGmshExt, high-order handling).

Rejected with actionable messages: serendipity elements (8-node quads,
20-node hexes, incomplete high-order types), P3+ triangles, tetrahedra,
prisms, pyramids, mixed meshes.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

# gmsh element type -> (family, nodes, dim)
_TYPES = {
    1: ("line2", 2, 1), 8: ("line3", 3, 1), 15: ("point", 1, 0),
    2: ("tri3", 3, 2), 9: ("tri6", 6, 2), 21: ("tri10", 10, 2),
    3: ("quad4", 4, 2), 10: ("quad9", 9, 2), 16: ("quad8", 8, 2),
    4: ("tet4", 4, 3), 11: ("tet10", 10, 3),
    5: ("hex8", 8, 3), 12: ("hex27", 27, 3), 17: ("hex20", 20, 3),
    6: ("prism6", 6, 3), 7: ("pyr5", 5, 3),
    # high-order tensor elements (full Lagrange): quad (k+1)^2, hex (k+1)^3,
    # line k+1 — every order gmsh defines (GmshDefines.h type numbers)
    26: ("line4", 4, 1), 27: ("line5", 5, 1), 28: ("line6", 6, 1),
    62: ("line7", 7, 1), 63: ("line8", 8, 1), 64: ("line9", 9, 1),
    65: ("line10", 10, 1), 66: ("line11", 11, 1),
    36: ("quad16", 16, 2), 37: ("quad25", 25, 2), 38: ("quad36", 36, 2),
    47: ("quad49", 49, 2), 48: ("quad64", 64, 2), 49: ("quad81", 81, 2),
    50: ("quad100", 100, 2), 51: ("quad121", 121, 2),
    92: ("hex64", 64, 3), 93: ("hex125", 125, 3), 94: ("hex216", 216, 3),
    95: ("hex343", 343, 3), 96: ("hex512", 512, 3), 97: ("hex729", 729, 3),
    98: ("hex1000", 1000, 3),
}

_REJECT = {
    "quad8": "8-node serendipity quads are not supported; remesh with full "
             "9-node quads (gmsh: Mesh.SecondOrderIncomplete = 0)",
    "hex20": "20-node serendipity hexes are not supported; remesh with full "
             "27-node hexes (gmsh: Mesh.SecondOrderIncomplete = 0)",
    "tri10": "P3+ triangles are not supported; use P1/P2 triangles or "
             "tensor quads",
    "tet4": "tetrahedra are not supported; mesh with hexahedra",
    "tet10": "tetrahedra are not supported; mesh with hexahedra",
    "prism6": "prisms are not supported; mesh with hexahedra",
    "pyr5": "pyramids are not supported; mesh with hexahedra",
}


def _parse_msh(path):
    """Parse a .msh file (ASCII v2.2 / v4.1, or binary v4.1) ->
    (nodes: {tag: xyz}, elements: [(etype, phys, nodetags)],
    physical names {(dim, id): name})."""
    with open(path, "rb") as f:
        raw = f.read()
    head = raw[:256].decode("latin-1", "replace")
    if "$MeshFormat" in head:
        fmt = head.split("$MeshFormat")[1].strip().split("\n")[0].split()
        if len(fmt) >= 2 and fmt[1] == "1":
            if not fmt[0].startswith("4"):
                raise ValueError(f"{path}: binary MSH v{fmt[0]} is not "
                                 "supported (only v4.1 binary and ASCII)")
            return _parse_msh41_binary(raw)
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    version = None
    nodes = {}
    elements = []
    physnames = {}
    ent_phys = {}   # (dim, entity_tag) -> [physical ids]

    n = len(lines)
    while i < n:
        s = lines[i].strip()
        if s == "$MeshFormat":
            version = float(lines[i + 1].split()[0])
            i += 3
        elif s == "$PhysicalNames":
            cnt = int(lines[i + 1])
            for j in range(cnt):
                parts = lines[i + 2 + j].split(maxsplit=2)
                physnames[(int(parts[0]), int(parts[1]))] = \
                    parts[2].strip().strip('"')
            i += cnt + 3
        elif s == "$Entities" and version >= 4:
            counts = [int(x) for x in lines[i + 1].split()]
            j = i + 2
            for dim, cnt in enumerate(counts):
                for _ in range(cnt):
                    parts = lines[j].split()
                    tag = int(parts[0])
                    off = 4 if dim == 0 else 7
                    nph = int(parts[off])
                    ent_phys[(dim, tag)] = [int(x)
                                            for x in parts[off + 1:off + 1 + nph]]
                    j += 1
            i = j
        elif s == "$Nodes":
            if version >= 4:
                hdr = lines[i + 1].split()
                nblocks = int(hdr[0])
                j = i + 2
                for _ in range(nblocks):
                    _, _, _, nn = (int(x) for x in lines[j].split())
                    tags = [int(lines[j + 1 + q]) for q in range(nn)]
                    for q in range(nn):
                        xyz = [float(x) for x in lines[j + 1 + nn + q].split()]
                        nodes[tags[q]] = np.array(xyz[:3])
                    j += 1 + 2 * nn
                i = j
            else:
                nn = int(lines[i + 1])
                for q in range(nn):
                    parts = lines[i + 2 + q].split()
                    nodes[int(parts[0])] = np.array(
                        [float(x) for x in parts[1:4]])
                i += nn + 3
        elif s == "$Elements":
            if version >= 4:
                hdr = lines[i + 1].split()
                nblocks = int(hdr[0])
                j = i + 2
                for _ in range(nblocks):
                    edim, etag, etype, ne = (int(x) for x in lines[j].split())
                    phys = ent_phys.get((edim, etag), [])
                    for q in range(ne):
                        parts = [int(x) for x in lines[j + 1 + q].split()]
                        elements.append((etype, phys, parts[1:]))
                    j += 1 + ne
                i = j
            else:
                ne = int(lines[i + 1])
                for q in range(ne):
                    parts = [int(x) for x in lines[i + 2 + q].split()]
                    etype, ntags = parts[1], parts[2]
                    tags = parts[3:3 + ntags]
                    phys = tags[:1] if ntags else []
                    elements.append((etype, phys, parts[3 + ntags:]))
                i += ne + 3
        else:
            i += 1
    if version is None:
        raise ValueError(f"{path}: not a Gmsh .msh file (no $MeshFormat)")
    return nodes, elements, physnames


def _parse_msh41_binary(raw: bytes):
    """Binary MSH v4.1: section headers are ASCII lines, section payloads
    are little/big-endian packed (size_t = 8 bytes)."""
    import struct

    # endianness probe: the int 1 right after the "4.1 1 8" line
    i = raw.index(b"$MeshFormat")
    j = raw.index(b"\n", i) + 1
    j = raw.index(b"\n", j) + 1          # skip the "4.1 1 8" line
    one = struct.unpack_from("<i", raw, j)[0]
    en = "<" if one == 1 else ">"

    def find(section):
        tag = b"$" + section
        k = raw.find(tag)
        if k < 0:
            return None
        return raw.index(b"\n", k) + 1

    nodes = {}
    elements = []
    physnames = {}
    ent_phys = {}

    k = find(b"PhysicalNames")
    if k is not None:
        end = raw.index(b"$EndPhysicalNames")
        for line in raw[k:end].decode().strip().splitlines()[1:]:
            parts = line.split(maxsplit=2)
            physnames[(int(parts[0]), int(parts[1]))] = \
                parts[2].strip().strip('"')

    k = find(b"Entities")
    if k is not None:
        np_, nc, ns, nv = struct.unpack_from(en + "4q", raw, k)
        k += 32
        for dim, cnt in enumerate((np_, nc, ns, nv)):
            for _ in range(cnt):
                tag = struct.unpack_from(en + "i", raw, k)[0]
                k += 4
                k += 24 if dim == 0 else 48          # xyz or bbox doubles
                nph = struct.unpack_from(en + "q", raw, k)[0]
                k += 8
                phys = struct.unpack_from(en + f"{nph}i", raw, k)
                k += 4 * nph
                ent_phys[(dim, tag)] = list(phys)
                if dim > 0:
                    nb = struct.unpack_from(en + "q", raw, k)[0]
                    k += 8 + 4 * nb

    k = find(b"Nodes")
    if k is not None:
        nblocks, nn_total, _, _ = struct.unpack_from(en + "4q", raw, k)
        k += 32
        for _ in range(nblocks):
            dim, etag, par, nn = struct.unpack_from(en + "iiiq", raw, k)
            k += 20
            tags = struct.unpack_from(en + f"{nn}q", raw, k)
            k += 8 * nn
            xyz = struct.unpack_from(en + f"{3 * nn}d", raw, k)
            k += 24 * nn
            for q in range(nn):
                nodes[tags[q]] = np.array(xyz[3 * q:3 * q + 3])

    k = find(b"Elements")
    if k is not None:
        nblocks, ne_total, _, _ = struct.unpack_from(en + "4q", raw, k)
        k += 32
        for _ in range(nblocks):
            edim, etag, etype, ne = struct.unpack_from(en + "iiiq", raw, k)
            k += 20
            phys = ent_phys.get((edim, etag), [])
            nper = _TYPES.get(etype, (None, 0, 0))[1]
            if nper == 0:
                raise ValueError(
                    f"binary msh: unsupported element type {etype}")
            for _ in range(ne):
                vals = struct.unpack_from(en + f"{1 + nper}q", raw, k)
                k += 8 * (1 + nper)
                elements.append((etype, phys, list(vals[1:])))
    return nodes, elements, physnames


def _gmsh_quad_coords(k):
    """(i, j) lattice coordinates (0..k per axis) in gmsh's recursive
    numbering for an order-k quadrangle: corners ccw, edge nodes along each
    edge, then the interior numbered as an order-(k-2) quad."""
    if k == 0:
        return [(0, 0)]
    out = [(0, 0), (k, 0), (k, k), (0, k)]
    if k == 1:
        return out
    out += [(i, 0) for i in range(1, k)]
    out += [(k, j) for j in range(1, k)]
    out += [(i, k) for i in range(k - 1, 0, -1)]
    out += [(0, j) for j in range(k - 1, 0, -1)]
    for (i, j) in _gmsh_quad_coords(k - 2):
        out.append((i + 1, j + 1))
    return out


_HEX_CORNERS = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
_HEX_EDGES = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (3, 2),
              (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (7, 6)]
_HEX_FACES = [(0, 3, 2, 1), (0, 1, 5, 4), (0, 4, 7, 3),
              (1, 2, 6, 5), (2, 3, 7, 6), (4, 5, 6, 7)]


def _gmsh_hex_coords(k):
    """(i, j, m) lattice coordinates in gmsh's recursive numbering for an
    order-k hexahedron: 8 corners, 12 edges, 6 faces (each a recursive
    order-(k-2) quad in the face's (corner0->corner1, corner0->corner3)
    frame), then the interior as a recursive order-(k-2) hex."""
    import numpy as _np

    C = [tuple(k * c for c in p) for p in _HEX_CORNERS]
    if k == 0:
        return [(0, 0, 0)]
    out = list(C)
    if k == 1:
        return out
    for a, b in _HEX_EDGES:
        pa, pb = _np.array(C[a]), _np.array(C[b])
        for q in range(1, k):
            out.append(tuple((pa + (pb - pa) * q // k).tolist()))
    for c0, c1, c2, c3 in _HEX_FACES:
        p0 = _np.array(C[c0])
        du = (_np.array(C[c1]) - p0) // k
        dv = (_np.array(C[c3]) - p0) // k
        for (u, v) in _gmsh_quad_coords(k - 2):
            pos = p0 + du * (u + 1) + dv * (v + 1)
            out.append(tuple(pos.tolist()))
    for (i, j, m) in _gmsh_hex_coords(k - 2):
        out.append((i + 1, j + 1, m + 1))
    return out


def _tensor_order_table(coords, k, dim):
    """gmsh-order lattice coords -> reorder table: table[tensor_slot] =
    gmsh position index (tensor slot = i + s*j (+ s^2*m), axis-1 fastest)."""
    s = k + 1
    pos = {}
    for g, c in enumerate(coords):
        if dim == 2:
            pos[c[0] + s * c[1]] = g
        else:
            pos[c[0] + s * c[1] + s * s * c[2]] = g
    return [pos[i] for i in range(s ** dim)]


def _cheb_resample_matrix(k, dtype):
    """1D Lagrange evaluation matrix E with E[i, j] = L_j^{equispaced}(x_i)
    at the Chebyshev-Lobatto nodes x_i: resamples gmsh's equispaced
    high-order nodal coordinates onto the TensorFEM reference nodes (exact
    for the polynomial geometry map; the reference resamples via
    getJacobians, ext/MultiGridBarrierGmshExt)."""
    from ..discretize.tensorfem import cheb_lobatto_nodes

    eq = np.linspace(-1.0, 1.0, k + 1)
    xc = cheb_lobatto_nodes(k, dtype=np.float64)
    E = np.ones((k + 1, k + 1))
    for j in range(k + 1):
        for m in range(k + 1):
            if m != j:
                E[:, j] *= (xc - eq[m]) / (eq[j] - eq[m])
    return E.astype(dtype)


# Local-node reorder tables: gmsh order -> mgbtpu order.
# hexes: gmsh hex8 corner order -> tensor (-,-,-),(+,-,-),(-,+,-),(+,+,-),...
_HEX8 = [0, 1, 3, 2, 4, 5, 7, 6]
# gmsh hex27: 8 corners, 12 edges, 6 faces, 1 volume (gmsh doc order)
_HEX27_GMSH_POS = {
    0: (-1, -1, -1), 1: (1, -1, -1), 2: (1, 1, -1), 3: (-1, 1, -1),
    4: (-1, -1, 1), 5: (1, -1, 1), 6: (1, 1, 1), 7: (-1, 1, 1),
    8: (0, -1, -1), 9: (-1, 0, -1), 10: (-1, -1, 0), 11: (1, 0, -1),
    12: (1, -1, 0), 13: (0, 1, -1), 14: (1, 1, 0), 15: (-1, 1, 0),
    16: (0, -1, 1), 17: (-1, 0, 1), 18: (1, 0, 1), 19: (0, 1, 1),
    20: (0, 0, -1), 21: (0, -1, 0), 22: (-1, 0, 0), 23: (1, 0, 0),
    24: (0, 1, 0), 25: (0, 0, 1), 26: (0, 0, 0),
}


def _hex27_table():
    out = [None] * 27
    for g, pos in _HEX27_GMSH_POS.items():
        i = (pos[0] + 1) + 3 * (pos[1] + 1) + 9 * (pos[2] + 1)
        out[i] = g
    return out


_HEX27 = _hex27_table()

# triangle flip (orientation repair): c1, e31, c3, e23, c2, e12
_TRI6_FLIP = [0, 5, 4, 3, 2, 1]
_TRI3_FLIP = [0, 2, 1]


def _flip_axis1(idx_order, s, d):
    """Reverse tensor axis 1 of a local (s^d) ordering (orientation fix)."""
    out = []
    grid = np.arange(s ** d).reshape([s] * d, order="F")
    flipped = np.flip(grid, axis=0)
    perm = flipped.reshape(-1, order="F")
    return [idx_order[p] for p in perm]


def gmsh_import(path, *, bubble=True, dtype=np.float64):
    """Import a .msh file -> SimpleNamespace(geometry, regions).

    ``regions`` maps each physical-group name (or "dim<d>_<id>" when
    unnamed) to a list of (vertex, element) pairs into the volume mesh —
    pass them to ``amg(geom, dirichlet_nodes={...})``.
    """
    from ..discretize import fem2d, fem3d, fem2d_P1, fem2d_P2

    nodes, elements, physnames = _parse_msh(path)
    dims = {_TYPES[t][2] for t, _, _ in elements if t in _TYPES}
    unknown = {t for t, _, _ in elements if t not in _TYPES}
    if unknown:
        raise ValueError(f"gmsh_import: unsupported element types {unknown}")
    if not dims:
        raise ValueError("gmsh_import: no mesh elements found")
    d = max(dims)
    vol = [(t, phys, conn) for t, phys, conn in elements if _TYPES[t][2] == d]
    fams = {_TYPES[t][0] for t, _, _ in vol}
    if len(fams) != 1:
        raise ValueError(f"gmsh_import: mixed element types {sorted(fams)}; "
                         "a single family is required")
    fam = fams.pop()
    if fam in _REJECT:
        raise ValueError(f"gmsh_import: {_REJECT[fam]}")

    N = len(vol)
    conns = [conn for _, _, conn in vol]

    def coords(tag):
        return nodes[tag]

    # ambient dimension: drop trailing zero coordinate columns
    all_xyz = np.array([nodes[t] for c in conns for t in c])
    ambient = 3 if np.abs(all_xyz[:, 2]).max() > 1e-12 else 2
    if d == 3:
        ambient = 3

    def build_K(order_table, V, e_amb):
        K = np.empty((V, N, e_amb), dtype=dtype)
        tag_grid = np.empty((V, N), dtype=np.int64)
        for e, conn in enumerate(conns):
            for v, g in enumerate(order_table):
                K[v, e, :] = coords(conn[g])[:e_amb]
                tag_grid[v, e] = conn[g]
        return K, tag_grid

    if fam == "tri3":
        K, tags = build_K([0, 1, 2], 3, 2)
        # orientation repair
        for e in range(N):
            v1 = K[1, e] - K[0, e]
            v2 = K[2, e] - K[0, e]
            if v1[0] * v2[1] - v1[1] * v2[0] < 0:
                K[:, e] = K[_TRI3_FLIP, e]
                tags[:, e] = tags[_TRI3_FLIP, e]
        _, t = _dedup_tags(tags)
        geom = fem2d_P1(K=K, t=t, dtype=dtype)
        Vn = 3
    elif fam == "tri6":
        # gmsh tri6: corners 0,1,2 then edge mids (01),(12),(20)
        order = [0, 3, 1, 4, 2, 5]
        K6, tags6 = build_K(order, 6, 2)
        for e in range(N):
            v1 = K6[2, e] - K6[0, e]
            v2 = K6[4, e] - K6[0, e]
            if v1[0] * v2[1] - v1[1] * v2[0] < 0:
                K6[:, e] = K6[_TRI6_FLIP, e]
                tags6[:, e] = tags6[_TRI6_FLIP, e]
        if bubble:
            # bubble node at the P2 map's barycenter image; fresh ids
            xc = (-(K6[0] + K6[2] + K6[4]) + 4 * (K6[1] + K6[3] + K6[5])) / 9.0
            K = np.concatenate([K6, xc[None]], axis=0)
            tags = np.concatenate(
                [tags6, -(1 + np.arange(N, dtype=np.int64))[None]], axis=0)
            Vn = 7
        else:
            K, tags = K6, tags6
            Vn = 6
        _, t = _dedup_tags(tags)
        geom = fem2d_P2(K=K, t=t, dtype=dtype, bubble=bubble)
    elif fam.startswith("quad"):
        V = int(fam[4:])
        k = int(round(np.sqrt(V))) - 1
        s = k + 1
        table = _tensor_order_table(_gmsh_quad_coords(k), k, 2)
        K, tags = build_K(table, V, ambient)
        if ambient == 2:
            # orientation repair (planar only; surfaces keep gmsh orientation)
            for e in range(N):
                v1 = K[k, e] - K[0, e]           # along axis 1
                v2 = K[s * k, e] - K[0, e]       # along axis 2
                if v1[0] * v2[1] - v1[1] * v2[0] < 0:
                    perm = _flip_axis1(list(range(V)), s, 2)
                    K[:, e] = K[perm, e]
                    tags[:, e] = tags[perm, e]
        if k >= 3:
            # gmsh high-order nodes are equispaced; resample the geometry
            # map onto the Chebyshev-Lobatto reference lattice (exact:
            # polynomial interpolation). Shared-slot identities (edges)
            # carry over: the resampled edge nodes of neighbouring elements
            # coincide because the restriction of the map to a conforming
            # shared edge is the same polynomial.
            E1 = _cheb_resample_matrix(k, np.float64)
            # tensor slot = i + s*j (axis-1 fastest): E_full[(i,j),(a,b)] =
            # E1[i,a] * E1[j,b]
            E_full = np.zeros((V, V))
            for i in range(s):
                for j in range(s):
                    for a in range(s):
                        for b in range(s):
                            E_full[i + s * j, a + s * b] = E1[i, a] * E1[j, b]
            K = np.einsum("va,aed->ved", E_full, K)
        _, t = _dedup_tags(tags)
        geom = fem2d(K=K, k=k, t=t, ambient=ambient, dtype=dtype)
        Vn = V
    elif fam.startswith("hex"):
        V = int(fam[3:])
        k = int(round(V ** (1.0 / 3.0))) - 1
        s = k + 1
        table = (_HEX8 if k == 1 else _HEX27 if k == 2 else
                 _tensor_order_table(_gmsh_hex_coords(k), k, 3))
        K, tags = build_K(table, V, 3)
        for e in range(N):
            v1 = K[k, e] - K[0, e]
            v2 = K[s * k, e] - K[0, e]
            v3 = K[s * s * k, e] - K[0, e]
            if np.linalg.det(np.stack([v1, v2, v3])) < 0:
                perm = _flip_axis1(list(range(V)), s, 3)
                K[:, e] = K[perm, e]
                tags[:, e] = tags[perm, e]
        if k >= 3:
            E1 = _cheb_resample_matrix(k, np.float64)
            E_full = np.zeros((V, V))
            for i in range(s):
                for j in range(s):
                    for m in range(s):
                        for a in range(s):
                            for b in range(s):
                                for c in range(s):
                                    E_full[i + s * j + s * s * m,
                                           a + s * b + s * s * c] =                                         E1[i, a] * E1[j, b] * E1[m, c]
            K = np.einsum("va,aed->ved", E_full, K)
        _, t = _dedup_tags(tags)
        geom = fem3d(K=K, k=k, t=t, dtype=dtype)
        Vn = V
    else:  # line/point-only mesh
        raise ValueError("gmsh_import: mesh has no 2D/3D elements")

    # physical groups -> (v, e) pairs by node-tag membership
    group_tags: dict = {}
    for etype, phys, conn in elements:
        for pid in phys:
            gd = _TYPES[etype][2]
            name = physnames.get((gd, pid), f"dim{gd}_{pid}")
            group_tags.setdefault(name, set()).update(conn)
    regions = {}
    for name, tset in group_tags.items():
        pairs = [(v, e) for e in range(N) for v in range(Vn)
                 if int(tags[v, e]) in tset]
        regions[name] = pairs
    return SimpleNamespace(geometry=geom, regions=regions)


def _dedup_tags(tags: np.ndarray):
    """Connectivity from exact gmsh node tags (0-based first-occurrence)."""
    flat = tags.reshape(-1, order="F")
    remap: dict = {}
    out = np.empty_like(flat)
    for i, tg in enumerate(flat):
        tg = int(tg)
        if tg not in remap:
            remap[tg] = len(remap)
        out[i] = remap[tg]
    return len(remap), out.reshape(tags.shape, order="F")

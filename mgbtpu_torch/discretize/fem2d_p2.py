"""2D simplicial P2 triangles, plain Lagrange (6-node) or bubble-enriched
(7-node) variants.

Per-triangle node layout: corner1, edge(1,2), corner2, edge(2,3), corner3,
edge(3,1)[, centroid]. The bubble variant has strictly positive nodal
quadrature weights; pure P2 uses the edge-midpoint rule whose corner weights
are exactly zero — its slack space must then be ``broken_P1`` (per-element
linears parametrized by the midpoint values), which ``assemble`` selects
automatically. Capability parity with reference ``src/fem2d_P2.jl``; all
reference-element tables are derived here from the nodal basis (exact
monomial algebra on the unit triangle) rather than hard-coded.

Host numpy/scipy, a copy of ``mgbtpu/discretize/fem2d_p2.py``; it borrows
``p1_stiffness`` and ``_first_occurrence_ids`` from the port's P1 and
tensor-FEM modules, as the reference does.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.sparse as sp

from ..ops.blockdiag import BlockDiagHost
from .fem2d_p1 import p1_stiffness
from .geometry import Geometry
from .tensorfem import _first_occurrence_ids


class FEM2DP2:
    def __init__(self, bubble: bool, Kfull: np.ndarray):
        self.bubble = bubble
        self.Kfull = Kfull
        self.dim = 2

    @property
    def V(self):
        return 7 if self.bubble else 6

    def default_slack_space(self):
        return "full" if self.bubble else "broken_P1"


# ---------------------------------------------------------------------------
# Reference element (unit triangle (0,0)-(1,0)-(0,1), area 1/2)
# ---------------------------------------------------------------------------

def _monomials(bubble: bool):
    """Monomial basis as (a, b) exponent pairs + optional bubble flag."""
    monos = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)]
    return monos


def _mono_eval(pts, monos, bubble):
    vals = [pts[:, 0] ** a * pts[:, 1] ** b for a, b in monos]
    if bubble:
        x, y = pts[:, 0], pts[:, 1]
        vals.append((1 - x - y) * x * y)
    return np.stack(vals, axis=1)


def _mono_grad(pts, monos, bubble):
    x, y = pts[:, 0], pts[:, 1]
    gx, gy = [], []
    for a, b in monos:
        gx.append(a * x ** max(a - 1, 0) * y ** b if a else 0 * x)
        gy.append(b * x ** a * y ** max(b - 1, 0) if b else 0 * x)
    if bubble:
        gx.append(y - 2 * x * y - y * y)
        gy.append(x - x * x - 2 * x * y)
    return np.stack(gx, axis=1), np.stack(gy, axis=1)


def _mono_integral(monos, bubble):
    """Exact integrals over the unit triangle: int x^a y^b = a! b!/(a+b+2)!."""
    from math import factorial

    out = [factorial(a) * factorial(b) / factorial(a + b + 2)
           for a, b in monos]
    if bubble:
        # int (1-x-y) x y = int xy - x^2 y - x y^2 = 1/24 - 1/60 - 1/60
        out.append(1.0 / 24 - 2.0 / 60)
    return np.array(out)


@lru_cache(maxsize=None)
def reference_triangle(bubble: bool):
    """Nodal reference data: K (node positions from corners), w (nodal
    quadrature = integrals of the nodal basis), Dxi/Deta (reference
    derivative tables), refine (4-child interpolation)."""
    V = 7 if bubble else 6
    # node barycentric weights wrt corners (rows: node, cols: corner)
    Kmap = np.array([[1, 0, 0], [0.5, 0.5, 0], [0, 1, 0],
                     [0, 0.5, 0.5], [0, 0, 1], [0.5, 0, 0.5]])
    if bubble:
        Kmap = np.vstack([Kmap, [1 / 3, 1 / 3, 1 / 3]])
    corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    nodes = Kmap @ corners                                 # (V, 2)
    monos = _monomials(bubble)
    Vand = _mono_eval(nodes, monos, bubble)               # (V, V)
    C = np.linalg.inv(Vand)                                # coeffs: N_j = sum_m C[m,j] mono_m
    w = _mono_integral(monos, bubble) @ C                  # (V,)
    w[np.abs(w) < 1e-14] = 0.0   # pure-P2 corner weights are exactly zero
    Gx, Gy = _mono_grad(nodes, monos, bubble)
    Dxi = Gx @ C                                           # (V, V): dN_j/dx at node i
    Deta = Gy @ C
    # refine: 4 children with corner triples in the canonical order
    child_corners = np.array([[5, 0, 1], [1, 2, 3], [3, 4, 5], [1, 3, 5]])
    refine = np.empty((4 * V, V))
    for s in range(4):
        ch_nodes = Kmap @ nodes[child_corners[s]]          # (V, 2)
        refine[s * V:(s + 1) * V] = _mono_eval(ch_nodes, monos, bubble) @ C
    refine[np.abs(refine) < 1e-13] = 0.0
    return dict(Kmap=Kmap, w=w, Dxi=Dxi, Deta=Deta, refine=refine, V=V)


# ---------------------------------------------------------------------------
# Geometry build (isoparametric, vectorized)
# ---------------------------------------------------------------------------

def _build_geometry_p2(Kfull: np.ndarray, t: np.ndarray | None) -> Geometry:
    dtype = Kfull.dtype
    V, N = Kfull.shape[0], Kfull.shape[1]
    bubble = V == 7
    R = reference_triangle(bubble)
    Dxi, Deta = R["Dxi"], R["Deta"]
    X, Y = Kfull[:, :, 0], Kfull[:, :, 1]                  # (V, N)
    x_xi, x_eta = Dxi @ X, Deta @ X                        # (V, N)
    y_xi, y_eta = Dxi @ Y, Deta @ Y
    detJ = x_xi * y_eta - x_eta * y_xi                     # (V, N)
    if not np.all(detJ > 0):
        bad = int((detJ <= 0).sum())
        raise ValueError(
            f"fem2d_P2: non-positive Jacobian at {bad} node(s): the element "
            f"map is folded or clockwise-oriented; supply orientation-"
            f"preserving, non-self-intersecting elements.")
    inv = 1.0 / detJ
    # blocks: dx[e, j, m] = (y_eta[j,e] Dxi[j,m] - y_xi[j,e] Deta[j,m]) / detJ
    dx = (y_eta.T[:, :, None] * Dxi[None] - y_xi.T[:, :, None] * Deta[None]) \
        * inv.T[:, :, None]
    dy = (-x_eta.T[:, :, None] * Dxi[None] + x_xi.T[:, :, None] * Deta[None]) \
        * inv.T[:, :, None]
    w = (detJ * R["w"][:, None]).reshape(-1, order="F")
    ident = np.broadcast_to(np.eye(V, dtype=dtype), (N, V, V)).copy()
    ops = {"id": BlockDiagHost(ident),
           "dx": BlockDiagHost(dx.astype(dtype)),
           "dy": BlockDiagHost(dy.astype(dtype))}
    return Geometry(FEM2DP2(bubble, Kfull), Kfull, w.astype(dtype), ops, t=t)


def _expand_corners(Kc: np.ndarray, bubble: bool) -> np.ndarray:
    """Corner triangulation (3, N, 2) -> canonical full node mesh."""
    R = reference_triangle(bubble)
    return np.einsum("vc,cNe->vNe", R["Kmap"], Kc)


def fem2d_P2(*, bubble=None, K=None, t=None, dtype=np.float64) -> Geometry:
    """Single-level P2(+bubble) triangulation; default = unit square."""
    if K is None:
        b = True if bubble is None else bubble
        Kc = np.empty((3, 2, 2), dtype=dtype)
        Kc[:, 0, :] = [[-1, -1], [1, -1], [-1, 1]]
        Kc[:, 1, :] = [[1, -1], [1, 1], [-1, 1]]
        Kfull = _expand_corners(Kc, b)
    else:
        K = np.asarray(K, dtype=dtype)
        if K.shape[0] == 3:
            b = True if bubble is None else bubble
            Kfull = _expand_corners(K, b)
        else:
            b = K.shape[0] == 7
            if bubble is not None and bubble != b:
                raise ValueError(f"bubble={bubble} contradicts the "
                                 f"{K.shape[0]}-node mesh")
            Kfull = K
    return _build_geometry_p2(np.asarray(Kfull, dtype=dtype), t)


# ---------------------------------------------------------------------------
# Boundary + subspaces
# ---------------------------------------------------------------------------

def _p2_boundary_set(labels: np.ndarray, V: int, N: int) -> set:
    """Boundary node ids by half-edge counts over the perimeter slots
    (vectorized)."""
    t = labels.reshape(V, N, order="F")
    halfedges = ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0))
    e = np.concatenate([np.stack([t[a], t[b]], axis=1)
                        for a, b in halfedges])
    e = np.sort(e, axis=1)
    uniq, cnt = np.unique(e, axis=0, return_counts=True)
    return set(np.unique(uniq[cnt == 1]).tolist())


def find_boundary_p2(geom: Geometry):
    V, N = geom.x.shape[0], geom.x.shape[1]
    labels = geom.t.reshape(-1, order="F")
    bset = _p2_boundary_set(labels, V, N)
    return [(v, e) for e in range(N) for v in range(V)
            if labels[e * V + v] in bset]


def broken_p1_refine_block(dtype=np.float64) -> np.ndarray:
    """The fixed (12, 3) coarse-to-fine transfer of the element-local
    broken-P1 subspace coordinates (m12, m23, m31) under 4-way red
    refinement: for each child (in the refine-table order) the rows are the
    parent P1 function evaluated at the child's edge midpoints. Analytic —
    the generic least-squares transfer machinery is bypassed for this
    rider (see MultiGrid.from_subspaces)."""
    A, B, C = np.eye(3)
    AB, BC, CA = (A + B) / 2, (B + C) / 2, (C + A) / 2
    # corner values (a, b, c) from midpoint coordinates (slot table inverse)
    T = np.array([[1.0, -1.0, 1.0], [1.0, 1.0, -1.0], [-1.0, 1.0, 1.0]])
    children = ((CA, A, AB), (AB, B, BC), (BC, C, CA), (AB, BC, CA))
    rows = []
    for c0, c1, c2 in children:
        for pt in ((c0 + c1) / 2, (c1 + c2) / 2, (c2 + c0) / 2):
            rows.append(pt @ T)
    return np.asarray(rows, dtype=dtype)


def broken_p1_embedding(N: int, V: int, dtype=np.float64) -> sp.csr_matrix:
    """Per-element linear subspace inside broken P2(+bubble), parametrized by
    the edge-midpoint values (m12, m23, m31): midpoint slots identity,
    corner slots the P1 extrapolations, bubble slot the barycenter value."""
    slot = np.zeros((V, 3))
    slot[0] = [1, -1, 1]     # corner 1 = m12 - m23 + m31
    slot[1] = [1, 0, 0]
    slot[2] = [1, 1, -1]
    slot[3] = [0, 1, 0]
    slot[4] = [-1, 1, 1]
    slot[5] = [0, 0, 1]
    if V == 7:
        slot[6] = [1 / 3, 1 / 3, 1 / 3]
    return sp.block_diag([sp.csr_matrix(slot.astype(dtype))] * N, format="csr")


def _p2_corner_bridge(tri_conn: np.ndarray, n_v: int, interior: np.ndarray,
                      V: int, dtype) -> sp.csr_matrix:
    """Interior P1 corners -> broken P2(+bubble): vertices 1, midpoints 1/2
    each endpoint, bubble 1/3 each corner."""
    N = tri_conn.shape[0]
    idx = -np.ones(n_v, dtype=np.int64)
    idx[interior] = np.arange(len(interior))
    rows, cols, vals = [], [], []

    def push(r, corner, val):
        c = idx[corner]
        if c >= 0:
            rows.append(r)
            cols.append(c)
            vals.append(val)

    for e in range(N):
        a, b, c = (int(tri_conn[e, j]) for j in range(3))
        base = e * V
        push(base + 0, a, 1.0)
        push(base + 2, b, 1.0)
        push(base + 4, c, 1.0)
        push(base + 1, a, 0.5)
        push(base + 1, b, 0.5)
        push(base + 3, b, 0.5)
        push(base + 3, c, 0.5)
        push(base + 5, c, 0.5)
        push(base + 5, a, 0.5)
        if V == 7:
            for u in (a, b, c):
                push(base + 6, u, 1 / 3)
    return sp.csr_matrix((np.asarray(vals, dtype=dtype), (rows, cols)),
                         shape=(V * N, len(interior)))


def amg_p2(geom: Geometry, prolongator, dirichlet_nodes):
    from ..hierarchy.amg_build import (assemble_amg_dicts, assemble_ladder,
                                       continuous_subspace, mask_dirichlet_rows,
                                       pairs_to_linear, run_prolongator,
                                       corner_labels_from_t)

    dtype = geom.dtype
    V, N = geom.x.shape[0], geom.x.shape[1]
    n_broken = V * N
    full_labels = geom.t.reshape(-1, order="F")
    n_full_unique = int(full_labels.max()) + 1

    corner_slots = (0, 2, 4)
    clabels, n_v = corner_labels_from_t(geom.t, corner_slots)
    tri_conn = clabels.reshape(N, 3)
    xf = geom.xflat()
    corners = np.zeros((n_v, 2), dtype=np.float64)
    seen = np.zeros(n_v, dtype=bool)
    for e in range(N):
        for j, sl in enumerate(corner_slots):
            cc = tri_conn[e, j]
            if not seen[cc]:
                corners[cc] = xf[e * V + sl]
                seen[cc] = True
    full_to_corner = {}
    for e in range(N):
        for j, sl in enumerate(corner_slots):
            full_to_corner[int(full_labels[e * V + sl])] = int(tri_conn[e, j])

    K_full = p1_stiffness(corners, tri_conn)

    def hierarchy(interior, mask_set=None):
        # row-then-column slicing: scipy's np.ix_ path materializes
        # the full (n, n) index grid (258 GiB at 263k nodes)
        K_loc = K_full[interior][:, interior]
        P_amg = run_prolongator(K_loc, prolongator)
        bridge = _p2_corner_bridge(tri_conn, n_v, interior, V, dtype)
        if mask_set is not None:
            bridge = mask_dirichlet_rows(bridge, full_labels, mask_set)
        return assemble_ladder(P_amg, bridge, n_broken)

    refine_full, sizes_full = hierarchy(np.arange(n_v))

    def build_dirichlet(nodes):
        dd_set = set(int(full_labels[r]) for r in pairs_to_linear(nodes, V))
        dc_set = set(full_to_corner[f] for f in dd_set if f in full_to_corner)
        interior = np.array(sorted(set(range(n_v)) - dc_set), dtype=np.int64)
        refine_dir, sizes_dir = hierarchy(interior, mask_set=dd_set)
        K_amg = len(refine_dir) - 1
        sub = [sp.identity(sizes_dir[l], format="csr", dtype=dtype)
               for l in range(K_amg)]
        sub.append(continuous_subspace(full_labels, n_full_unique, dd_set, dtype))
        return refine_dir, sub

    return assemble_amg_dicts(
        geom, n_broken, dirichlet_nodes, refine_full, sizes_full,
        build_dirichlet,
        full_riders={"broken_P1": broken_p1_embedding(N, V, dtype)})


# ---------------------------------------------------------------------------
# geometric refinement
# ---------------------------------------------------------------------------

def refine_p2_connectivity(t: np.ndarray) -> np.ndarray:
    """Refine full P2(+bubble) connectivity in the 4-child order of the
    reference element's refine table; bubbles stay element-local.

    Vectorized over elements. Parent non-bubble ids are first compacted by
    first occurrence in (element-major, node-minor) order, then the child
    edge midpoints (and bubbles, which interleave with them in the
    sequential minting order) get first-occurrence ranks over the combined
    per-child key rows — reproducing the registry numbering exactly."""
    t = np.asarray(t, dtype=np.int64)
    V, N = t.shape
    lab = t[:6].T.reshape(-1)
    na = _first_occurrence_ids(lab[:, None], 0).reshape(N, 6)
    n0 = int(na.max()) + 1 if na.size else 0
    a, ab, b, bc, c, ca = (na[:, v] for v in range(6))
    # children[s] corner triples (c0, c1, c2), each (N,)
    children = np.stack([np.stack(tri, axis=1) for tri in
                         ((ca, a, ab), (ab, b, bc), (bc, c, ca),
                          (ab, bc, ca))], axis=1)        # (N, 4, 3)
    # per child: 3 edge keys (sorted endpoint pairs) + optional bubble key,
    # laid out in the sequential minting order (e-major, child, slot)
    c0, c1, c2 = children[..., 0], children[..., 1], children[..., 2]
    epairs = np.stack([np.stack([c0, c1], -1), np.stack([c1, c2], -1),
                       np.stack([c2, c0], -1)], axis=2)  # (N, 4, 3, 2)
    ekeys = np.sort(epairs, axis=-1)
    slots = 4 if V == 7 else 3
    keys = np.empty((N, 4, slots, 2), dtype=np.int64)
    keys[:, :, :3, :] = ekeys
    if V == 7:
        # bubbles are element-local: a unique negative key per (e, child)
        eidx = np.arange(N)[:, None] * 4 + np.arange(4)[None, :]
        keys[:, :, 3, 0] = -1 - eidx
        keys[:, :, 3, 1] = -1
    ids = _first_occurrence_ids(keys.reshape(-1, 2), n0).reshape(N, 4, slots)
    out = np.empty((V, 4 * N), dtype=np.int64)
    for s in range(4):
        out[0, s::4], out[2, s::4], out[4, s::4] = c0[:, s], c1[:, s], c2[:, s]
        out[1, s::4], out[3, s::4], out[5, s::4] = (
            ids[:, s, 0], ids[:, s, 1], ids[:, s, 2])
        if V == 7:
            out[6, s::4] = ids[:, s, 3]
    return out


def geometric_mg_p2(geom: Geometry, L: int):
    from ..hierarchy.multigrid import MultiGrid
    from ..hierarchy.amg_build import continuous_subspace

    dtype = geom.dtype
    if L < 1:
        raise ValueError("L must be >= 1")
    V = geom.x.shape[0]
    bubble = V == 7
    R = reference_triangle(bubble)
    Pref = R["refine"]
    meshes = [np.asarray(geom.x, dtype=dtype)]
    topos = [geom.t.copy()]
    for l in range(L - 1):
        Xc = meshes[l]
        Xf = np.empty((V, Xc.shape[1] * 4, 2), dtype=dtype)
        for ch in range(4):
            blk = Pref[ch * V:(ch + 1) * V, :]
            Xf[:, ch::4, :] = np.einsum("im,mNe->iNe", blk, Xc)
        meshes.append(Xf)
        topos.append(refine_p2_connectivity(topos[l]))

    geomL = geom if L == 1 else _build_geometry_p2(meshes[-1], topos[-1])
    refine = []
    for l in range(L - 1):
        refine.append(sp.block_diag(
            [sp.csr_matrix(Pref.astype(dtype))] * meshes[l].shape[1],
            format="csr"))
    refine.append(sp.identity(V * meshes[-1].shape[1], format="csr",
                              dtype=dtype))
    subspaces = {"dirichlet": [], "full": [], "uniform": [], "broken_P1": []}
    for l in range(L):
        Nl = meshes[l].shape[1]
        nl = V * Nl
        labels = topos[l].reshape(-1, order="F")
        bset = _p2_boundary_set(labels, V, Nl)
        subspaces["dirichlet"].append(
            continuous_subspace(labels, int(labels.max()) + 1, bset, dtype))
        subspaces["full"].append(sp.identity(nl, format="csr", dtype=dtype))
        subspaces["uniform"].append(sp.csr_matrix(np.ones((nl, 1), dtype=dtype)))
        subspaces["broken_P1"].append(broken_p1_embedding(Nl, V, dtype))
    bp1_block = broken_p1_refine_block(dtype)
    bp1_transfers = [sp.block_diag([sp.csr_matrix(bp1_block)]
                                   * meshes[l].shape[1], format="csr")
                     for l in range(L - 1)]
    return MultiGrid.from_subspaces(
        geomL, subspaces, {k: refine for k in subspaces},
        transfers_override={"broken_P1": bp1_transfers})

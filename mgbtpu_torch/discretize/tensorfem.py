"""Dimension-generic tensor-product Q_k Lagrange finite elements.

Covers 1D/2D/3D structured Q_k elements with intrinsic dimension d and
ambient dimension e >= d (embedded curves/surfaces when e > d), isoparametric
(node-varying tangent Jacobian honours curved elements). Chebyshev-Lobatto
nodes with Clenshaw-Curtis weights per axis; operators are the ambient
components of the intrinsic gradient, weights sqrt(det(J^T J)) * tensor-CC.

Host numpy, a copy of ``mgbtpu/discretize/tensorfem.py`` (the reference's
``src/TensorFEM.jl``: geometry build at :428-490, dofmap at :338-383,
boundary at :643-678, geometric refinement at :865-954); every per-element
array lands in the (N, p, q) block layout of ``ops.blockdiag``. All indices
are 0-based.
"""
from __future__ import annotations

import numpy as np

from ..ops.blockdiag import BlockDiagHost
from .geometry import Geometry

AXIS_SYMS = ("dx", "dy", "dz")


class TensorFEM:
    """Discretization descriptor: intrinsic dim d, ambient dim e, order k."""

    def __init__(self, d: int, e: int, k: int, corners: np.ndarray):
        self.d = d
        self.e = e
        self.k = k
        self.corners = corners  # (2^d, N, e) Q1 corner tensor (informational)

    @property
    def dim(self):
        return self.d

    def default_slack_space(self):
        return "full"


# ---------------------------------------------------------------------------
# 1D reference primitives
# ---------------------------------------------------------------------------

def cheb_lobatto_nodes(k: int, dtype=np.float64) -> np.ndarray:
    """Chebyshev-Lobatto nodes on [-1, 1], ascending; k=1 -> [-1, 1]."""
    i = np.arange(k + 1)
    return (-np.cos(np.pi * i / max(k, 1))).astype(dtype)


def clenshaw_curtis_weights(k: int, dtype=np.float64) -> np.ndarray:
    """Clenshaw-Curtis weights for the k+1 Chebyshev-Lobatto nodes (sum 2)."""
    if k == 0:
        return np.array([2.0], dtype=dtype)
    N = k
    i = np.arange(N + 1)
    val = np.ones(N + 1, dtype=np.float64)
    for j in range(1, N // 2 + 1):
        c = 1.0 if 2 * j == N else 2.0
        val += c / (1 - 4.0 * j * j) * np.cos(2 * np.pi * j * i / N)
    w = np.where((i == 0) | (i == N), val / N, 2 * val / N)
    return w.astype(dtype)


def lagrange_dmat(nodes: np.ndarray) -> np.ndarray:
    """Dense differentiation matrix D[i, j] = L_j'(x_i) on the given nodes."""
    nodes = np.asarray(nodes, dtype=np.float64)
    s = len(nodes)
    # barycentric weights
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    wb = 1.0 / np.prod(diff, axis=1)
    D = np.empty((s, s))
    for i in range(s):
        for j in range(s):
            if i != j:
                D[i, j] = (wb[j] / wb[i]) / (nodes[i] - nodes[j])
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -D.sum(axis=1))
    return D


def lagrange_values(nodes: np.ndarray, xq) -> np.ndarray:
    """Lagrange basis values: out[q, j] = L_j(xq[q]) on ``nodes``."""
    nodes = np.asarray(nodes, dtype=np.float64)
    xq = np.atleast_1d(np.asarray(xq, dtype=np.float64))
    s = len(nodes)
    out = np.empty((len(xq), s))
    for j in range(s):
        num = np.ones_like(xq)
        den = 1.0
        for m in range(s):
            if m != j:
                num *= xq - nodes[m]
                den *= nodes[j] - nodes[m]
        out[:, j] = num / den
    return out


# ---------------------------------------------------------------------------
# Reference element
# ---------------------------------------------------------------------------

def _kron_axis(D1, I1, d, axis):
    """kron over axes b=d-1..0 of (D1 if b==axis else I1); axis 0 fastest."""
    M = np.ones((1, 1))
    for b in range(d - 1, -1, -1):
        M = np.kron(M, D1 if b == axis else I1)
    return M


class TFRef:
    def __init__(self, d: int, k: int):
        self.s = s = k + 1
        self.nodes1 = cheb_lobatto_nodes(k)
        self.w1 = clenshaw_curtis_weights(k)
        D1 = lagrange_dmat(self.nodes1)
        I1 = np.eye(s)
        self.Daxis = tuple(_kron_axis(D1, I1, d, a) for a in range(d))
        self.n = n = s ** d
        # multi-indices, axis 0 fastest
        grids = np.meshgrid(*[np.arange(s)] * d, indexing="ij")
        mi = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
        self.mi = mi  # (n, d) multi-index of each local node
        self.nodesref = self.nodes1[mi]                      # (n, d)
        self.wref = np.prod(self.w1[mi], axis=1)             # (n,)


_REF_CACHE: dict = {}


def tf_reference(d: int, k: int) -> TFRef:
    key = (d, k)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = TFRef(d, k)
    return _REF_CACHE[key]


def q1_lift(ref: TFRef, d: int) -> np.ndarray:
    """Multilinear corner lift L (s^d, 2^d): L[i, c] = prod_a phi_{bit}(xi_a)."""
    n = ref.n
    nc = 1 << d
    L = np.ones((n, nc))
    for a in range(d):
        xa = ref.nodesref[:, a][:, None]                     # (n, 1)
        bits = (np.arange(nc)[None, :] >> a) & 1             # (1, nc)
        L *= np.where(bits == 0, (1 - xa) / 2, (1 + xa) / 2)
    return L


def corner_local(c: int, s: int, d: int) -> int:
    """Local linear index of corner c (bit a of c selects low/high of axis a)."""
    lin, stride = 0, 1
    for a in range(d):
        ia = 0 if ((c >> a) & 1) == 0 else s - 1
        lin += ia * stride
        stride *= s
    return lin


def extract_corners(x: np.ndarray, k: int, d: int) -> np.ndarray:
    s = k + 1
    nc = 1 << d
    idx = [corner_local(c, s, d) for c in range(nc)]
    return x[idx]          # (2^d, N, e)


def promote_corners(K: np.ndarray, k: int, d: int) -> np.ndarray:
    """Q1 corners (2^d, N, e) -> straight Q_k nodes (s^d, N, e)."""
    ref = tf_reference(d, k)
    L = q1_lift(ref, d)
    return np.einsum("ic,cNe->iNe", L, K)


def resolve_mesh(K: np.ndarray, k: int, d: int) -> np.ndarray:
    s = k + 1
    n = s ** d
    nc = 1 << d
    if K.shape[0] == n:
        return K
    if K.shape[0] == nc:
        return promote_corners(K, k, d)
    raise ValueError(
        f"fem{d}d: K needs {nc} corners or (k+1)^{d}={n} nodes per element "
        f"(got {K.shape[0]})")


# ---------------------------------------------------------------------------
# Geometry construction (vectorized isoparametric build)
# ---------------------------------------------------------------------------

def build_geometry(d: int, e: int, k: int, x: np.ndarray, t=None) -> Geometry:
    dtype = x.dtype
    ref = tf_reference(d, k)
    n, N = x.shape[0], x.shape[1]
    if x.shape[2] != e:
        raise ValueError(f"ambient={e} but mesh has {x.shape[2]} coordinate columns")
    if not (d <= e <= 3):
        raise ValueError(f"ambient dim must satisfy {d} <= e <= 3 (got {e})")

    DA = np.stack(ref.Daxis)                                  # (d, n, n)
    # tangent Jacobian per node/element: J[i, el, dim, b] = (Daxis[b] @ X)[i, el, dim]
    J = np.einsum("bim,mNe->iNeb", DA, x)                    # (n, N, e, d)
    g = np.einsum("iNeb,iNec->iNbc", J, J)                    # first fundamental form
    detg = np.linalg.det(g)                                   # (n, N)
    # P = g^{-1} J^T : (n, N, d, e)
    P = np.linalg.solve(g, np.swapaxes(J, 2, 3))
    # deriv block for ambient axis A: block[el, i, m] = sum_b P[i,el,b,A] * Daxis[b][i,m]
    deriv = np.einsum("iNbA,bim->ANim", P, DA)               # (e, N, n, n)

    w2 = ref.wref[:, None] * np.sqrt(np.maximum(detg, 0.0))  # (n, N)
    w = w2.reshape(-1, order="F").astype(dtype)
    if not np.all(w > 0):
        bad = np.nonzero(w <= 0)[0]
        badelems = sorted(set(bad // n))
        raise ValueError(
            f"fem{d}d: non-positive quadrature weight at {len(bad)} node(s) across "
            f"{len(badelems)} element(s) (first few: {badelems[:5]}): the element "
            f"map is degenerate (det(J^T J) <= 0); supply non-degenerate, "
            f"non-self-intersecting elements.")

    id_data = np.broadcast_to(np.eye(n, dtype=dtype), (N, n, n)).copy()
    ops = {"id": BlockDiagHost(id_data)}
    for a in range(e):
        ops[AXIS_SYMS[a]] = BlockDiagHost(
            np.ascontiguousarray(deriv[a].astype(dtype)))

    disc = TensorFEM(d, e, k, extract_corners(x, k, d))
    return Geometry(disc, x.astype(dtype), w, ops, t=t)


def _mesh_from_nodes(nodes, dtype=np.float64) -> np.ndarray:
    nodes = np.asarray(nodes, dtype=dtype)
    ne = len(nodes) - 1
    K = np.empty((2, ne, 1), dtype=dtype)
    K[0, :, 0] = nodes[:-1]
    K[1, :, 0] = nodes[1:]
    return K


def _default_square(dtype=np.float64) -> np.ndarray:
    K = np.empty((4, 1, 2), dtype=dtype)
    K[:, 0, :] = [[-1, -1], [1, -1], [-1, 1], [1, 1]]
    return K


def _default_cube(dtype=np.float64) -> np.ndarray:
    K = np.empty((8, 1, 3), dtype=dtype)
    K[:, 0, :] = [[-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1]]
    return K


def fem1d(*, nodes=None, k=1, K=None, ambient=1, t=None, dtype=np.float64):
    """1D Q_k FEM geometry; ``nodes`` = element endpoints (default [-1, 1])."""
    if K is None:
        K = _mesh_from_nodes([-1.0, 1.0] if nodes is None else nodes, dtype)
    K = np.asarray(K, dtype=dtype)
    return build_geometry(1, ambient, k, resolve_mesh(K, k, 1), t=t)


def fem2d(*, k=1, K=None, ambient=2, t=None, dtype=np.float64):
    """2D Q_k FEM geometry on quads (possibly embedded in R^3)."""
    K = _default_square(dtype) if K is None else np.asarray(K, dtype=dtype)
    return build_geometry(2, ambient, k, resolve_mesh(K, k, 2), t=t)


def fem3d(*, k=3, K=None, t=None, dtype=np.float64):
    """3D Q_k FEM geometry on hexes."""
    K = _default_cube(dtype) if K is None else np.asarray(K, dtype=dtype)
    return build_geometry(3, 3, k, resolve_mesh(K, k, 3), t=t)


# ---------------------------------------------------------------------------
# Boundary detection (face-use count)
# ---------------------------------------------------------------------------

def find_boundary_tensorfem(geom: Geometry):
    """(v, e) pairs (0-based) of every Q_k DOF on the domain boundary.

    A (d-1)-face used by exactly one element is boundary; every DOF on such a
    face is returned.
    """
    disc = geom.discretization
    d, k = disc.d, disc.k
    s = k + 1
    n = s ** d
    N = geom.x.shape[1]
    labels = geom.t.reshape(-1, order="F")     # flat node id, index e*n + v
    ref = tf_reference(d, k)
    mi = ref.mi

    faces_local = []
    for a in range(d):
        for layer in (0, s - 1):
            faces_local.append(np.nonzero(mi[:, a] == layer)[0])

    from collections import Counter

    count: Counter = Counter()
    sigs = {}
    for e in range(N):
        base = e * n
        for fl in faces_local:
            sig = tuple(sorted(labels[base + li] for li in fl))
            count[sig] += 1
    bdry = set()
    for sig, c in count.items():
        if c == 1:
            bdry.update(sig)
    pairs = [(v, e) for e in range(N) for v in range(n)
             if labels[e * n + v] in bdry]
    return pairs


# ---------------------------------------------------------------------------
# Topological DOF numbering from corner connectivity
# ---------------------------------------------------------------------------

def _entity_corner_ids(cor, mi, inter, s, d):
    """Global ids of the corners spanning the minimal entity containing the
    local node with multi-index ``mi`` and interior-axis list ``inter``."""
    nint = len(inter)
    out = []
    for combo in range(1 << nint):
        cbits = 0
        for a in range(d):
            if a in inter:
                j = inter.index(a)
                bit = (combo >> j) & 1
            else:
                bit = 1 if mi[a] == s - 1 else 0
            cbits |= bit << a
        out.append(int(cor[cbits]))
    return out


def _face_pos(ids, pi, pj, k):
    """Canonical face-interior position under the quad face's 8 symmetries."""
    def g(i, j):
        return ids[i + 2 * j]

    i0 = j0 = 0
    best = g(0, 0)
    for j in (0, 1):
        for i in (0, 1):
            if g(i, j) < best:
                best, i0, j0 = g(i, j), i, j
    ri = pi if i0 == 0 else k - pi
    rj = pj if j0 == 0 else k - pj
    if g(1 - i0, j0) > g(i0, 1 - j0):
        ri, rj = rj, ri
    return ri + rj * (k + 1)


def _first_occurrence_ids(keys: np.ndarray, base: int) -> np.ndarray:
    """Sequential ids for key rows: each distinct row gets ``base + r`` where
    r is the rank of its FIRST occurrence in row order — exactly the
    numbering a sequential dict-registry pass would produce.

    lexsort-based (np.unique(axis=0)'s void-view row sort is ~10x slower):
    lexsort is stable, so within each equal-row group the original indices
    ascend, and the group's first sorted element carries its minimal (first-
    occurrence) row index."""
    M = len(keys)
    if M == 0:
        return np.empty(0, dtype=np.int64)
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    new = np.empty(M, dtype=bool)
    new[0] = True
    np.any(sk[1:] != sk[:-1], axis=1, out=new[1:])
    gid_sorted = np.cumsum(new) - 1
    starts = np.flatnonzero(new)
    first_idx = order[starts]                  # first-occurrence row per group
    rank = np.empty(len(starts), dtype=np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(len(starts))
    ids_sorted = rank[gid_sorted]
    ids = np.empty(M, dtype=np.int64)
    ids[order] = ids_sorted
    return base + ids


def _face_pos_vec(ids: np.ndarray, pi: int, pj: int, k: int) -> np.ndarray:
    """Vectorized ``_face_pos``: ids is (E, 4) with g(i, j) = ids[:, i+2j]."""
    b = np.argmin(ids, axis=1)
    i0, j0 = b & 1, b >> 1
    ri = np.where(i0 == 0, pi, k - pi)
    rj = np.where(j0 == 0, pj, k - pj)
    E = np.arange(len(ids))
    swap = ids[E, (1 - i0) + 2 * j0] > ids[E, i0 + 2 * (1 - j0)]
    ri, rj = np.where(swap, rj, ri), np.where(swap, ri, rj)
    return ri + rj * (k + 1)


def tensor_dofmap(t_corner: np.ndarray, k: int, d: int) -> np.ndarray:
    """Full-node connectivity from corner connectivity alone (no coordinates).

    Preserves coincident-but-distinct nodes (slits, branch cuts, glued
    manifolds). Corner ids carry through; shared edges oriented by endpoint
    ids, shared faces canonicalized by the 8 quad symmetries; cell-interior
    nodes fresh. 0-based ids.

    Vectorized over the element axis (the reference's equivalent pass is
    compiled Julia, ``src/TensorFEM.jl:338-383``): per local node the
    entity's corner-gather indices are fixed, so each of the (k+1)^d local
    nodes costs O(N) numpy work, and the sequential shared-entity numbering
    is reproduced by first-occurrence ranking over the encoded entity keys.
    """
    t_corner = np.asarray(t_corner, dtype=np.int64)
    s = k + 1
    n = s ** d
    nc = 1 << d
    if t_corner.shape[0] != nc:
        raise ValueError(f"t_corner must have 2^{d}={nc} rows")
    N = t_corner.shape[1]
    ref = tf_reference(d, k)
    mi_all = ref.mi
    next_id = int(t_corner.max()) + 1 if t_corner.size else 0

    # keys[e, v] encodes the shared-entity identity of local node v in
    # element e: (sorted entity corner ids..., pos); cell-interior nodes get
    # the unique key (e, v) so they always mint a fresh id. t_flat holds
    # resolved corner ids; key_mask marks rows that go through the registry.
    KW = 5  # 4 sorted ids + pos (edge keys pad with -1)
    keys = np.zeros((N, n, KW), dtype=np.int64)
    t_out = np.zeros((n, N), dtype=np.int64)
    key_mask = np.zeros(n, dtype=bool)
    for v in range(n):
        mi = mi_all[v]
        inter = [a for a in range(d) if 0 < mi[a] < s - 1]
        nint = len(inter)
        if nint == d:
            keys[:, v, 0] = np.arange(N)
            keys[:, v, 1] = v
            keys[:, v, 2:] = -2          # distinct from every entity key
            key_mask[v] = True
            continue
        gidx = []
        for combo in range(1 << nint):
            cbits = 0
            for a in range(d):
                if a in inter:
                    bit = (combo >> inter.index(a)) & 1
                else:
                    bit = 1 if mi[a] == s - 1 else 0
                cbits |= bit << a
            gidx.append(cbits)
        ids = t_corner[gidx, :].T                     # (N, 2^nint)
        if nint == 0:
            t_out[v] = ids[:, 0]
            continue
        if nint == 1:
            p = int(mi[inter[0]])
            pos = np.where(ids[:, 0] <= ids[:, 1], p, k - p)
            keys[:, v, :2] = np.sort(ids, axis=1)
            keys[:, v, 2:4] = -1
        elif nint == 2:
            pos = _face_pos_vec(ids, int(mi[inter[0]]), int(mi[inter[1]]), k)
            keys[:, v, :4] = np.sort(ids, axis=1)
        else:
            raise ValueError(
                "tensor_dofmap: interior grids on shared entities of "
                "dimension >= 3 are not supported")
        keys[:, v, 4] = pos
        key_mask[v] = True
    if key_mask.any():
        sel = keys[:, key_mask, :].reshape(-1, KW)    # (e-major, v-minor)
        ids_new = _first_occurrence_ids(sel, next_id)
        t_out[key_mask, :] = ids_new.reshape(N, -1).T
    return t_out


# ---------------------------------------------------------------------------
# Geometric refinement
# ---------------------------------------------------------------------------

def refine_local(k: int, d: int) -> np.ndarray:
    """Per-child broken interpolation P_local (2^d * n, n): block ch evaluates
    the parent Q_k element at child ch's node positions."""
    ref = tf_reference(d, k)
    s = k + 1
    n = ref.n
    nc = 1 << d
    nodes1 = ref.nodes1
    P = np.zeros((nc * n, n))
    for ch in range(nc):
        # child node coords along each axis: child ch occupies the parent
        # sub-box [-1,0] (bit 0) or [0,1] (bit 1) per axis
        axvals = []
        for a in range(d):
            shift = -0.5 if ((ch >> a) & 1) == 0 else 0.5
            axvals.append(lagrange_values(nodes1, nodes1 * 0.5 + shift))  # (s, s)
        # tensor product: value of parent basis j at child node i
        blk = np.ones((n, n))
        for a in range(d):
            blk *= axvals[a][np.ix_(ref.mi[:, a], ref.mi[:, a])]
        P[ch * n:(ch + 1) * n, :] = blk
    return P


def refine_connectivity(t: np.ndarray, k: int, d: int) -> np.ndarray:
    """Topological 2^d-subdivision of the corner/element structure; children
    get corner ids keyed by parent entities, then ``tensor_dofmap`` numbers
    every child Q_k node.

    Vectorized over elements like ``tensor_dofmap``: the (child, corner)
    pair fixes the parent-entity gather indices, so the loop runs over the
    4^d local pairs with O(N) numpy work each, and the shared counter over
    corner/entity/cell keys is reproduced by first-occurrence ranking."""
    s = k + 1
    nc = 1 << d
    N = t.shape[1]
    cornerlocal = [corner_local(c, s, d) for c in range(nc)]
    P = np.asarray(t, dtype=np.int64)[cornerlocal, :]      # (nc, N) parents
    # key layout: (tag, sorted entity ids... or (e,)), padded with -1
    KW = 1 + max(nc // 2, 2)
    keys = np.zeros((N, nc, nc, KW), dtype=np.int64)
    for ch in range(nc):
        for c in range(nc):
            # position in the parent's 3-point grid: 0=low, 1=centre, 2=high
            mi = tuple((((ch >> a) & 1) + ((c >> a) & 1)) for a in range(d))
            inter = [a for a in range(d) if mi[a] == 1]
            nint = len(inter)
            gidx = []
            for combo in range(1 << nint):
                cbits = 0
                for a in range(d):
                    if a in inter:
                        bit = (combo >> inter.index(a)) & 1
                    else:
                        bit = 1 if mi[a] == 2 else 0
                    cbits |= bit << a
                gidx.append(cbits)
            ent = P[gidx, :].T                             # (N, 2^nint)
            kb = keys[:, ch, c, :]
            kb[:, 1:] = -1
            if nint == 0:
                kb[:, 0] = 0
                kb[:, 1] = ent[:, 0]
            elif nint == d:
                kb[:, 0] = 1
                kb[:, 1] = np.arange(N)
            else:
                kb[:, 0] = 2 + nint
                kb[:, 1:1 + ent.shape[1]] = np.sort(ent, axis=1)
    ids = _first_occurrence_ids(keys.reshape(-1, KW), 0)   # (e, ch, c) order
    child_corners = ids.reshape(N * nc, nc).T              # [c, e*nc + ch]
    return tensor_dofmap(child_corners, k, d)

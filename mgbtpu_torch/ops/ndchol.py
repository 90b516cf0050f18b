"""Nested-dissection multifrontal Cholesky (torch port of the float64
parts of ``mgbtpu/ops/ndchol.py``).

The deep-t barrier Hessian has hundreds of near-null equilibrated
eigenvalues that no smoother/coarse-space combination represents, while a
direct factorization with a shift below lambda_min handles the same systems
(the reference leans on cuDSS sparse Cholesky for the same reason). The
factor is built from the FEM element structure:

- SYMBOLIC (host numpy, once per hierarchy level, copied from the
  reference): recursive coordinate bisection of the ELEMENTS into a complete
  binary tree; each dof goes to the LCA tree node of the leaves whose
  elements touch it. All index plans are precomputed.
- NUMERIC (device, per refresh): bottom-up over tree levels, each level one
  BATCH of dense partial factorizations: batched Cholesky of the eliminated
  block, batched triangular solve for the coupling, batched product for the
  Schur complement, all three in one launch of the front kernel K5a
  (``kernels.front_factor``) per tree level.
- SOLVE: forward/backward sweeps over the same structure, each tree level
  of each sweep one call of the front kernel K5b (``kernels.front_forward``,
  ``kernels.front_backward``):
  gathers, triangular solves, coupling products and, forward, the
  separator update as a fixed-order gather over ``boundary_incidence``.

Padded slots carry unit diagonal and zero coupling so they factor trivially
and contribute nothing. Index plans are int64 (int32 in the reference).

SUBTREE PER DEVICE (``to_device(mesh=...)``, the reference's ``_bshard``):
a tree level whose front count nk divides by the mesh size n, with
nk >= n, puts fronts [d nk/n, (d+1) nk/n) on device d. The leaf order is
contiguous, so children 2i and 2i+1 stay with their parent, and these
levels are a prefix of the tree, leaves up. ``nd_factor`` gathers each
device's leaf element blocks from the element shards, runs K5a per device
up the divisible levels and moves the Schur complements to the first
device at the first level that does not divide; the levels above run
there. ``nd_solve`` runs K5b's forward sweep per device on a residual that
holds the rhs at the device's own rows (the dofs its fronts eliminate);
the first device applies every device's updates U y to the rows of the
levels above, level by level in the fronts' order (the fold one device
makes), solves the top levels, and sends x down for each device's
backward sweep. A mesh gives the bits of one device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import front_backward, front_factor, front_forward
from ..parallel.sharding import Mesh, shard_ranges
from ..utils.trace import span, spanned
from .scatter import scatter_add

ND_LEAF_ELEMS = 8


# ---------------------------------------------------------------------------
# symbolic phase (host)
# ---------------------------------------------------------------------------

def _bisect_order(xy: np.ndarray, depth: int) -> np.ndarray:
    """Leaf id (0..2^depth-1) per element by recursive median bisection of
    the widest coordinate axis."""
    N = xy.shape[0]
    leaf = np.zeros(N, dtype=np.int64)
    stack = [(np.arange(N), 0, 0)]
    while stack:
        idx, d, base = stack.pop()
        if d == depth or len(idx) == 0:
            leaf[idx] = base
            continue
        spans = xy[idx].max(axis=0) - xy[idx].min(axis=0) if len(idx) else 0
        ax = int(np.argmax(spans))
        order = idx[np.argsort(xy[idx, ax], kind="stable")]
        h = len(order) // 2
        stack.append((order[:h], d + 1, base << 1))
        stack.append((order[h:], d + 1, (base << 1) | 1))
    return leaf


class NDPlan:
    """Host-side symbolic factorization plan (see module docstring)."""

    def __init__(self, cols: np.ndarray, n_J: int, elem_xy: np.ndarray,
                 leaf_elems: int = 8):
        cols = np.asarray(cols, dtype=np.int64)
        N, C = cols.shape
        depth = max(0, int(np.ceil(np.log2(max(N, 1) / leaf_elems))))
        leaf = _bisect_order(np.asarray(elem_xy, np.float64), depth)
        self.n_J = n_J
        self.depth = depth

        # dof -> (lmin, lmax) over touching leaves -> LCA node
        lmin = np.full(n_J, 1 << 62, dtype=np.int64)
        lmax = np.full(n_J, -1, dtype=np.int64)
        lf = np.repeat(leaf, C)
        cf = cols.reshape(-1)
        np.minimum.at(lmin, cf, lf)
        np.maximum.at(lmax, cf, lf)
        touched = lmax >= 0
        # level of LCA: depth - (highest differing bit position + 1); equal
        # -> leaf level (= depth)
        diff = lmin ^ lmax
        hb = np.zeros(n_J, dtype=np.int64)
        nz = diff > 0
        hb[nz] = np.floor(np.log2(diff[nz].astype(np.float64))).astype(np.int64) + 1
        lev = depth - hb                     # tree level of the LCA node
        node_idx = lmin >> hb                # index within that level
        lev[~touched] = depth                # untouched dofs: park at leaf 0
        node_idx[~touched] = 0

        # per-node assigned dofs, sorted by global id (deterministic)
        self.levels = []
        # front membership: dof d belongs to front of node v iff v is on
        # the tree path from any touching leaf to d's LCA node. Compute
        # per-level front lists bottom-up.
        # region-touched dofs per node at each level:
        # node (k, i) covers leaves [i<<(depth-k), (i+1)<<(depth-k))
        # dof touched by node (k, i) iff [lmin, lmax] intersects that range
        # and front-member iff additionally its LCA level <= k (assigned at
        # or above this level).
        self.assign_lev = lev
        self.assign_idx = node_idx
        self.lmin, self.lmax = lmin, lmax
        self.leaf_of_elem = leaf
        self.cols = cols


    def front_dofs(self, k, i):
        """Front of node (k, i): dofs assigned at (k, i) first, then
        boundary dofs (EXACTLY touched by the node's elements, assigned to
        a proper ancestor), each sorted by global id."""
        s = self.depth - k
        in_node = (self.leaf_of_elem >> s) == i
        touched = np.zeros(self.n_J, dtype=bool)
        touched[np.unique(self.cols[in_node])] = True
        assigned_here = touched & (self.assign_lev == k) \
            & (self.assign_idx == i)
        anc = touched & (self.assign_lev < k)
        a = np.flatnonzero(assigned_here)
        b = np.flatnonzero(anc)
        return a, b



def _row_searchsorted(A, v):
    """Per-row searchsorted: position of v[i] in sorted row A[i]."""
    n, m = A.shape
    lo = np.zeros(len(v), dtype=np.int64)
    hi = np.full(len(v), m, dtype=np.int64)
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        val = A[np.arange(len(v)), np.minimum(mid, m - 1)]
        go_right = active & (val < v)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    return lo



def boundary_incidence(bdofs: np.ndarray, n: int):
    """Inverse incidence of one level's boundary scatter: the real dofs
    of ``bdofs`` (nk, bmax), increasing, and for each the flat positions
    node*bmax + slot that land on it, increasing, padded with nk*bmax,
    (nr, Kb). Row i is row ``rows[i]`` of the JAX package's ``b_inc``
    (``mgbtpu/ops/ndchol.py:318-332``), whose other rows are all padding.
    Gathering the updates in this order gives the bits of a sequential
    scatter-add, with no atomics."""
    nk, bmax = bdofs.shape
    bd = bdofs.reshape(-1)
    pos = np.flatnonzero(bd < n)
    dofs = bd[pos]
    o = np.argsort(dofs, kind="stable")
    pos, dofs = pos[o], dofs[o]
    rows, start, cnt = np.unique(dofs, return_index=True, return_counts=True)
    Kb = max(int(cnt.max()) if len(cnt) else 1, 1)
    inc = np.full((len(rows), Kb), nk * bmax, dtype=np.int64)
    inc[np.repeat(np.arange(len(rows)), cnt),
        np.arange(len(dofs)) - np.repeat(start, cnt)] = pos
    return rows.astype(np.int64), inc


class NDDevicePlan:
    """Per-level static index arrays for the batched factorization.

    Front layout per node at level k: slots [0, amax_k) hold the node's
    assigned (eliminated) dofs (padded with unit-diagonal dummies), slots
    [amax_k, amax_k + bmax_k) the boundary dofs; one trailing dump slot
    absorbs padded scatters. All dof-id arrays use n_J as the dump id
    (rhs/solution vectors are padded to n_J + 1).

    The symbolic build is fully vectorized (the per-node membership at
    level k is the contiguous leaf-id interval [lmin>>s, lmax>>s], a
    conservative superset for non-contiguous touch sets — extra boundary
    members only enlarge fronts, never break the Schur closure)."""

    def __init__(self, plan: NDPlan):
        depth = plan.depth
        n = plan.n_J
        self.depth = depth
        self.n_J = n
        alev = plan.assign_lev
        self.levels = []
        # EXACT per-level membership from the (dof, leaf) incidence: a dof
        # belongs to the fronts of exactly the nodes whose regions contain
        # one of its touching leaves (the [lmin, lmax] hull overestimates
        # catastrophically for dofs near cut corners — measured 247-wide
        # leaf fronts where the true boundary is ~25).
        pair_dof = plan.cols.reshape(-1)
        pair_leaf = np.repeat(plan.leaf_of_elem, plan.cols.shape[1])
        node_front = []        # per level: (node_of_member, dof, is_bnd)
        for k in range(depth, -1, -1):
            s = depth - k
            nk = 1 << k
            key = pair_dof * nk + (pair_leaf >> s)
            uniq = np.unique(key)
            rep_dof = uniq // nk
            rep_node = uniq % nk
            keep = alev[rep_dof] <= k
            rep_dof, rep_node = rep_dof[keep], rep_node[keep]
            is_bnd = ~((alev[rep_dof] == k)
                       & (plan.assign_idx[rep_dof] == rep_node))
            order = np.lexsort((rep_dof, is_bnd, rep_node))
            node_front.append((rep_node[order], rep_dof[order],
                               is_bnd[order]))
            a_cnt = np.bincount(rep_node[~is_bnd], minlength=nk)
            b_cnt = np.bincount(rep_node[is_bnd], minlength=nk)
            amax = max(int(a_cnt.max()) if nk else 0, 1)
            bmax = max(int(b_cnt.max()) if nk else 0, 1)
            adofs = np.full((nk, amax), n, dtype=np.int64)
            bdofs = np.full((nk, bmax), n, dtype=np.int64)
            nd_s, dof_s, bnd_s = node_front[-1]
            # slot index within (node, is_bnd) group
            grp = nd_s * 2 + bnd_s
            start = np.zeros(2 * nk + 1, dtype=np.int64)
            np.cumsum(np.bincount(grp, minlength=2 * nk), out=start[1:])
            slot = np.arange(len(grp)) - start[grp]
            am = ~bnd_s
            adofs[nd_s[am], slot[am]] = dof_s[am]
            bdofs[nd_s[~am], slot[~am]] = dof_s[~am]
            b_rows, b_inc = boundary_incidence(bdofs, n)
            self.levels.append(dict(k=k, nk=nk, amax=amax, bmax=bmax,
                                    adofs=adofs, bdofs=bdofs, b_rows=b_rows,
                                    b_inc=b_inc))

        def slot_of(level_idx, nodes, dofs):
            """Front-local slot of (node, dof) pairs at a level via
            searchsorted in the node's sorted assigned/boundary lists."""
            L = self.levels[level_idx]
            adofs, bdofs = L["adofs"], L["bdofs"]
            amax = L["amax"]
            ja = _row_searchsorted(adofs[nodes], dofs)
            hit_a = (ja < adofs.shape[1]) & \
                (adofs[nodes, np.minimum(ja, adofs.shape[1] - 1)] == dofs)
            jb = _row_searchsorted(bdofs[nodes], dofs)
            hit_b = (jb < bdofs.shape[1]) & \
                (bdofs[nodes, np.minimum(jb, bdofs.shape[1] - 1)] == dofs)
            out = np.where(hit_a, ja, amax + jb)
            out[~(hit_a | hit_b)] = amax + bdofs.shape[1]   # dump
            return out

        # leaf element assembly map
        N, C = plan.cols.shape
        le = plan.leaf_of_elem
        flat_nodes = np.repeat(le, C)
        flat_dofs = plan.cols.reshape(-1)
        self.leaf_loc = slot_of(0, flat_nodes, flat_dofs).reshape(N, C)
        self.leaf_of_elem = le
        # child-boundary -> parent-front maps, BOTH directions: cmap for
        # reference/tests, inverse (gather) maps for the device assembly
        self.child_maps = []
        self.parent_gather = []   # per internal level: (invL, invR)
        for li in range(1, depth + 1):
            Lc = self.levels[li - 1]
            Lp = self.levels[li]
            nk_c, bmax_c = Lc["nk"], Lc["bmax"]
            nk_p = Lp["nk"]
            fp = Lp["amax"] + Lp["bmax"]
            bd = Lc["bdofs"]
            nodes = np.repeat(np.arange(nk_c) // 2, bmax_c)
            dofs = bd.reshape(-1)
            cmap = slot_of(li, nodes, dofs)
            cmap[dofs >= n] = fp
            cmap = cmap.reshape(nk_c, bmax_c)
            self.child_maps.append(cmap)
            # inverse: parent slot -> child b-slot (miss -> bmax_c)
            invs = []
            for side in (0, 1):
                ip = np.full((nk_p, fp + 1), bmax_c, dtype=np.int64)
                ci = 2 * np.arange(nk_p) + side
                rows = np.repeat(ci, bmax_c)
                pslots = cmap[ci].reshape(-1)
                keep = pslots < fp
                ip[rows[keep] // 2, pslots[keep]] = \
                    np.tile(np.arange(bmax_c), nk_p)[keep]
                invs.append(ip)
            self.parent_gather.append(tuple(invs))

    def to_device(self, device=None, mesh: Mesh = None) -> "NDDev":
        """The device-side plan: the index arrays as int64 tensors on
        ``device``, or, with a ``mesh``, on its first device with the
        divisible tree levels' fronts split over the mesh (see the module
        docstring)."""
        if mesh is not None:
            device = mesh.first

        def t(a, dev=device):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        def level(L, lo=0, hi=None, dev=device):
            hi = L["nk"] if hi is None else hi
            b_rows, b_inc = ((L["b_rows"], L["b_inc"]) if (lo, hi) ==
                             (0, L["nk"]) else
                             boundary_incidence(L["bdofs"][lo:hi], self.n_J))
            return NDLevel(adofs=t(L["adofs"][lo:hi], dev),
                           bdofs=t(L["bdofs"][lo:hi], dev),
                           b_rows=t(b_rows, dev), b_inc=t(b_inc, dev),
                           k=L["k"], nk=hi - lo, amax=L["amax"],
                           bmax=L["bmax"])

        levels = tuple(level(L) for L in self.levels)
        dp = NDDev(levels=levels, leaf_of_elem=t(self.leaf_of_elem),
                   leaf_loc=t(self.leaf_loc),
                   parent_gather=tuple((t(a), t(b))
                                       for a, b in self.parent_gather),
                   depth=self.depth, n_J=self.n_J)
        if mesh is None:
            return dp
        n = mesh.size
        nsh = 0
        while nsh < len(self.levels) and self.levels[nsh]["nk"] % n == 0 \
                and self.levels[nsh]["nk"] >= n:
            nsh += 1
        parts, gathers = [], []
        for li in range(nsh):
            L = self.levels[li]
            q = L["nk"] // n
            parts.append(tuple(level(L, d * q, (d + 1) * q, dev)
                               for d, dev in enumerate(mesh.devices)))
            if li > 0:
                invL, invR = self.parent_gather[li - 1]
                gathers.append(tuple(
                    (t(invL[d * q:(d + 1) * q], dev),
                     t(invR[d * q:(d + 1) * q], dev))
                    for d, dev in enumerate(mesh.devices)))
        dp.mesh, dp.parts, dp.part_gather = mesh, tuple(parts), tuple(gathers)
        if nsh:
            dp.leaf_parts = self._leaf_parts(mesh, t)
            def fronts(L, d):        # device d's fronts' assigned dofs
                q = L["nk"] // n
                return L["adofs"][d * q:(d + 1) * q].reshape(-1)

            own = [np.unique(np.concatenate([fronts(L, d) for L in
                                             self.levels[:nsh]]))
                   for d in range(n)]
            own = [o[o < self.n_J] for o in own]
            dp.own = tuple((t(o, dev), t(o)) for o, dev in
                           zip(own, mesh.devices))
            mine = np.zeros(self.n_J + 1, bool)
            mine[np.concatenate(own)] = True
            dp.top = tuple((t(L["b_rows"][~mine[L["b_rows"]]]),
                            t(L["b_inc"][~mine[L["b_rows"]]]))
                           for L in self.levels[:nsh])
        return dp

    def _leaf_parts(self, mesh, t):
        """Per device: its leaves' elements as (shard, local indices on the
        shard's device) pieces, in element order, and their flat positions
        in the device's leaf fronts."""
        n = mesh.size
        L0 = self.levels[0]
        q, f1 = L0["nk"] // n, L0["amax"] + L0["bmax"] + 1
        N = len(self.leaf_of_elem)
        ranges = shard_ranges(mesh, N) or [(0, N)]
        devs = mesh.devices if len(ranges) == n else (mesh.first,)
        out = []
        for d, dev in enumerate(mesh.devices):
            els = np.flatnonzero(self.leaf_of_elem // q == d)
            loc = self.leaf_loc[els]
            flat = (((self.leaf_of_elem[els] - d * q)[:, None, None] * f1
                     + loc[:, :, None]) * f1 + loc[:, None, :])
            take = tuple((e, t(els[(els >= lo) & (els < hi)] - lo, de))
                         for e, ((lo, hi), de) in enumerate(zip(ranges, devs)))
            out.append((take, t(flat.reshape(-1), dev)))
        return tuple(out)


@dataclass
class NDLevel:
    adofs: torch.Tensor    # (nk, amax) assigned dof ids (n_J = pad)
    bdofs: torch.Tensor    # (nk, bmax) boundary dof ids
    b_rows: torch.Tensor   # (nr,) the level's boundary dofs, increasing
    b_inc: torch.Tensor    # (nr, Kb) their flat bdofs positions (see
                           # boundary_incidence)
    k: int
    nk: int
    amax: int
    bmax: int


@dataclass
class NDDev:
    """Device-side nested-dissection plan (the whole levels on the first
    device; under a mesh, the divisible levels' per-device parts too)."""
    levels: tuple          # of NDLevel, leaf..root
    leaf_of_elem: torch.Tensor
    leaf_loc: torch.Tensor
    parent_gather: tuple   # per internal level: (invL, invR) parent-slot ->
                           # child-b-slot maps (miss -> bmax_child)
    depth: int
    n_J: int
    mesh: Mesh = None
    parts: tuple = ()      # per divisible level (a prefix): NDLevel a device
    part_gather: tuple = ()   # per divisible level past the leaves: (invL,
                              # invR) of each device's parents
    leaf_parts: tuple = ()    # per device: ((element shard, its local
                              # indices), ...), flat leaf-front positions
    own: tuple = ()        # per device: its own rows, (on it, on the first)
    top: tuple = ()        # per divisible level: the rows of the levels
                           # above among its boundary rows, and their
                           # positions in its updates (b_inc's rows)


# ---------------------------------------------------------------------------
# numeric phase (device)
# ---------------------------------------------------------------------------

FRONTS = "linsolve.nd_factor.fronts"


@spanned("linsolve.nd_factor")
def nd_factor(dp: NDDev, He, diag_shift, factor=front_factor):
    """Batched multifrontal factorization of sum-of-element-blocks + shift.

    ``He`` (N, C, C) element blocks (already equilibrated if desired), or
    a tuple of each element shard's blocks under a mesh; ``diag_shift`` a
    scalar added to every assigned diagonal. ``factor`` factors one tree
    level's fronts (the kernel K5a; a comparison passes another). Returns
    the per-level factors ((L, U), ...) leaf..root; a divisible level's
    entry is a tuple of each device's (L, U)."""
    fact = []
    S_prev = None
    first = dp.levels[0].adofs.device
    for li, L in enumerate(dp.levels):
        if li < len(dp.parts):
            outs = []
            for d, P in enumerate(dp.parts[li]):
                if li == 0:
                    take, flat = dp.leaf_parts[d]
                    dev = flat.device
                    blocks = [dp.mesh.gather(
                        (He[e] if isinstance(He, tuple) else He)[sel], dev)
                        for e, sel in take]
                    F = _leaf_fronts(torch.cat(blocks), flat, P)
                else:
                    F = _child_fronts(S_prev[d], *dp.part_gather[li - 1][d],
                                      P.nk)
                outs.append(_factor_level(F, P, dp.n_J, diag_shift, factor))
            fact.append(tuple((Lf, U) for Lf, U, _ in outs))
            S_prev = [S for _, _, S in outs]
            continue
        if li == 0:
            if isinstance(He, tuple):
                He = torch.cat([dp.mesh.gather(h, first) for h in He])
            f1 = L.amax + L.bmax + 1
            flat = ((dp.leaf_of_elem[:, None, None] * f1
                     + dp.leaf_loc[:, :, None]) * f1
                    + dp.leaf_loc[:, None, :])
            F = _leaf_fronts(He, flat.reshape(-1), L)
        else:
            if isinstance(S_prev, list):
                S_prev = torch.cat([dp.mesh.gather(S, first)
                                    for S in S_prev])
            F = _child_fronts(S_prev, *dp.parent_gather[li - 1], L.nk)
        Lf, U, S_prev = _factor_level(F, L, dp.n_J, diag_shift, factor)
        fact.append((Lf, U))
    return tuple(fact)


@spanned(FRONTS)
def _leaf_fronts(He, flat, L):
    """The leaf fronts (nk, f+1, f+1): one scatter-add of the element
    blocks He at their flat positions."""
    f1 = L.amax + L.bmax + 1
    F = torch.zeros((L.nk * f1 * f1,), dtype=He.dtype, device=He.device)
    return scatter_add(F, flat, He.reshape(-1)).reshape(L.nk, f1, f1)


@spanned(FRONTS)
def _child_fronts(S_prev, invL, invR, nk):
    """The fronts of nk parents from their children's Schur complements,
    gathered through the parent-slot maps."""
    Sp = torch.nn.functional.pad(S_prev, (0, 1, 0, 1))
    SL, SR = Sp[0::2], Sp[1::2]
    ar = torch.arange(nk, device=S_prev.device)[:, None, None]
    return SL[ar, invL[:, :, None], invL[:, None, :]] + \
        SR[ar, invR[:, :, None], invR[:, None, :]]


def _factor_level(F, L, n_J, diag_shift, factor):
    """One tree level's fronts F: unit diagonal on padded/dummy slots, the
    shift on real assigned slots, then K5a; returns (Lf, U, S)."""
    amax, bmax = L.amax, L.bmax
    dtype, device = F.dtype, F.device
    with span(FRONTS):
        apad = L.adofs >= n_J
        bpad = L.bdofs >= n_J
        one = torch.ones((), dtype=dtype, device=device)
        zero = torch.zeros((), dtype=dtype, device=device)
        diag_a = torch.where(apad, one,
                             torch.full(L.adofs.shape, float(diag_shift),
                                        dtype=dtype, device=device))
        ii = torch.arange(amax, device=device)
        F[:, ii, ii] += diag_a
        jjb = amax + torch.arange(bmax, device=device)
        F[:, jjb, jjb] += torch.where(bpad, one, zero)
    return factor(F, amax, bmax)


def _pairs(fact):
    """Every (L, U) of a factor, a divisible level's per-device ones
    included."""
    for lvl in fact:
        yield from (lvl if isinstance(lvl[0], tuple) else (lvl,))


def nd_finite(fact) -> bool:
    """All factor entries finite (the factorization's PD certificate).
    One host sync."""
    dev = fact[-1][0].device if torch.is_tensor(fact[-1][0]) \
        else fact[-1][0][0].device
    flags = torch.stack([(torch.isfinite(Lf).all()
                          & torch.isfinite(U).all()).to(dev)
                         for Lf, U in _pairs(fact)])
    return bool(flags.all())


@spanned("linsolve.nd_solve")
def nd_solve(dp: NDDev, fact, rhs):
    """Solve H x = rhs with the factors from nd_factor (one rhs): one call of
    the kernel K5b per tree level and sweep, each updating the padded
    residual, then the padded solution, in place (per device on the
    divisible levels, see the module docstring)."""
    r = torch.cat([rhs, rhs.new_zeros(1)])
    nsh = len(dp.parts)
    ys = [None] * len(dp.levels)
    if nsh:
        upds = [[] for _ in range(nsh)]
        for d, rb in enumerate(dp.mesh.broadcast(r)):
            own = dp.own[d][0]
            rd = torch.zeros_like(rb)
            rd[own] = rb[own]
            for li in range(nsh):
                P = dp.parts[li][d]
                Lf, U = fact[li][d]
                y, upd = front_forward(Lf, U, P.adofs, rd, P.b_rows, P.b_inc)
                ys[li] = (ys[li] or ()) + (y,)
                upds[li].append(upd.reshape(-1))
        for li in range(nsh):
            # the rows of the levels above take the level's updates from
            # every device, in the order one device folds them
            rows, inc = dp.top[li]
            flat = torch.cat([dp.mesh.gather(u, r.device) for u in upds[li]]
                             + [r.new_zeros(1)])
            acc = r[rows]
            for t in range(inc.shape[1]):
                acc = acc - flat[inc[:, t]]
            r[rows] = acc
    for li in range(nsh, len(dp.levels)):
        L = dp.levels[li]
        Lf, U = fact[li]
        ys[li] = front_forward(Lf, U, L.adofs, r, L.b_rows, L.b_inc)[0]
    x = torch.zeros_like(r)
    for li in range(len(dp.levels) - 1, nsh - 1, -1):
        L = dp.levels[li]
        Lf, U = fact[li]
        front_backward(Lf, U, L.adofs, L.bdofs, ys[li], x)
    if nsh:
        for d, xd in enumerate(dp.mesh.broadcast(x, copy=True)):
            for li in range(nsh - 1, -1, -1):
                P = dp.parts[li][d]
                Lf, U = fact[li][d]
                front_backward(Lf, U, P.adofs, P.bdofs, ys[li][d], xd)
            own, own_first = dp.own[d]
            x[own_first] = dp.mesh.gather(xd[own], x.device)
    return x[:-1]


def nd_memory_report(dp: NDDev) -> dict:
    """Memory model of the factorization (bytes, float64), per level and
    in all (the reference's ``nd_memory_report``, ``mgbtpu/ops/
    ndchol.py:791``, without its double-float words): the stored factor
    blocks (L: nk amax^2, U: nk bmax amax) and the peak transient
    front/Schur pair of a level (F: nk (f+1)^2, S: nk bmax^2, alive only
    while that level factors). Per device: under a mesh a divisible
    level's blocks lie 1/n on each device and the levels above on the
    first; ``device_factor_bytes[d]`` is device d's share, the first
    device's including the top of the tree."""
    word = 8
    n = 1 if dp.mesh is None else dp.mesh.size
    per_level, dev_bytes = [], [0] * n
    factor = peak = 0
    for li, L in enumerate(dp.levels):
        f = L.amax + L.bmax
        fb = L.nk * (L.amax * L.amax + L.bmax * L.amax) * word
        tb = L.nk * ((f + 1) * (f + 1) + L.bmax * L.bmax) * word
        sharded = li < len(dp.parts)
        for d in range(n):
            dev_bytes[d] += fb // n if sharded else (fb if d == 0 else 0)
        factor += fb
        peak = max(peak, tb // n if sharded else tb)
        per_level.append(dict(k=L.k, nk=L.nk, amax=L.amax, bmax=L.bmax,
                              factor_bytes=fb, transient_bytes=tb,
                              device_bytes=fb // n if sharded else fb,
                              sharded=sharded))
    return dict(levels=per_level, factor_bytes=factor,
                peak_transient_bytes=peak, peak_bytes=factor + peak,
                device_factor_bytes=dev_bytes)


# ---------------------------------------------------------------------------
# numpy reference numeric (correctness oracle for the tests)
# ---------------------------------------------------------------------------

def nd_factor_ref(plan: NDPlan, He: np.ndarray, jitter: float = 0.0):
    """Reference multifrontal factorization in numpy float64: returns the
    per-node dict {(k, i): (A_dofs, B_dofs, L_A, U)} bottom-up."""
    depth = plan.depth
    He = np.asarray(He, np.float64)
    fronts = {}   # (k, i) -> (dofs array, dense front)
    fact = {}
    # leaf assembly
    for i in range(1 << depth):
        a, b = plan.front_dofs(depth, i)
        dofs = np.concatenate([a, b])
        loc = {d: j for j, d in enumerate(dofs)}
        F = np.zeros((len(dofs), len(dofs)))
        for e in np.flatnonzero(plan.leaf_of_elem == i):
            ll = np.array([loc[d] for d in plan.cols[e]])
            np.add.at(F, (ll[:, None], ll[None, :]), He[e])
        F[np.arange(len(a)), np.arange(len(a))] += jitter
        fronts[(depth, i)] = (dofs, F)
    for k in range(depth, -1, -1):
        for i in range(1 << k):
            if (k, i) not in fronts:      # internal: gather children schur
                a, b = plan.front_dofs(k, i)
                dofs = np.concatenate([a, b])
                loc = {d: j for j, d in enumerate(dofs)}
                F = np.zeros((len(dofs), len(dofs)))
                for ch in ((k + 1, 2 * i), (k + 1, 2 * i + 1)):
                    bd, S = fronts.pop(("S",) + ch)
                    ll = np.array([loc[d] for d in bd], dtype=np.int64)
                    if len(ll):
                        np.add.at(F, (ll[:, None], ll[None, :]), S)
                F[np.arange(len(a)), np.arange(len(a))] += jitter
                fronts[(k, i)] = (dofs, F)
            dofs, F = fronts.pop((k, i))
            a_n = len(plan.front_dofs(k, i)[0])
            A = F[:a_n, :a_n]
            Bc = F[a_n:, :a_n]
            Cc = F[a_n:, a_n:]
            L_A = np.linalg.cholesky(A) if a_n else np.zeros((0, 0))
            U = np.linalg.solve(L_A, Bc.T).T if a_n else \
                np.zeros((len(dofs), 0))
            S = Cc - U @ U.T
            fact[(k, i)] = (dofs[:a_n], dofs[a_n:], L_A, U)
            if k > 0:
                fronts[("S", k, i)] = (dofs[a_n:], S)
    return fact


def nd_solve_ref(plan: NDPlan, fact, rhs: np.ndarray):
    depth = plan.depth
    r = np.asarray(rhs, np.float64).copy()
    ys = {}
    for k in range(depth, -1, -1):
        for i in range(1 << k):
            A_d, B_d, L_A, U = fact[(k, i)]
            y = np.linalg.solve(L_A, r[A_d]) if len(A_d) else np.zeros(0)
            ys[(k, i)] = y
            if len(B_d):
                r[B_d] -= U @ y
    x = np.zeros_like(r)
    for k in range(0, depth + 1):
        for i in range(1 << k):
            A_d, B_d, L_A, U = fact[(k, i)]
            if len(A_d):
                t = ys[(k, i)] - U.T @ x[B_d]
                x[A_d] = np.linalg.solve(L_A.T, t)
    return x

"""K6 ``node_barrier``: the per-node barrier of any piece table, fused with
the level's weight mask and linear term.

Replaces the Pallas kernel ``node_eval`` (``mgbtpu/ops/pallas_dd.py:258``,
call :353), which ran ``vmap(F)`` of any traced per-node barrier; on the x64
path that is ``jax.vmap(F)`` (``mgbtpu/solver/barrier.py:59``) of
``convex_linear`` (``mgbtpu/convex/linear.py:84-137``), of
``convex_piecewise``/``intersect`` (``mgbtpu/convex/piecewise.py``), and of
the phase-I feasibility wrapper (``mgbtpu/solver/mgb.py:928``) around any of
them. K2 (``power_cone.py``) keeps the lone power cone's barrier; K6 takes
every other case.

A barrier is a table of at most 4 ``Piece``s, each a power cone (nz <= 5)
or a linear block (nc <= 4, ni <= 5) reading the rows ``idx`` of y, and an
optional select grid (m, pieces): piece k is active at a node where its
column is nonzero. Per node::

    mode 0:  bw T (0 where bw == 0) + <wc, y>           -> (m,)
    mode 1:  bw T (0 where bw == 0) + wc                -> (m, ny)
    mode 2:  bw T (0 where bw == 0)                     -> (m, ny, ny)

where T sums, in piece order, each active piece's F0, F1 scattered to the
row width, or F2 scattered to its square; an inactive piece contributes an
exact 0 (dropped with ``where``, never multiplied), as ``convex_piecewise``
composes them. ``co=NC`` gives the cobarrier form: y[:, NC-1] is the slack,
added to each cone's s and to each linear row, and the slack's gradient
entry, cross row/column and corner are the reference's C1/C2. With
``box=(b, R)`` the phase-I box terms of ``make_feasibility_fs`` are added
over the rows NC.. of y.

CUDA design (``csrc/node_barrier.cu``; the closed forms in
``csrc/power_cone.cuh``, shared with K2, and ``csrc/linear.cuh``): one
kernel per (mode, form), the form the barrier, the cobarrier or the
cobarrier with the box; one thread per node in blocks of 32 nodes (64 above
8,448 nodes, 16 where ny x ny rows would pass 48 KB of shared memory). A
block stages its nodes' rows and every piece's grids in shared memory with
coalesced ``cp.async`` copies, then loops over the pieces, switching per
piece to the instance of its shape that ``instance`` picks: a power cone on
(nz, spec), a linear block on (nc, ni) for the shapes the constructors
build, a runtime-width linear block for the rest. Every instance keeps its
small arrays in registers (no kernel has a stack frame). Modes 1 and 2
build each node's row or ny x ny block in shared memory as the left fold
over the pieces (an exact +0.0 added where a piece leaves an earlier
piece's entry alone) and store the block's rows contiguous; ny <= 12.
Built with ``--fmad=false`` and following the plain version below operation
by operation, so it gives the plain version's bits. What bounds it on an
H100: bytes (a few hundred flops per node against the pieces' grids and the
ny + ny^2 doubles in and out); at L=5 the call is launch-bound.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace

import torch

from . import _build as B
from . import power_cone as K2
from ..convex._common import gather, mat_cols, scatter_mat, scatter_vec, ssum
from ..utils.log import Log, barrier_floor

NAME = "node_barrier"
POWER, LINEAR = 0, 1
MAX_PIECES, MAX_ROWS = 4, 12


@dataclass(frozen=True)
class Piece:
    """One piece of a barrier: its kind, the input rows ``idx`` (0-based) it
    reads, its ``width`` (nz of a power cone, nc of a linear block), the
    power cone's alpha specialisation ``spec`` (2 for p = 1, 1 for p = 2, 0
    otherwise) and the ``offset`` of its grids in the Convex's args:
    A (m, nz*nz), b (m, nz), p (m,), mu (m,) for a power cone; A
    (m, nc*ni), b (m, nc) for a linear block (ni = len(idx))."""
    kind: int
    idx: tuple
    width: int
    spec: int = 0
    offset: int = 0

    def grids(self, args):
        return args[self.offset:self.offset + (4 if self.kind == POWER else 2)]

    def shifted(self, by: int) -> "Piece":
        return replace(self, offset=self.offset + by)


def linear_parts(A, b, idx, y, slack=None):
    """F = A y[idx] + b (+ slack) as a list of (m,) columns, with A as a
    nested list (``mgbtpu/convex/linear.py`` ``_parts``)."""
    nc, ni = b.shape[1], len(idx)
    Ac = mat_cols(A, nc, ni)
    ys = gather(idx, y)
    F = [ssum([Ac[i][j] * ys[j] for j in range(ni)]) + b[:, i]
         for i in range(nc)]
    if slack is not None:
        F = [Fi + slack for Fi in F]
    return Ac, F


def _piece_plain(mode, pc, grids, y, nin, slack):
    """One piece's F0, F1 scattered to ``nin`` rows, or F2 scattered to
    nin x nin; in the cobarrier form (``slack`` given) with the slack's
    entry, row and column appended."""
    co = slack is not None
    if pc.kind == POWER:
        A, b, p, mu = grids
        nz = pc.width
        q, s = K2.core_parts(A, b, pc.idx, y)
        if co:
            s = s + slack
        if mode == 0:
            return K2.core_value(q, s, p, mu, pc.spec)
        if mode == 1:
            gz = K2.core_grad(q, s, p, mu, pc.spec)
            g, gl = K2.at_g(A, gz, nz), gz[-1]
        else:
            Hz = K2.core_hess(q, s, p, mu, pc.spec)
            H = K2.at_h_a(A, Hz, nz)
            cr = K2.at_g(A, [Hz[k][nz - 1] for k in range(nz)], nz)
            cn = Hz[nz - 1][nz - 1]
    else:
        A, b = grids
        Ac, F = linear_parts(A, b, pc.idx, y, slack)
        nc, ni = len(F), len(pc.idx)
        if mode == 0:
            return -ssum([Log(Fi) for Fi in F])
        if mode == 1:
            invF = [1.0 / Fi for Fi in F]
            g = [-ssum([Ac[k][i] * invF[k] for k in range(nc)])
                 for i in range(ni)]
            gl = -ssum(invF)
        else:
            if co:
                inv = [1.0 / Fi for Fi in F]
                iF2 = [vi * vi for vi in inv]
            else:
                iF2 = [1.0 / (Fi * Fi) for Fi in F]
            H = [[ssum([Ac[k][i] * Ac[k][j] * iF2[k] for k in range(nc)])
                  for j in range(ni)] for i in range(ni)]
            cr = [ssum([Ac[k][i] * iF2[k] for k in range(nc)])
                  for i in range(ni)]
            cn = ssum(iF2)
    like = y[:, 0]
    if mode == 1:
        out = scatter_vec(pc.idx, g, nin, like)
        return torch.cat([out, gl[:, None]], dim=1) if co else out
    Hs = scatter_mat(pc.idx, H, nin, like)
    if not co:
        return Hs
    cross = scatter_vec(pc.idx, cr, nin, like)
    top = torch.cat([Hs, cross[:, :, None]], dim=2)
    return torch.cat([top, torch.cat([cross, cn[:, None]], dim=1)[:, None]],
                     dim=1)


def _box_plain(mode, T, y, NC, b, R):
    """The phase-I box terms of ``make_feasibility_fs`` (reference
    ``src/mgb.jl:190-287``) added to the cobarrier's T: u = y[:, NC-1] in
    (-b, b), each v_i = y[:, NC+i] in (-R, R)."""
    nin = NC - 1
    u, v = y[:, nin], y[:, NC:]
    if mode == 0:
        sv = ssum([-Log(R - v[:, i]) - Log(R + v[:, i])
                   for i in range(v.shape[1])])
        return T - Log(b - u) - Log(b + u) + sv
    if mode == 1:
        gs = 1.0 / (b - u) - 1.0 / (b + u)
        gv = 1.0 / (R[:, None] - v) - 1.0 / (R[:, None] + v)
        return torch.cat([T[:, :nin], (T[:, nin] + gs)[:, None], gv], dim=1)
    ibm, ibp = 1.0 / (b - u), 1.0 / (b + u)
    ivm, ivp = 1.0 / (R[:, None] - v), 1.0 / (R[:, None] + v)
    ny = y.shape[1]
    H = torch.zeros((y.shape[0], ny, ny), dtype=y.dtype, device=y.device)
    H[:, :NC, :NC] = T
    H[:, nin, nin] += ibm * ibm + ibp * ibp
    ar = torch.arange(NC, ny, device=y.device)
    H[:, ar, ar] += ivm * ivm + ivp * ivp
    return H


def node_barrier_plain(mode, Dz, pieces, args, sel, bw, wc, co=None,
                       box=None):
    """Plain PyTorch version of the kernel (same arithmetic, same order)."""
    m, ny = Dz.shape
    nin = ny if co is None else co - 1
    slack = None if co is None else Dz[:, nin]
    T = None
    for k, pc in enumerate(pieces):
        val = _piece_plain(mode, pc, pc.grids(args), Dz, nin, slack)
        if sel is not None:
            act = (sel[:, k] != 0).reshape((m,) + (1,) * (val.dim() - 1))
            val = torch.where(act, val, torch.zeros_like(val))
        T = val if T is None else T + val
    if box is not None:
        T = _box_plain(mode, T, Dz, co, *box)
    if mode == 0:
        lin = ssum([wc[:, k] * Dz[:, k] for k in range(ny)])
        return torch.where(bw != 0, bw * T, torch.zeros_like(T)) + lin
    bwx = bw.reshape((m,) + (1,) * (T.dim() - 1))
    out = torch.where(bwx != 0, bwx * T, torch.zeros_like(T))
    return out + wc if mode == 1 else out


# Instance codes of csrc/node_barrier.cu: a power cone (nz, spec) is
# (nz - 2) * 3 + spec; the linear shapes the constructors build (nc, ni) in
# LINEAR_SHAPES follow; every other linear block takes the runtime-width
# instance.
LINEAR_SHAPES = ((1, 1), (2, 1))
LINEAR_ANY = 12 + len(LINEAR_SHAPES)
FORMS = ("barrier", "cobarrier", "cobarrier + box")


def instance_code(kind: int, width: int, ni: int, spec: int) -> int:
    """The kernel instance of one piece shape, -1 outside the kernel's
    limits (power cone 2 <= nz <= 5 reading nz rows, spec 0/1/2; linear
    block nc <= 4, ni <= 5)."""
    if kind == POWER:
        if 2 <= width <= 5 and ni == width and spec in (0, 1, 2):
            return (width - 2) * 3 + spec
        return -1
    if kind != LINEAR or not (1 <= width <= 4 and 1 <= ni <= 5):
        return -1
    if (width, ni) in LINEAR_SHAPES:
        return 12 + LINEAR_SHAPES.index((width, ni))
    return LINEAR_ANY


def instance_name(code: int) -> str:
    if code < 12:
        return f"power<{code // 3 + 2}, {code % 3}>"
    if code < LINEAR_ANY:
        return "linear<%d, %d>" % LINEAR_SHAPES[code - 12]
    return "linear<runtime>"


@dataclass(frozen=True)
class Instance:
    """The kernel a call launches, (mode, form), and the instance code of
    each piece (see ``instance``)."""
    mode: int
    form: int
    codes: tuple

    def __str__(self):
        return (f"node_barrier_kernel<mode {self.mode}, {FORMS[self.form]}>"
                f" [{', '.join(instance_name(c) for c in self.codes)}]")


def instance(pieces, mode, ny, co=None, box=False) -> Instance:
    """The kernel and per-piece instances that run ``pieces`` in ``mode``
    over ny rows (``co`` the cobarrier width or None, ``box`` the phase-I
    box); raises ValueError for a table outside the kernel's limits, on any
    device."""
    npc = len(pieces)
    B.require(mode in (0, 1, 2), NAME, f"mode {mode}")
    B.require(1 <= npc <= MAX_PIECES, NAME, f"{npc} pieces")
    B.require(1 <= ny <= MAX_ROWS, NAME, f"{ny} rows exceed {MAX_ROWS}")
    if co is None:
        B.require(not box, NAME, "the box needs the cobarrier form")
        nin = ny
    else:
        B.require(2 <= co <= ny and (box or co == ny), NAME,
                  f"cobarrier width {co} of {ny} rows")
        B.require(not box or co < ny, NAME,
                  "the box needs at least one component row")
        nin = co - 1
    codes = []
    for pc in pieces:
        B.require(all(0 <= i < nin for i in pc.idx), NAME, f"idx {pc.idx}")
        code = instance_code(pc.kind, pc.width, len(pc.idx), pc.spec)
        B.require(code >= 0, NAME, f"piece {pc} outside the kernel's limits")
        codes.append(code)
    form = 0 if co is None else (2 if box else 1)
    return Instance(mode, form, tuple(codes))


# ctypes mirrors of NBPiece and NBTable in csrc/node_barrier.cu: the field
# order and types must match the C structs (checked when the library loads,
# ``check_layout``).
class _Piece(ctypes.Structure):
    _fields_ = [("A", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("p", ctypes.c_void_p), ("mu", ctypes.c_void_p),
                ("kind", ctypes.c_int), ("nz", ctypes.c_int),
                ("ni", ctypes.c_int), ("spec", ctypes.c_int),
                ("idx", ctypes.c_int * 5), ("inst", ctypes.c_int)]


class _Table(ctypes.Structure):
    _fields_ = [("pc", _Piece * MAX_PIECES), ("y", ctypes.c_void_p),
                ("sel", ctypes.c_void_p), ("bw", ctypes.c_void_p),
                ("wc", ctypes.c_void_p), ("boxb", ctypes.c_void_p),
                ("boxR", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("floor", ctypes.c_double), ("npc", ctypes.c_int),
                ("mode", ctypes.c_int), ("m", ctypes.c_int),
                ("ny", ctypes.c_int), ("nc_co", ctypes.c_int)]


_ARGS = [ctypes.POINTER(_Table), ctypes.c_void_p]
# node_barrier_table_offset(field) of the C library, field by field
LAYOUT = (("pc", _Table.pc.offset), ("y", _Table.y.offset),
          ("nc_co", _Table.nc_co.offset), ("sizeof NBPiece",
                                           ctypes.sizeof(_Piece)),
          ("idx", _Piece.idx.offset), ("inst", _Piece.inst.offset))


def check_layout(table_size, table_offset):
    """Raise unless the C library's NBTable/NBPiece layout is the ctypes
    mirror's: ``table_size()`` and ``table_offset(field)`` are its exported
    entries. (The C entry refuses, at every launch, a piece whose instance
    code is not the one it computes.)"""
    bad = []
    if table_size() != ctypes.sizeof(_Table):
        bad.append(f"sizeof NBTable {table_size()} != "
                   f"{ctypes.sizeof(_Table)}")
    for field, (label, want) in enumerate(LAYOUT):
        got = table_offset(field)
        if got != want:
            bad.append(f"{label} at {got} != {want}")
    if bad:
        raise RuntimeError(f"mgbtpu_torch.{NAME}: the library disagrees with"
                           f" its ctypes mirror: {'; '.join(bad[:8])}")


def _launcher():
    """The kernel's C entry, its library's layout checked at first use."""
    fn = _LAUNCH.get("fn")
    if fn is None:
        check_layout(
            B.launcher(NAME, [], "node_barrier_table_size"),
            B.launcher(NAME, [ctypes.c_int], "node_barrier_table_offset"))
        fn = _LAUNCH["fn"] = B.launcher(NAME, _ARGS)
    return fn


_LAUNCH: dict = {}


def _check_grids(pc, grids, m):
    ni = len(pc.idx)
    if pc.kind == POWER:
        nz = pc.width
        shapes = ((m, nz * nz), (m, nz), (m,), (m,))
    else:
        nc = pc.width
        shapes = ((m, nc * ni), (m, nc))
    for t, shape, label in zip(grids, shapes, ("A", "b", "p", "mu")):
        B.cuda_f64(NAME, t, shape, label)


def node_barrier(mode, Dz, pieces, args, sel, bw, wc, co=None, box=None):
    """Dz (m, ny) rows, ``pieces`` a tuple of ``Piece`` whose grids lie in
    ``args``, ``sel`` the (m, pieces) select grid or None (all active), bw
    (m,), wc (m, ny); ``co`` the cobarrier width NC (None: the barrier),
    ``box`` the phase-I (b, R) grids, (m,) each, or None. Returns the mode's
    per-node output (see the module docstring)."""
    pieces = tuple(pieces)
    inst = instance(pieces, mode, Dz.shape[1], co, box is not None)
    grids = [g for pc in pieces for g in pc.grids(args)]
    if not B.on_cuda(NAME, Dz, sel, bw, wc, *(box or ()), *grids):
        return node_barrier_plain(mode, Dz, pieces, args, sel, bw, wc, co, box)
    m, ny = Dz.shape
    npc = len(pieces)
    B.cuda_f64(NAME, Dz, (m, ny), "Dz")
    B.cuda_f64(NAME, bw, (m,), "bw")
    B.cuda_f64(NAME, wc, (m, ny), "wc")
    if sel is not None:
        B.cuda_f64(NAME, sel, (m, npc), "sel")
    if box is not None:
        for t, label in zip(box, ("b", "R")):
            B.cuda_f64(NAME, t, (m,), label)
    t = _Table()
    for k, (pc, code) in enumerate(zip(pieces, inst.codes)):
        g = pc.grids(args)
        _check_grids(pc, g, m)
        P = t.pc[k]
        P.A, P.b = g[0].data_ptr(), g[1].data_ptr()
        if pc.kind == POWER:
            P.p, P.mu = g[2].data_ptr(), g[3].data_ptr()
        P.kind, P.nz, P.ni, P.spec = pc.kind, pc.width, len(pc.idx), pc.spec
        P.inst = code
        for j, i in enumerate(pc.idx):
            P.idx[j] = i
    shape = ((m,), (m, ny), (m, ny, ny))[mode]
    out = torch.empty(shape, dtype=torch.float64, device=Dz.device)
    t.y, t.bw, t.wc, t.out = (x.data_ptr() for x in (Dz, bw, wc, out))
    t.sel = None if sel is None else sel.data_ptr()
    if box is not None:
        t.boxb, t.boxR = box[0].data_ptr(), box[1].data_ptr()
    t.floor = barrier_floor(torch.float64)
    t.npc, t.mode, t.m, t.ny = npc, mode, m, ny
    t.nc_co = 0 if co is None else co
    err = _launcher()(ctypes.byref(t), B.stream(Dz.device))
    B.check(NAME, err)
    node_barrier.launches += 1
    if co is not None:
        node_barrier.co_launches += 1
    return out


node_barrier.launches = 0
node_barrier.co_launches = 0    # of which in the cobarrier (phase-I) form

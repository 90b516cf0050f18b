#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mgbtpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the check: kernels + solves
    python3 chip_smoke.py --level 7       # also K1/K2/K6 and one solve at L=7
    python3 chip_smoke.py --profile       # also profile one L=5 solve

In order: prints the card's name and power limit; builds the seven CUDA
kernels from ``mgbtpu_torch/kernels/csrc`` (one nvcc per source, in
parallel, with ``-Xptxas -v``) and prints K6's build seconds and the
registers, stack and spills of each of its functions; prints the launch
floor (the device time of an empty kernel, timed as the kernels are);
holds each kernel against its plain PyTorch version on the card at the
fem2d_P2 L=5 top-level shapes (seeded inputs;
K3 and K4 also at the coarsest level, where a column has hundreds of
slots; K3, K4 and K5a
called twice, the repeat bitwise equal; the front kernels on every tree
level of that level's nested dissection, K5a also on seeded SPD fronts at
the 11 tree levels of the L=7 plan, K5b in both sweeps of its fused level
call and as a whole ``nd_solve`` against the plain composition, repeat
bitwise equal; K1, K3 and K4 also at the 9 and 11 rows of the phase-I
systems; K6 on the piece tables of two_sided_obstacle, rof, p_harmonic
and parabolic_solve in modes 0/1/2 and in the phase-I cobarrier form, with
~1 % infeasible nodes and a select mask that switches a piece off where it
is infinite; max relative error <= 1e-12, identical non-finite patterns;
K2 and K6 bitwise equal to their plain versions, K1's repeat call bitwise
equal) and times kernel, plain version and, where one exists, a single
PyTorch library call (device time per call, the host hidden behind a spin
kernel; K5b per ``nd_solve`` and per launch, against the same sweeps'
``torch.linalg.solve_triangular``; K5a per ``nd_factor`` at L=5 and L=7,
against the composition of ``cholesky_ex``, ``solve_triangular`` and
``baddbmm``). Then the solves, each through the entry
points a user calls, with the launch counters set to 0 just before and read
just after: fem2d_P2, p=1, L=5 twice (K1-K5 must launch; the second solve
bitwise equal to the first); zoo.two_sided_obstacle and parabolic_solve
(p=1, h=0.5, 2 implicit steps, each a phase I and a main ramp) at L=5; the
six zoo problems at L=3 and p_harmonic at L=3 from an infeasible start
(phase I over 11 rows); K2's launches in the second p=1 L=5 solve are
also printed by mode. K6 must launch in every solve of a piece table, in
the cobarrier form in every phase I. Each ``--level L`` then holds K1, K2
and K6 against their plain versions and times them at level L's top-level
shapes (K6 on the obstacle table and parabolic_solve's pair on random rows,
bitwise in all six calls, timed on the obstacle's Hessian and the pair's
phase-I Hessian), and solves fem2d_P2 p=1 at L once, printing that
solve's launches per kernel (K2's by mode). Each solution and its Newton
iterations are held against the stored JAX x64 run
(``mgbtpu_torch/data/*.npz``): relative 2-norm error <= 1e-6; Newton
iterations within 5 % (for the zoo and parabolic solves: the main ramp's
steps but the last within 5 %, the last, an exact-stopping polish decided
at the objective's roundoff floor, within +-4; phase I within 5 %); and the
zoo's behavioural checks (obstacles respected, |grad u| <= smax, s^2 >=
|grad u|^2 + 1). Prints one JSON line of kernel records, then ``{"ok":
true, "device": {...}}`` as the last line. Exits non-zero, before that
line, on any failure or without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOPS = 34e12             # H100 SXM FP64, non-tensor (NVIDIA data sheet)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "mgbtpu_torch", "data")
REF = os.path.join(DATA, "ref_fem2d_p2_L5.npz")
TOL_KERNEL = 1e-12
TOL_Z = 1e-6
TOL_ITS = 0.05
FLOOR_ITS = 4     # the exact-stopping polish at the roundoff floor
ZOO = ("p_harmonic", "norton_hoff", "rof", "two_sided_obstacle",
       "elastoplastic_torsion", "minimal_surface")
LONE_CONE = ("p_harmonic", "norton_hoff", "minimal_surface")   # K2, not K6


def wall_ms(fn, reps=200, warm=5):
    """Milliseconds per call of fn() over ``reps`` back-to-back calls, from
    CUDA events. At the L=5 sizes a call's device work is shorter than its
    host-side launch, so this is the rate at which the host launches."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_us(averages):
    """Device microseconds in a torch.profiler run's ``key_averages()``:
    kernels and copies only (the rows of the CPU-side ops repeat their
    kernels' time)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation)


def device_ms(fn, reps=50):
    """Device milliseconds per call of fn(): ``reps`` calls enqueued behind a
    spin kernel (``torch.cuda._sleep``), so the device runs them back to
    back without waiting on the host, timed by CUDA events. Returns
    (ms, hidden): ``hidden`` is False when the host was still enqueueing
    as the device reached the first call, and the time is then an upper
    bound."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(4e9 * reps * (time.perf_counter() - t0)) + 10 ** 6
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        hidden = not a.query()
        b.synchronize()
        if hidden:
            break
        cycles *= 4
    return a.elapsed_time(b) / reps, hidden


def timings(name, kernel, plain, library=None, plain_reps=50, reps=50):
    """Device ms per call of the kernel, its plain version and the library
    call (None without one); prints the host launch rate beside them. A
    call of many launches takes fewer ``reps``: the launches behind the
    spin kernel must fit in the device's queue, or the host waits on it."""
    out, notes = {}, []
    for key, fn, n in (("ms", kernel, reps), ("plain_ms", plain, plain_reps),
                       ("library_ms", library, reps)):
        if fn is None:
            out[key] = None
            continue
        out[key], hidden = device_ms(fn, n)
        if not hidden:
            notes.append(key)
    print(f"[time] {name}: device ms per call: kernel {out['ms']!r}, plain "
          f"{out['plain_ms']!r}, library {out['library_ms']!r}; wall ms per "
          f"call (host launch rate): kernel {wall_ms(kernel)!r}"
          + (f"; host not hidden (upper bounds): {notes}" if notes else ""))
    return out


def bound_ms(nbytes, nops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / F64_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare(name, out, ref):
    """Max abs and max relative (to max |ref|) error over finite entries;
    the non-finite patterns must be identical."""
    import torch

    same = bool(((torch.isnan(out) == torch.isnan(ref))
                 & (torch.isposinf(out) == torch.isposinf(ref))
                 & (torch.isneginf(out) == torch.isneginf(ref))).all())
    if not same:
        raise RuntimeError(f"{name}: non-finite pattern differs from plain")
    fin = torch.isfinite(ref)
    err = float((out[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    scale = float(ref[fin].abs().max()) if fin.any() else 1.0
    rel = err / max(scale, 1e-300)
    print(f"[kernel] {name}: max_abs_err={err!r} max_rel_err={rel!r}")
    if rel > TOL_KERNEL:
        raise RuntimeError(f"{name}: relative error {rel} > {TOL_KERNEL}")
    return err


def same_bits(name, out, again, what="a repeat call"):
    """``again`` (by default a repeat call; no atomics in the kernels) must
    hold the same bits as ``out``."""
    import torch

    if not torch.equal(out.view(torch.int64), again.view(torch.int64)):
        raise RuntimeError(f"{name}: {what} gave other bits")
    print(f"[kernel] {name}: bitwise equal to {what}")


def csr_of_panels(ops, transpose=False):
    """G (N*p*nD x n_J) as a CUDA CSR tensor, for the library yardstick."""
    import torch

    nD, N, p, C = ops.panels.shape
    dev = ops.panels.device
    e = torch.arange(N, device=dev)[None, :, None, None]
    q = torch.arange(p, device=dev)[None, None, :, None]
    k = torch.arange(nD, device=dev)[:, None, None, None]
    rows = ((e * p + q) * nD + k).expand(nD, N, p, C).reshape(-1)
    cols = ops.cols[None, :, None, :].expand(nD, N, p, C).reshape(-1)
    idx = torch.stack([cols, rows]) if transpose else torch.stack([rows, cols])
    shape = (ops.n_J, N * p * nD) if transpose else (N * p * nD, ops.n_J)
    return torch.sparse_coo_tensor(idx, ops.panels.reshape(-1),
                                   shape).coalesce().to_sparse_csr()


def fwd_cone_phases(prob, ops, torch, K, rng, tag):
    """K1 and K2 at a level's top-level shapes (``ops``, the problem's
    cone grids), each against its plain version (K2 bitwise, every mode;
    K1's repeat call bitwise) and timed: K1 against its plain version and
    ``torch.addmv`` on G in CSR, K2 in each mode. Returns their records."""
    from mgbtpu_torch.solver.mgb import barrier_weights

    dev = torch.device("cuda")
    M = prob.M[0]
    nD, N, p, C = ops.panels.shape
    n_J, m = ops.n_J, ops.N * ops.p

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    f8 = 8
    panel_bytes = f8 * (nD * N * p * C + N * C)

    # K1 panel_fwd
    s = t(rng.standard_normal(n_J))
    dz0 = t(rng.standard_normal((m, nD)))
    out = K.panel_fwd(ops.panels, ops.cols, s, dz0)
    err = compare(f"panel_fwd {tag}", out,
                  K.panel_fwd_plain(ops.panels, ops.cols, s, dz0))
    same_bits(f"panel_fwd {tag}", out,
              K.panel_fwd(ops.panels, ops.cols, s, dz0))
    G = csr_of_panels(ops)
    dzf = dz0.reshape(-1)
    compare(f"panel_fwd {tag} library", torch.addmv(dzf, G, s).reshape(m, nD),
            K.panel_fwd_plain(ops.panels, ops.cols, s, dz0))
    b, o = bound_ms(panel_bytes + f8 * (n_J + 2 * m * nD),
                    2 * nD * m * C + m * nD)
    k1 = dict(
        name="panel_fwd", source="mgbtpu_torch/kernels/csrc/panel_fwd.cu",
        replaces="mgbtpu/ops/pallas_dd.py:186", max_abs_err=err,
        bound_ms=b, bound_by=o, **timings(
            f"panel_fwd {tag}",
            lambda: K.panel_fwd(ops.panels, ops.cols, s, dz0),
            lambda: K.panel_fwd_plain(ops.panels, ops.cols, s, dz0),
            lambda: torch.addmv(dzf, G, s)))
    print(f"[bound] panel_fwd {tag}: {b!r} ms ({o})")

    # K2 power_cone_eval, every mode (the record: mode 2, the Hessians)
    A, bb, pp, mu = (t(a) for a in prob.Q.args)
    q = rng.standard_normal((m, 2))
    Dz = np.zeros((m, nD))
    Dz[:, 0] = rng.standard_normal(m)
    Dz[:, 1:3] = q
    Dz[:, 3] = np.sqrt((q ** 2).sum(axis=1)) + rng.uniform(1e-3, 1.0, m)
    bad = rng.choice(m, m // 100, replace=False)
    Dz[bad, 3] = -rng.uniform(0.0, 1.0, len(bad))      # infeasible nodes
    Dz = t(Dz)
    w = np.asarray(M.w, np.float64)
    bw = t(barrier_weights(w, None))
    wc = t(w[:, None] * (1e3 * prob.f_grid))
    idx, nz = (1, 2, 3), 3
    errs, bounds = [], []
    for mode in (0, 1, 2):
        out = K.power_cone_eval(mode, Dz, A, bb, pp, mu, bw, wc, idx, 2)
        ref = K.power_cone_plain(mode, Dz, A, bb, pp, mu, bw, wc, idx, 2)
        errs.append(compare(f"power_cone {tag} mode {mode}", out, ref))
        same_bits(f"power_cone {tag} mode {mode}", out, ref,
                  "the plain version")
        ms, _ = device_ms(lambda: K.power_cone_eval(mode, Dz, A, bb, pp, mu,
                                                    bw, wc, idx, 2))
        # inputs (wc but in mode 2) and the mode's output, (1, nD, nD^2)
        bounds.append(bound_ms(
            f8 * m * (nD + nz * nz + nz + 3 + (nD if mode < 2 else 0)
                      + (1, nD, nD * nD)[mode]),
            m * (5 * nz * nz + 30
                 + (2 * nz ** 4 + nD * nD if mode == 2 else 0))))
        print(f"[time] power_cone {tag} mode {mode}: device ms per call "
              f"{ms!r}; bound {bounds[-1][0]!r} ms ({bounds[-1][1]})")
    b, o = bounds[2]
    k2 = dict(
        name="power_cone", source="mgbtpu_torch/kernels/csrc/power_cone.cu",
        replaces="mgbtpu/ops/pallas_dd.py:258", max_abs_err=max(errs),
        bound_ms=b, bound_by=o, **timings(
            f"power_cone {tag} mode 2",
            lambda: K.power_cone_eval(2, Dz, A, bb, pp, mu, bw, wc, idx, 2),
            lambda: K.power_cone_plain(2, Dz, A, bb, pp, mu, bw, wc, idx, 2),
            plain_reps=2))
    return k1, k2


def top_level_ops(prob, tag, torch):
    """The panel operators of the problem's top level, on the card."""
    from mgbtpu_torch.solver.levelops import build_panel_ops

    M = prob.M[0]
    t0 = time.time()
    ops = build_panel_ops(M.D_fine, M.nu, M.R_fine[-1],
                          M.geometry.x.shape[0], torch.device("cuda"))
    nD, N, p, C = ops.panels.shape
    print(f"[shapes] {tag} top level: nD={nD} N={N} p={p} C={C} "
          f"n_J={ops.n_J} m={N * p} (panels built in "
          f"{time.time() - t0!r} s)")
    return ops


def level_phases(mg, prob, L, torch, K):
    """K1, K2 and K6 against their plain versions and timed at level L's
    top-level shapes."""
    ops = top_level_ops(prob, f"L={L}", torch)
    fwd_cone_phases(prob, ops, torch, K, np.random.default_rng(L), f"L={L}")
    node_barrier_level(mg, prob, L, torch, K)
    torch.cuda.synchronize()


def kernel_phases(prob, torch, K):
    """Each kernel against its plain version at the top-level shapes."""
    from mgbtpu_torch.solver.levelops import build_panel_ops

    dev = torch.device("cuda")
    M = prob.M[0]
    ops = top_level_ops(prob, "L=5", torch)
    nD, N, p, C = ops.panels.shape
    n_J, m = ops.n_J, ops.N * ops.p
    rng = np.random.default_rng(1234)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    records = list(fwd_cone_phases(prob, ops, torch, K, rng, "L=5"))
    f8 = 8

    # K3 panel_adj: the top level (the record) and the coarsest level
    ops0 = build_panel_ops(M.D_fine, M.nu, M.R_fine[0],
                           M.geometry.x.shape[0], dev)
    errs, rows = [], {}
    for tag, lv in (("top level", ops), ("coarsest level", ops0)):
        Yl = t(rng.standard_normal((m, nD)))
        K_ = lv.inv.shape[1]
        print(f"[shapes] panel_adj {tag}: n_J={lv.n_J} C={lv.C} K={K_}")
        args = (lv.panels, lv.cols, lv.inv, Yl, lv.n_J)
        out = K.panel_adj(*args)
        errs.append(compare(f"panel_adj {tag}", out, K.panel_adj_plain(*args)))
        same_bits(f"panel_adj {tag}", out, K.panel_adj(*args))
        GT, Yf = csr_of_panels(lv, transpose=True), Yl.reshape(-1)
        compare(f"panel_adj {tag} library", torch.mv(GT, Yf),
                K.panel_adj_plain(*args))
        b, o = bound_ms(f8 * (nD * N * p * lv.C + N * lv.C + m * nD
                              + lv.n_J), 2 * nD * m * lv.C)
        rows[tag] = dict(bound_ms=b, bound_by=o, **timings(
            f"panel_adj {tag}", lambda: K.panel_adj(*args),
            lambda: K.panel_adj_plain(*args), lambda: torch.mv(GT, Yf)))
        print(f"[bound] panel_adj {tag}: {b!r} ms ({o})")
    records.append(dict(
        name="panel_adj", source="mgbtpu_torch/kernels/csrc/panel_adj.cu",
        replaces="mgbtpu/ops/pallas_dd.py:228", max_abs_err=max(errs),
        **rows["top level"]))

    # K4 gram_matvec: the top level (the record) and the coarsest level
    errs, rows = [], {}
    for tag, lv in (("top level", ops), ("coarsest level", ops0)):
        Ln = t(np.tril(rng.standard_normal((m, nD, nD))))
        v = t(rng.standard_normal(lv.n_J))
        args = (lv.panels, lv.cols, lv.inv, Ln, v)
        before = K.gram_matvec.launches
        out = K.gram_matvec(*args)
        errs.append(compare(f"gram_matvec {tag}", out,
                            K.gram_matvec_plain(*args)))
        same_bits(f"gram_matvec {tag}", out, K.gram_matvec(*args))
        if K.gram_matvec.launches != before + 2:
            raise RuntimeError("gram_matvec: not one count per call")
        b, o = bound_ms(f8 * (nD * N * p * lv.C + N * lv.C
                              + m * nD * (nD + 1) // 2 + 2 * lv.n_J),
                        4 * nD * m * lv.C + 4 * m * nD * nD)
        rows[tag] = dict(bound_ms=b, bound_by=o, **timings(
            f"gram_matvec {tag}", lambda: K.gram_matvec(*args),
            lambda: K.gram_matvec_plain(*args)))
        print(f"[bound] gram_matvec {tag}: {b!r} ms ({o})")
    records.append(dict(
        name="gram_matvec", source="mgbtpu_torch/kernels/csrc/gram_matvec.cu",
        replaces="mgbtpu/ops/pallas_dd.py:142", max_abs_err=max(errs),
        **rows["top level"]))
    records += front_phases(prob, ops, torch, K, rng)
    torch.cuda.synchronize()
    return records


def front_phases(prob, ops, torch, K, rng):
    """K5a/K5b on the top level's nested-dissection fronts: one
    ``nd_factor`` through the plain fronts records each tree level's
    assembled fronts, and each level's kernel call is held against the
    plain version on the same fronts (factor) and factors (solves)."""
    from mgbtpu_torch.ops.ndchol import nd_factor
    from mgbtpu_torch.solver.mgb import ProblemKernels, nd_plan

    dev = torch.device("cuda")
    nd = nd_plan(prob.M[0], ops, ProblemKernels.ND_LEAF_ELEMS, dev)
    N, C = ops.N, ops.C
    X = rng.standard_normal((N, C, 2 * C))
    He = torch.as_tensor(X @ X.transpose(0, 2, 1) / C, device=dev)
    levels = []

    def record(F, a, b):
        levels.append((F.clone(), a, b))
        return K.front_factor_plain(F, a, b)

    fact = nd_factor(nd, He, 2 * torch.finfo(torch.float64).eps,
                     factor=record)
    print("[shapes] ND fronts (nk, amax, bmax) leaf..root: "
          f"{[(F.shape[0], a, b) for F, a, b in levels]}")
    records, errs = [], []
    for li, (F, a, b) in enumerate(levels):
        outs = K.front_factor(F, a, b)
        for part, out, ref, again in zip(("Lf", "U", "S"), outs,
                                         K.front_factor_plain(F, a, b),
                                         K.front_factor(F, a, b)):
            errs.append(compare(f"front_factor level {li} {part}", out, ref))
            same_bits(f"front_factor level {li} {part}", out, again)
    bnd, by = factor_bound(levels)
    print(f"[bound] front_factor L=5: {bnd!r} ms per nd_factor ({by})")
    row = timings(
        f"front_factor ({len(levels)} levels, one nd_factor)",
        lambda: [K.front_factor(F, a, b) for F, a, b in levels],
        lambda: [K.front_factor_plain(F, a, b) for F, a, b in levels])
    factor_library_ms(torch, "L=5", levels)
    errs.append(front_l7_phases(torch, K))
    records.append(dict(
        name="front_factor", source="mgbtpu_torch/kernels/csrc/front_factor.cu",
        replaces="mgbtpu/ops/pallas_dd.py:446", max_abs_err=max(errs),
        bound_ms=bnd, bound_by=by, **row))

    records.append(solve_phases(nd, fact, torch, K, rng))
    return records


def factor_bound(levels):
    """K5a's bound for one ``nd_factor`` over ``levels`` [(F, a, b)]: each
    front's entries read once, Lf, U and S written once; the flops of the
    column-by-column elimination."""
    nbytes = nops = 0
    for F, a, b in levels:
        f, nk = a + b, F.shape[0]
        nbytes += 8 * nk * (f * f + a * a + a * b + b * b)
        for j in range(a):
            w = a - 1 - j
            nops += nk * (w * (w + 1) + 2 * b * w + 2 * b * b + w + b + 1)
    return bound_ms(nbytes, nops)


def factor_library(torch, F, a, b):
    """K5a's function as a composition of three library calls (the
    yardstick: no single PyTorch call computes it)."""
    Lf, _ = torch.linalg.cholesky_ex(F[:, :a, :a])
    U = torch.linalg.solve_triangular(Lf.mT, F[:, a:a + b, :a], upper=True,
                                      left=False)
    return torch.baddbmm(F[:, a:a + b, a:a + b], U, U.mT, alpha=-1.0)


def factor_library_ms(torch, tag, levels):
    ms, hidden = device_ms(lambda: [factor_library(torch, F, a, b)
                                    for F, a, b in levels], 10)
    print(f"[time] front_factor {tag} library composition (cholesky_ex + "
          f"solve_triangular + baddbmm, three calls a level, "
          f"{len(levels)} levels): device ms per nd_factor {ms!r}"
          + ("" if hidden else " (host not hidden: an upper bound)"))
    return ms


def front_l7_phases(torch, K):
    """K5a at the tree levels of the fem2d_P2 L=7 plan (built on the host),
    on seeded SPD fronts made on the card: each level against the plain
    version, one ``nd_factor``'s worth timed against the plain version and
    the library composition. Returns the largest error."""
    from mgbtpu_torch import amg, assemble, fem2d_P2, subdivide
    from mgbtpu_torch.solver.levelops import build_panel_ops
    from mgbtpu_torch.solver.mgb import ProblemKernels, nd_plan

    t0 = time.time()
    cpu = torch.device("cpu")
    M = assemble(amg(subdivide(fem2d_P2(), 7)), p=1.0, device="cpu").M[0]
    ops = build_panel_ops(M.D_fine, M.nu, M.R_fine[-1],
                          M.geometry.x.shape[0], cpu)
    nd = nd_plan(M, ops, ProblemKernels.ND_LEAF_ELEMS, cpu)
    shapes = [(L.nk, L.amax, L.bmax) for L in nd.levels]
    print(f"[setup] L=7 ND plan on the host {time.time() - t0!r} s; fronts "
          f"(nk, amax, bmax) leaf..root: {shapes}")
    g = torch.Generator(device="cuda").manual_seed(7)
    levels = []
    for nk, a, b in shapes:
        f = a + b
        X = torch.randn((nk, f, 2 * f), generator=g, dtype=torch.float64,
                        device="cuda")
        F = torch.zeros((nk, f + 1, f + 1), dtype=torch.float64,
                        device="cuda")
        F[:, :f, :f] = X @ X.mT / f + 0.5 * torch.eye(f, device="cuda")
        levels.append((F, a, b))
    errs = []
    for (F, a, b), sh in zip(levels, shapes):
        for part, out, ref in zip(("Lf", "U", "S"), K.front_factor(F, a, b),
                                  K.front_factor_plain(F, a, b)):
            errs.append(compare(f"front_factor L=7 {sh} {part}", out, ref))
    bnd, by = factor_bound(levels)
    timings(f"front_factor L=7 ({len(levels)} levels, one nd_factor)",
            lambda: [K.front_factor(F, a, b) for F, a, b in levels],
            lambda: [K.front_factor_plain(F, a, b) for F, a, b in levels],
            plain_reps=10, reps=20)
    factor_library_ms(torch, "L=7", levels)
    print(f"[bound] front_factor L=7: {bnd!r} ms per nd_factor ({by})")
    return max(errs)


def solve_phases(nd, fact, torch, K, rng):
    """K5b on the real factors of one ``nd_factor``: each tree level's
    fused call in both sweeps, and the whole ``nd_solve``, against the plain
    versions; the device time per ``nd_solve`` and per launch, beside the
    same sweeps' triangular solves through ``torch.linalg.solve_triangular``
    alone."""
    from mgbtpu_torch.ops.ndchol import nd_solve

    dev = torch.device("cuda")
    fact = [(Lf.contiguous(), U.contiguous()) for Lf, U in fact]
    n_J = nd.n_J
    rhs = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    pad = torch.zeros(1, dtype=torch.float64, device=dev)
    r0 = torch.cat([rhs, pad])
    x0 = torch.cat([torch.as_tensor(rng.standard_normal(n_J), device=dev),
                    pad])
    errs = []
    for li, (L, (Lf, U)) in enumerate(zip(nd.levels, fact)):
        y = torch.as_tensor(rng.standard_normal((L.nk, L.amax)), device=dev)
        got = []
        for fwd, bwd in ((K.front_forward, K.front_backward),
                         (K.front_forward_plain, K.front_backward_plain)):
            r, x = r0.clone(), x0.clone()
            got.append((*fwd(Lf, U, L.adofs, r, L.b_rows, L.b_inc), r,
                        bwd(Lf, U, L.adofs, L.bdofs, y, x), x))
        for part, out, ref in zip(("y", "upd", "r", "xA", "x"), *got):
            errs.append(compare(f"front_solve level {li} {part}", out, ref))

    def nd_solve_plain():
        """``nd_solve``'s composition through K5b's plain versions."""
        r = torch.cat([rhs, pad])
        ys = [K.front_forward_plain(Lf, U, L.adofs, r, L.b_rows, L.b_inc)[0]
              for L, (Lf, U) in zip(nd.levels, fact)]
        x = torch.zeros_like(r)
        for L, (Lf, U), y in reversed(list(zip(nd.levels, fact, ys))):
            K.front_backward_plain(Lf, U, L.adofs, L.bdofs, y, x)
        return x[:-1]

    x = nd_solve(nd, fact, rhs)
    errs.append(compare("nd_solve (front_solve, every level)", x,
                        nd_solve_plain()))
    same_bits("nd_solve (front_solve, every level)", x,
              nd_solve(nd, fact, rhs))
    before = K.front_solve.launches
    nd_solve(nd, fact, rhs)
    per_solve = K.front_solve.launches - before
    if per_solve != 2 * len(nd.levels):
        raise RuntimeError(f"nd_solve made {per_solve} front_solve launches, "
                           f"not one per tree level and sweep")

    f8, nops = 8, 0
    nbytes = f8 * 2 * (n_J + 1)           # rhs in, x out
    for L in nd.levels:
        nk, a, b = L.nk, L.amax, L.bmax
        nbytes += f8 * (nk * (a * (a + 1) // 2 + a * b) + nk * (a + b))
        nops += nk * (2 * a * a + 4 * a * b) + int((L.bdofs < n_J).sum())
    bnd, by = bound_ms(nbytes, nops)
    sweeps = [(Lf, t) for Lf, _ in fact for t in (False, True)]
    rs = [torch.as_tensor(rng.standard_normal((Lf.shape[0], Lf.shape[1], 1)),
                          device=dev) for Lf, _ in sweeps]
    row = timings(
        f"front_solve (one nd_solve: {per_solve} launches)",
        lambda: nd_solve(nd, fact, rhs),
        nd_solve_plain,
        lambda: [torch.linalg.solve_triangular(Lf.mT if t else Lf, r,
                                               upper=t)
                 for (Lf, t), r in zip(sweeps, rs)], plain_reps=2, reps=10)
    print(f"[time] front_solve: device ms per launch {row['ms'] / per_solve!r}"
          f" ({per_solve} per nd_solve); bound per nd_solve {bnd!r} ms "
          f"({by})")
    return dict(name="front_solve",
                source="mgbtpu_torch/kernels/csrc/front_solve.cu",
                replaces="mgbtpu/ops/pallas_dd.py:446", max_abs_err=max(errs),
                bound_ms=bnd, bound_by=by, **row)


def wide_panel_phases(systems, torch, K):
    """K1, K3 and K4 against their plain versions on the top level of the
    phase-I systems (9 rows: parabolic_solve; 11 rows: p_harmonic), the
    widest row counts the solves give them."""
    from mgbtpu_torch.solver.levelops import build_panel_ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(4321)
    errs = {"panel_fwd": [], "panel_adj": [], "gram_matvec": []}
    for tag, M in systems:
        ops = build_panel_ops(M.D_fine, M.nu, M.R_fine[-1],
                              M.geometry.x.shape[0], dev)
        nD, N, p, C = ops.panels.shape
        n_J, m = ops.n_J, ops.N * ops.p
        print(f"[shapes] {tag} phase-I top level: nD={nD} N={N} p={p} "
              f"C={C} n_J={n_J}")

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        s, dz0 = t(rng.standard_normal(n_J)), t(rng.standard_normal((m, nD)))
        Y = t(rng.standard_normal((m, nD)))
        Ln = t(np.tril(rng.standard_normal((m, nD, nD))))
        errs["panel_fwd"].append(compare(
            f"panel_fwd nD={nD}", K.panel_fwd(ops.panels, ops.cols, s, dz0),
            K.panel_fwd_plain(ops.panels, ops.cols, s, dz0)))
        errs["panel_adj"].append(compare(
            f"panel_adj nD={nD}",
            K.panel_adj(ops.panels, ops.cols, ops.inv, Y, n_J),
            K.panel_adj_plain(ops.panels, ops.cols, ops.inv, Y, n_J)))
        errs["gram_matvec"].append(compare(
            f"gram_matvec nD={nD}",
            K.gram_matvec(ops.panels, ops.cols, ops.inv, Ln, s),
            K.gram_matvec_plain(ops.panels, ops.cols, ops.inv, Ln, s)))
        ms, _ = device_ms(lambda: K.panel_fwd(ops.panels, ops.cols, s, dz0))
        print(f"[time] panel_fwd nD={nD}: device ms per call {ms!r}")
    return {k: max(v) for k, v in errs.items()}


def _feasible_rows(M, z0, rng):
    """Seeded rows y (m, nD) inside the problem's set at most nodes: a zoo
    problem's own start point D z0 plus a small perturbation; for the
    parabolic pair (z0 None: its start lies on the cones' walls) random
    (u, grad u) with s1 = u^2 + U and s2 = |grad u| + U. About 1 % of the
    nodes are then pushed outside (the last row, a cone's s, negative)."""
    m = M.n_nodes
    if z0 is not None:
        Dz = M.apply_D_full(z0) + 0.01 * rng.standard_normal(
            (m, len(M.D_fine)))
    else:
        Dz = 0.5 * rng.standard_normal((m, 5))
        Dz[:, 3] = Dz[:, 0] ** 2 + rng.uniform(1e-3, 1.0, m)
        Dz[:, 4] = np.sqrt(Dz[:, 1] ** 2 + Dz[:, 2] ** 2) \
            + rng.uniform(1e-3, 1.0, m)
    bad = rng.choice(m, m // 100, replace=False)
    Dz[bad, -1] = -rng.uniform(0.0, 1.0, len(bad))
    return Dz


def _obstacle_rows(m, rng):
    """Seeded rows (u, grad u, s) inside two_sided_obstacle's set (u in
    (-0.1, 1), s > |grad u|^2) at most nodes; about 1 % of the nodes get a
    negative s."""
    Dz = np.zeros((m, 4))
    Dz[:, 0] = rng.uniform(-0.09, 0.99, m)
    Dz[:, 1:3] = 0.5 * rng.standard_normal((m, 2))
    Dz[:, 3] = (Dz[:, 1:3] ** 2).sum(axis=1) + rng.uniform(1e-3, 1.0, m)
    bad = rng.choice(m, m // 100, replace=False)
    Dz[bad, 3] = -rng.uniform(0.0, 1.0, len(bad))
    return Dz


def k6_calls(Q, Dz, nu, w, torch, K, rng):
    """K6's six calls on a piece table at the rows Dz: modes 0/1/2 as the
    barrier and in the phase-I cobarrier form (slack and nu component rows
    with the box). A piecewise table's select grid switches each piece off
    at every other node where the piece is infinite, so both the dropped
    and the non-finite cases run. Returns {label: the call's arguments}."""
    from mgbtpu_torch.solver.mgb import barrier_weights

    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    m, nD = Dz.shape
    args = tuple(t(a) for a in Q.args)
    sel = args[0] if Q.select else None
    if sel is not None:
        sel = sel.clone()
        for k, pc in enumerate(Q.pieces):
            v = K.node_barrier_plain(0, Dz, (pc,), args, None,
                                     torch.ones(m, dtype=torch.float64,
                                                device=dev),
                                     torch.zeros_like(Dz))
            off = torch.nonzero(~torch.isfinite(v)).flatten()[::2]
            sel[off, k] = 0.0
        args = (sel,) + args[1:]
    bw = t(barrier_weights(w, None))
    wc = t(w[:, None] * rng.standard_normal((m, nD)))
    yhat = torch.cat([Dz, t(rng.uniform(-0.5, 0.5, (m, 1))),
                      t(rng.standard_normal((m, nu)))], dim=1)
    yhat[:: 97, nD + 1] = 12.0                      # outside the box
    wch = t(w[:, None] * rng.standard_normal((m, nD + 1 + nu)))
    box = (t(np.full(m, 4.0)), t(np.full(m, 10.0)))
    calls = {}
    for mode in (0, 1, 2):
        calls[f"mode {mode}"] = (mode, Dz, Q.pieces, args, sel, bw, wc, None,
                                 None)
        calls[f"co mode {mode}"] = (mode, yhat, Q.pieces, args, sel, bw, wch,
                                    nD + 1, box)
    return calls


def k6_check(tag, calls, K):
    """Each call against the plain version, bitwise; returns the largest
    error."""
    errs = []
    for label, call in calls.items():
        out = K.node_barrier(*call)
        ref = K.node_barrier_plain(*call)
        errs.append(compare(f"node_barrier {tag} {label}", out, ref))
        same_bits(f"node_barrier {tag} {label}", out, ref,
                  "the plain version")
    return max(errs)


def k6_time(tag, call, K):
    """Device ms of one K6 call, its plain version's, and its bound: the
    rows, bw, the pieces' grids, sel and the box read once, the output
    written once (wc read in modes 0 and 1); a few flops per entry of each
    piece's affine map and products."""
    from mgbtpu_torch.kernels.node_barrier import POWER, instance

    mode, y, pieces, args, sel, bw, wc, co, box = call
    m, ny = y.shape
    npc = len(pieces)
    grids = sum(g.numel() for pc in pieces for g in pc.grids(args))
    nbytes = 8 * (m * ny + m + grids + (m * npc if sel is not None else 0)
                  + (2 * m if box else 0) + (1, ny, ny * ny)[mode]
                  * m + (m * ny if mode < 2 else 0))
    nops = m * (sum(2 * pc.width * len(pc.idx) + 30
                    + (3 * len(pc.idx) ** 4 if pc.kind == POWER
                       else 3 * pc.width * len(pc.idx) ** 2)
                    for pc in pieces) + npc * (1, ny, ny * ny)[mode])
    bnd, by = bound_ms(nbytes, nops)
    print(f"[instance] node_barrier {tag}: "
          f"{instance(pieces, mode, ny, co, box is not None)}")
    row = dict(bound_ms=bnd, bound_by=by, **timings(
        f"node_barrier {tag} (ny={ny}, {npc} pieces)",
        lambda: K.node_barrier(*call), lambda: K.node_barrier_plain(*call),
        plain_reps=2))
    print(f"[bound] node_barrier {tag}: {bnd!r} ms ({by})")
    return row


def node_barrier_phases(tables, torch, K):
    """K6 against its plain version at the L=5 top-level shapes, on each
    piece table in modes 0/1/2 and in the phase-I cobarrier form
    (``k6_calls``), each mode 2 call timed. Returns the kernel record
    (timed on the parabolic pair's phase-I Hessian, the heaviest call of
    the slice's path)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(99)
    errs, rows = [], {}
    for name, M, Q, z0 in tables:
        Dz = torch.as_tensor(_feasible_rows(M, z0, rng), dtype=torch.float64,
                             device=dev)
        calls = k6_calls(Q, Dz, M.nu, np.asarray(M.w, np.float64), torch, K,
                         rng)
        errs.append(k6_check(name, calls, K))
        for label in ("mode 2", "co mode 2"):
            rows[(name, label)] = k6_time(f"{name} {label}", calls[label], K)
    torch.cuda.synchronize()
    return dict(name="node_barrier",
                source="mgbtpu_torch/kernels/csrc/node_barrier.cu",
                replaces="mgbtpu/ops/pallas_dd.py:258", max_abs_err=max(errs),
                **rows[("parabolic", "co mode 2")])


def node_barrier_level(mg, prob, L, torch, K):
    """K6 at level L's top-level shapes on random rows: the obstacle table
    and parabolic_solve's pair, each bitwise against its plain version in
    all six calls of ``k6_calls``; timed on the obstacle's Hessian (mode
    2) and the pair's phase-I Hessian (co mode 2)."""
    import mgbtpu_torch.solver.parabolic as P
    from mgbtpu_torch import intersect
    from mgbtpu_torch.convex import convex_euclidian_power, convex_linear

    dev = torch.device("cuda")
    rng = np.random.default_rng(100 + L)
    M = prob.M[0]
    m, w = M.n_nodes, np.asarray(M.w, np.float64)
    obstacle = intersect(
        mg, convex_euclidian_power(mg, idx=(1, 2, 3), p=2.0),
        convex_linear(mg, idx=(0,), A=lambda x: np.array([[1.0], [-1.0]]),
                      b=lambda x: np.array([0.1, 1.0])))
    pair = intersect(mg, convex_euclidian_power(mg, idx=P.parabolic_idx1(2),
                                                p=2.0),
                     convex_euclidian_power(mg, idx=P.parabolic_idx2(2),
                                            p=1.0))
    errs = []
    for name, Q, rows, nu, label in (
            ("obstacle", obstacle, _obstacle_rows(m, rng), 2, "mode 2"),
            ("parabolic", pair, _feasible_rows(M, None, rng), 3,
             "co mode 2")):
        Dz = torch.as_tensor(rows, dtype=torch.float64, device=dev)
        calls = k6_calls(Q, Dz, nu, w, torch, K, rng)
        errs.append(k6_check(f"L={L} {name}", calls, K))
        k6_time(f"L={L} {name} {label}", calls[label], K)
    torch.cuda.synchronize()
    return max(errs)


def k6_tables(mg5):
    """K6's piece tables at L=5: two_sided_obstacle (power p=2 nz=3 +
    linear nc=2), rof (cones p=1 and p=2), p_harmonic p=1.5 (a lone nz=5
    cone, spec 0: K6 takes its cobarrier) and parabolic_solve's pair, each
    as (name, main system, Convex, start point or None)."""
    import mgbtpu_torch.solver.parabolic as P
    from mgbtpu_torch import intersect, zoo
    from mgbtpu_torch.convex import convex_euclidian_power

    out = []
    for name in ("two_sided_obstacle", "rof", "p_harmonic"):
        prob = getattr(zoo, name)(mg5, device="cuda")
        out.append((name, prob.M[0], prob.Q, prob.g_grid.T.reshape(-1)))
    Q = intersect(mg5, convex_euclidian_power(mg5, idx=P.parabolic_idx1(2),
                                              p=2.0),
                  convex_euclidian_power(mg5, idx=P.parabolic_idx2(2), p=1.0))
    out.append(("parabolic", parabolic_systems(mg5)[0], Q, None))
    return out


def parabolic_systems(mg):
    """The (main, feasibility) AMG pair of parabolic_solve's default state
    and rows (the pair it builds, cached on mg)."""
    import mgbtpu_torch.solver.parabolic as P
    from mgbtpu_torch import prepare_amg

    sp = mg.geometry.discretization.default_slack_space()
    return prepare_amg(mg, state_variables=[("u", "dirichlet"), ("s1", sp),
                                            ("s2", sp)],
                       D=P.default_D_parabolic(2))


def phase1_systems(mg5):
    """The phase-I (feasibility) systems with the most rows at L=5: 9 for
    parabolic_solve (5 + 1 + 3), 11 for p_harmonic (7 + 1 + 3)."""
    from mgbtpu_torch import zoo

    return [("parabolic", parabolic_systems(mg5)[1]),
            ("p_harmonic", zoo.p_harmonic(mg5, device="cuda").M[1])]


def solve(L, torch):
    """Assembles fem2d_P2, p=1 at level L for the card; returns the
    MultiGrid, the problem and a runner of one timed ``mgb_solve`` ->
    (seconds, solution, host syncs)."""
    from mgbtpu_torch import amg, assemble, fem2d_P2, mgb_solve, subdivide
    from mgbtpu_torch.solver.newton import SYNCS

    t0 = time.time()
    mg = amg(subdivide(fem2d_P2(), L))
    prob = assemble(mg, p=1.0, device="cuda")
    print(f"[setup] L={L}: subdivide + amg + assemble {time.time() - t0!r} s")
    return mg, prob, lambda: _timed_solve(prob, mgb_solve, torch, SYNCS)


def _timed_solve(prob, mgb_solve, torch, SYNCS):
    SYNCS["n"] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    sol = mgb_solve(prob, device="cuda")
    torch.cuda.synchronize()
    return time.time() - t0, sol, SYNCS["n"]


def report(tag, secs, sol, syncs):
    S = sol.SOL_main
    its = S["its"].sum(axis=1)
    wall = "" if secs is None else f"{secs!r} s wall, "
    print(f"[solve] {tag}: {wall}its per level {its.tolist()} "
          f"total {int(its.sum())}, steps {S['steps_accepted']}/"
          f"{S['steps_attempted']} (accepted/attempted), "
          f"cg {int(S['cg'].sum())}, host syncs {syncs}, "
          f"|z| {float(np.linalg.norm(sol.z))!r}, its per ramp step "
          f"{S['its'][-1].tolist()}")
    if not np.all(np.isfinite(sol.z)):
        raise RuntimeError(f"{tag}: non-finite solution")


def counted(torch, K, fn):
    """fn() with every launch counter set to 0 just before and read just
    after: (seconds, result, launches, K6 launches in cobarrier form)."""
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return time.time() - t0, out, K.launches(), K.node_barrier.co_launches


def require_launches(tag, launches, names):
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise RuntimeError(f"{tag}: kernels not launched: {missing}")


def ref_record(fname, prefix):
    """The solve record stored under ``prefix/`` in a reference file."""
    data = np.load(os.path.join(DATA, fname))
    n = len(prefix) + 1
    return {k[n:]: data[k] for k in data.files if k.startswith(prefix + "/")}


def check_record(tag, sol, ref):
    """The solution within TOL_Z of the x64 one; the main ramp's Newton its
    on every step but the last within 5 % in total, the last (the
    exact-stopping polish, decided at the objective's roundoff floor)
    within FLOOR_ITS; phase I run iff the reference ran it, its its within
    5 %."""
    z_ref = ref["z"]
    zerr = float(np.linalg.norm(sol.z - z_ref) / np.linalg.norm(z_ref))
    its, its_ref = sol.SOL_main["its"], ref["its"]
    body, body_ref = int(its[:, :-1].sum()), int(its_ref[:, :-1].sum())
    last, last_ref = int(its[:, -1].sum()), int(its_ref[:, -1].sum())
    F = sol.SOL_feasibility
    feas = -1 if F is None else int(F["its"].sum())
    feas_ref = -1 if ref["feas_its"].size == 0 else int(ref["feas_its"].sum())
    steps = [sol.SOL_main["steps_accepted"], sol.SOL_main["steps_attempted"]]
    print(f"[reference] {tag}: |z - z_ref|/|z_ref| = {zerr!r}; main its "
          f"{body} + {last} (final step) vs {body_ref} + {last_ref} (x64), "
          f"total {body + last} vs {body_ref + last_ref}; phase I its {feas} "
          f"vs {feas_ref} (-1: none); steps {steps} vs "
          f"{ref['steps'].tolist()}")
    fails = []
    if not zerr <= TOL_Z:
        fails.append(f"solution error {zerr}")
    if abs(body - body_ref) > TOL_ITS * body_ref:
        fails.append(f"its {body} not within 5% of {body_ref}")
    if abs(last - last_ref) > FLOOR_ITS:
        fails.append(f"final-step its {last} vs {last_ref}")
    if (feas < 0) != (feas_ref < 0) \
            or abs(feas - feas_ref) > TOL_ITS * max(feas_ref, 0):
        fails.append(f"phase I its {feas} vs {feas_ref}")
    if fails:
        raise RuntimeError(f"{tag}: " + "; ".join(fails))


def _grad(mg, u):
    ops = mg.geometry.operators
    return np.stack([ops["dx"].matvec(u), ops["dy"].matvec(u)], axis=1)


def behaviour(name, mg, z):
    """tests/test_zoo.py's checks in 2D: obstacles respected and reached,
    the yield bound, the minimal surface's cone, ROF within the data."""
    ok = True
    if name == "two_sided_obstacle":
        u = z[:, 0]
        ok = u.min() >= -0.1 - 1e-6 and u.max() <= 1.0 + 1e-6 \
            and u.min() < -0.09
    elif name == "elastoplastic_torsion":
        ok = np.sqrt((_grad(mg, z[:, 0]) ** 2).sum(axis=1)).max() <= 1 + 1e-3
    elif name == "minimal_surface":
        du = _grad(mg, z[:, 0])
        ok = bool(np.all(z[:, 1] ** 2 >= (du ** 2).sum(axis=1) + 1 - 1e-3))
    elif name == "rof":
        ok = z[:, 0].max() <= 0.5 + 1e-6 and z[:, 0].min() >= -0.5 - 1e-6
    if not ok:
        raise RuntimeError(f"{name}: behavioural check failed")


def slice2_solves(torch, K, smi, mg5):
    """The zoo and parabolic solves on the card, each with the launch
    counters set to 0 just before it; returns the parabolic run's launch
    counts."""
    import mgbtpu_torch.solver.parabolic as P
    from mgbtpu_torch import amg, fem2d_P2, mgb_solve, subdivide, zoo

    cuda = dict(device="cuda")
    mesh = ["panel_fwd", "panel_adj", "gram_matvec", "front_factor",
            "front_solve"]

    prob = zoo.two_sided_obstacle(mg5, **cuda)
    secs, sol, la, co = counted(torch, K, lambda: mgb_solve(prob, **cuda))
    report("zoo.two_sided_obstacle L=5", secs, sol, "n/a")
    print(f"[solve] zoo.two_sided_obstacle L=5 wall {secs!r} s on {smi}; "
          f"launches {la}")
    require_launches("two_sided_obstacle L=5", la, mesh + ["node_barrier"])
    check_record("two_sided_obstacle L=5", sol,
                 ref_record("ref_obstacle_L5.npz", "two_sided_obstacle"))
    behaviour("two_sided_obstacle", mg5, sol.z)

    steps, mgb = [], P.mgb_solve

    def recording(prob, **kw):
        steps.append(mgb(prob, **kw))
        return steps[-1]

    P.mgb_solve = recording     # records each implicit step's solve
    try:
        secs, psol, la_par, co = counted(torch, K, lambda: P.parabolic_solve(
            mg5, h=0.5, p=1.0, **cuda))
    finally:
        P.mgb_solve = mgb
    print(f"[solve] parabolic_solve L=5 h=0.5 ({len(steps)} steps) wall "
          f"{secs!r} s on {smi}; launches {la_par}, K6 in cobarrier form "
          f"{co}")
    require_launches("parabolic_solve L=5", la_par, mesh + ["node_barrier"])
    if co == 0:
        raise RuntimeError("parabolic_solve L=5: no phase-I K6 launch")
    data = np.load(os.path.join(DATA, "ref_parabolic_L5.npz"))
    if not np.array_equal(psol.ts, data["ts"]) or len(steps) != 2:
        raise RuntimeError(f"parabolic time stamps {psol.ts}")
    for j, s in enumerate(steps, 1):
        report(f"parabolic step {j} main ramp", None, s, "n/a")
        rec = {k[6:]: data[k] for k in data.files
               if k.startswith(f"step{j}/")}
        check_record(f"parabolic L=5 step {j}", s, rec)

    t0 = time.time()
    mg3 = amg(subdivide(fem2d_P2(), 3))
    print(f"[setup] L=3: subdivide + amg {time.time() - t0!r} s")
    cases = [(n, {}, "ref_zoo_L3.npz") for n in ZOO] \
        + [("p_harmonic", dict(s_init=0.0), "ref_phase1_L3.npz")]
    for name, kw, fname in cases:
        tag = f"zoo.{name} L=3" + (" from s=0" if kw else "")
        prob = getattr(zoo, name)(mg3, **kw, **cuda)
        secs, sol, la, co = counted(torch, K,
                                    lambda: mgb_solve(prob, **cuda))
        print(f"[solve] {tag} wall {secs!r} s on {smi}; launches {la}, K6 "
              f"in cobarrier form {co}")
        need = ["panel_fwd", "panel_adj"]
        need.append("power_cone" if name in LONE_CONE else "node_barrier")
        require_launches(tag, la, need)
        if kw and co == 0:
            raise RuntimeError(f"{tag}: no phase-I K6 launch")
        check_record(tag, sol, ref_record(fname, name))
        behaviour(name, mg3, sol.z)
    return la_par


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", type=int, action="append", default=[],
                    help="also time K1/K2/K6 at this level's top-level "
                    "shapes and solve fem2d_P2 there once")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one L=5 solve (torch.profiler)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import mgbtpu_torch.kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    secs = K.build_all(force=True)
    print(f"[build] {len(K.WRAPPERS)} kernels in {secs!r} s")
    print_ptxas(*K._build.PTXAS["node_barrier"])
    floor_ms, _ = device_ms(lambda: torch.cuda._sleep(0))
    print(f"[time] launch floor: device ms per call of an empty kernel "
          f"(torch.cuda._sleep(0), one thread) {floor_ms!r}")

    mg5, prob, run = solve(5, torch)
    records = kernel_phases(prob, torch, K)
    records.append(node_barrier_phases(k6_tables(mg5), torch, K))
    wide = wide_panel_phases(phase1_systems(mg5), torch, K)
    for r in records:
        if r["name"] in wide:
            r["max_abs_err"] = max(r["max_abs_err"], wide[r["name"]])

    s1, sol1, syncs1 = run()
    report("L=5 first", s1, sol1, syncs1)
    K.reset_launches()
    s2, sol, syncs = run()
    launches = K.launches()
    report("L=5 second", s2, sol, syncs)
    print(f"[solve] fem2d_P2 p=1 L=5 wall {s2!r} s on {smi}")
    same = bool(np.array_equal(sol.z, sol1.z))
    print(f"[solve] second solve bitwise equal to the first: {same}")
    if not same:
        raise RuntimeError("the second L=5 solve differs from the first")
    print(f"[kernels] launches in the second L=5 solve: {launches}; "
          f"power_cone by mode 0/1/2: {K.power_cone_eval.mode_launches}")
    require_launches("fem2d_P2 p=1 L=5", launches,
                     [n for n in launches if n != "node_barrier"])

    ref = np.load(REF)
    z_ref = ref["z"]
    zerr = float(np.linalg.norm(sol.z - z_ref) / np.linalg.norm(z_ref))
    its = int(sol.SOL_main["its"].sum())
    its_ref = int(ref["its_per_level"].sum())
    print(f"[reference] |z - z_ref|/|z_ref| = {zerr!r}; its {its} vs "
          f"{its_ref} (x64); per level {sol.SOL_main['its'].sum(axis=1).tolist()}"
          f" vs {ref['its_per_level'].tolist()}")
    if not zerr <= TOL_Z:
        raise RuntimeError(f"solution differs from the x64 reference: {zerr}")
    if abs(its - its_ref) > TOL_ITS * its_ref:
        raise RuntimeError(f"Newton its {its} not within 5% of {its_ref}")

    launches_par = slice2_solves(torch, K, smi, mg5)
    for r in records:
        r["launches"] = (launches_par if r["name"] == "node_barrier"
                         else launches)[r["name"]]

    for L in args.level:
        mgL, probL, run_L = solve(L, torch)
        level_phases(mgL, probL, L, torch, K)
        _, (sL, solL, syL), la, _ = counted(torch, K, run_L)
        report(f"L={L}", sL, solL, syL)
        print(f"[kernels] launches in the L={L} solve: {la}; power_cone by "
              f"mode 0/1/2: {K.power_cone_eval.mode_launches}")
    if args.profile:
        profile(run, s2)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in ({"route": "cuda", **r} for r in records)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def print_ptxas(secs, info):
    """K6's functions as ptxas reports them (registers, stack, spills):
    its kernels, and any callee that was not inlined."""
    print(f"[ptxas] node_barrier.cu built in {secs!r} s (nvcc, beside the "
          f"other kernels' builds)")
    for fn, r in sorted(info.items()):
        m = re.search(r"node_barrier_kernelILi(\d+)ELi(\d+)E", fn)
        label = (f"node_barrier_kernel<mode {m[1]}, form {m[2]}>" if m
                 else fn)
        print(f"[ptxas] {label}: {r.get('registers')} registers, "
              f"{r.get('stack')} bytes stack, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spill stores / loads")


def profile(run, wall):
    """One L=5 solve under torch.profiler: the device's busy time against
    the profiled wall and against ``wall``, the unprofiled solve's; prints
    the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile as tprof

    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        secs, _, _ = run()
    t0 = time.time()
    ka = pr.key_averages()
    busy = device_us(ka) / 1e6
    print(f"[profile] averaging the trace took {time.time() - t0!r} s")
    print(f"[profile] L=5 solve {secs!r} s wall under the profiler, device "
          f"busy {busy!r} s: {busy / secs!r} of the profiled wall, "
          f"{busy / wall!r} of the unprofiled solve's {wall!r} s")
    print(ka.table(sort_by="self_device_time_total", row_limit=40))


if __name__ == "__main__":
    sys.exit(main())

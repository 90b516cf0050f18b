#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mgbtpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the check: kernels + solves
    python3 chip_smoke.py --level 7       # also K1/K2/K6 and one solve at L=7
    python3 chip_smoke.py --fem3d-level 3 # the fem3d phases at L=3, not 4
    python3 chip_smoke.py --fem3d-level 5 # ... at L=5, held to its record
    python3 chip_smoke.py --profile       # also profile one L=5 solve (and
                                          # the fem3d solve at its level)
    python3 chip_smoke.py --precond-full  # also the V-cycle ramps at L=4
                                          # and, over a mesh, at L=3
    python3 chip_smoke.py --level 6       # also L=6 against its x64 record

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
just after: fem2d_P2, p=1, L=5 twice (K1-K5 must launch, neither front
kernel in its large form; the second solve bitwise equal to the first);
the mesh phase (``mesh_phases``): the same
solve over ``make_mesh(devices=[cuda:0] * 4)``, which must give the
unsharded bits (max abs 5e-12 at most) and the x64 record's, with K1-K5
on every shard (each launch attributed to its shard), one Gram matvec's
transfers and the ND factor's bytes per device against
``nd_memory_report``, then zoo.two_sided_obstacle L=5 and p_harmonic L=3
from s = 0 under that mesh (K6 on every shard), and the L=5 solve over
distinct cards where there are two or more; zoo.two_sided_obstacle and
parabolic_solve
(p=1, h=0.5, 2 implicit steps, each a phase I and a main ramp) at L=5; the
six zoo problems at L=3 and p_harmonic at L=3 from an infeasible start
(phase I over 11 rows); K2's launches in the second p=1 L=5 solve are
also printed by mode. K6 must launch in every solve of a piece table, in
the cobarrier form in every phase I. Then the tensor-product and P1
slice, at the fem3d k=3 (Q3 hexes, p = 64) level ``--fem3d-level`` (4 by
default, 5 for the L=5 plan of 4,096 hexes, ~30 s of host setup): K1 and
K4 against their plain versions and timed at its top level's shapes (nD =
5) and its phase-I system's (nD = 8), where K1's wide form and K4's
cluster form run (K4 also bitwise against ``gram_matvec_cluster_plain``
and beside ``torch.mv`` on the assembled Hessian in CSR), K3 at both
(its bulk form bitwise against ``panel_adj_contrib_rows_plain`` and the
staged form, its phase A and its phase B also timed apart), and K5a
on every tree level of its nested dissection in the large form its shape
rule gives it (checked: its large count), per level against the plain
version, timed in that form and in the one-panel form where that takes
the level (the crossover, ``[form]`` lines), and per ``nd_factor``
against the plain version and the library composition; K5b the same way
on those factors (both sweeps per level in both forms, a whole
``nd_solve``, its launches counted, beside its bound: the factors read
by both sweeps where they pass the 50 MB L2); then fem3d k=3 p=1 solves
at L=3 and at that level (the slice's path: K1-K5 and both large forms
must launch, and K3's bulk form wherever a level takes it by shape: each
level's K3 form printed, ``[form] ... K3``; launches, Newton and CG
counts, host syncs and wall printed; held to ``ref_fem3d_k3_L<L>.npz``),
fem2d_P1 p=1 at L=5 (no
large form may launch) and the fem1d golden vector of
``tests/test_golden.py`` (to 1e-6). Unless the level is 5, K5a and K5b
then run at the ten tree levels of the fem3d L=5 plan on seeded SPD fronts
made on the card (``fem3d_l5_phases``; K5b over made-up dof maps), the
same comparisons and timings, without the L=5 problem's setup. Then the
spectral slice, at spectral2d n=32 (one element of 1,024 nodes, every
level dense): K1 and K3 in their spread forms (the C entries' choice is
printed and must be the spread form) against their plain versions, and
bitwise against their split plain versions (K3's phase A), and timed at
its top level (nD = 4, C = 1,924) and at parabolic_solve's phase-I rows
there (nD = 9), beside one ``torch.addmv``/``torch.mv`` on the element's
dense panel view (K3's phase A alone too); K2 and K6 at those 1,024
nodes, bitwise;
then the spectral solves: spectral2d n=32 p=1 (the slice's path: K1, K2
and K3 must launch, K4 and K5 must not), spectral1d n=128, the golden
spectral1d n=5 and spectral2d n=5 cases and parabolic_solve on
spectral1d and spectral2d n=4 (h=0.5), each held to its stored x64
record and the golden ones to their ``tests/test_golden.py`` vectors
(to 1e-6), each printing one ``assemble_dense`` and one
``equilibrated_solve`` at its top level (device ms; the einsum's peak
memory). Then the front-end slice: K6's made-up wide tables at 57,344
seeded nodes (six pieces, 14 rows in phase I; a lone nz = 7 cone on the
three-field model's 10 rows, which
``Convex.barrier_terms`` must route to K6; five pieces over 20 rows with the
phase-I box), every mode and form bitwise, each Hessian call timed beside
its bound; then through the entry points a user calls: (A) the Model DSL's
elastoplastic torsion (``examples/model_dsl.py``) at L=5 (K1, K3-K6 must
launch), ``dual()`` of its three constraints (a mode-1 K6 launch for the
equality's reactions) and ``plot3d_html`` of its solution (structure
checked, no matplotlib); (B) the committed L-shaped Gmsh mesh
(``mgbtpu_torch/data/lshape_tri6.msh``) through ``gmsh_import``,
``assemble`` and ``mgb_solve`` (K1-K5 must launch); (C) the five-constraint
model at L=3 (phase I over the five-piece cobarrier) and the three-field
model (one nz = 7 cone in K6's runtime-width instance, no K2), each held to
its x64 record (``check_record``; the duals within 1e-6), and after each
Model's solve K6 on the table its lowering gave it, at the top level's
nodes and rows (the three-field table gives the runtime-width cone's
kernel record), bitwise in all six calls and timed. Then K6's table
kernels (``table_kernel_phases``): the 17-constraint, 16- and 32-field
fem1d models (``port_models.WIDE_MODELS``) through ``Model(mg)``, each
held to its x64 record in ``ref_model_wide.npz`` (the steps at the
roundoff floor from the 4th within +-1, the polish within +-4) with the
table kernels launched, K6 bitwise on each model's table, and their
tables again at 4,096 seeded nodes, bitwise in every mode and form, the
Hessians timed (the nz = 33 cone's is the table kernel's record).
Then the large-level preconditioners that ``MGBTPU_BIG_PRE`` selects
(``precond_phases``; vcycle, fsai, fsai2, fsai2a): (a) at the top level
of fem2d_P2 L=5 (n_J = 5,057) with the default DENSE_MAX and DENSE_BASE,
one ``make_pcg_pre`` + ``pcg_solve`` a choice at p=2, t=100, s=0 and at
the p=1 ramp's last t from its stored solution: at p=2 held to
``ref_pcg_L5_<choice>.npz`` (x within 1e-8 relative, the CG count within
+-1, the chosen levels, the V-cycle's lambda_max); at the deep state,
where the Hessian carries Dz's last bits through slacks of ~1/t, x and
the CG count printed beside the record's and a converged solve held to
its own exit test; with the level
subset, lambda_max, CG, the walls of the level setup, the preconditioner
and the solve, and the launches printed (K1-K4 must launch), one
application of each preconditioner and one K4 Hessian apply timed, and
K4 against its plain version and timed at the V-cycle's levels (the
record ``gram_matvec vcycle``); (b) ``assemble`` -> ``mgb_solve`` of
fem2d_P2 p=1 at L=3 with DENSE_MAX=50 and DENSE_BASE=40 under each
choice (K1-K4 must launch, K5 must not), held to
``ref_fem2d_p2_L3_<choice>.npz``: the steps equal, z within 1e-6 and the
Newton its by the zoo bar, or within twice the largest move of the
record's own perturbed JAX runs where that is larger (``precond_bars``),
its, CG beside the record's, host syncs and wall printed. Then the same
preconditioners under ``make_mesh(devices=[cuda:0] * 4)``: (a)'s
``pcg_solve`` at p=2 for each choice, held to its record and bitwise
equal to the unsharded call (x and the CG count), K1-K4 on every shard
(``ShardSpy``), the transfers in the preconditioner's setup and per CG
iteration printed; and the V-cycle ramp of fem2d_P2 p=1 at L=2
(DENSE_MAX=50, DENSE_BASE=40; its top level of 73 coefficients over 8
elements) under the mesh, bitwise equal to the same ramp unsharded,
K1-K4 on every shard, walls and transfers printed. With
``--precond-full``, the V-cycle ramp at L=4 with the default knobs against
``ref_fem2d_p2_L4_vcycle.npz`` the same way (minutes), and the mesh
V-cycle ramp at L=3, bitwise equal to (b)'s and held to its record.
Each ``--level
L`` then holds K1, K2
and K6 against their plain versions and times them at level L's top-level
shapes (K6 on the obstacle table and parabolic_solve's pair on random rows,
bitwise in all six calls, timed on the obstacle's Hessian and the pair's
phase-I Hessian), K5a on every tree level of L's nested-dissection plan
(seeded SPD element blocks; per level and per ``nd_factor``, beside the
bound, the plain version and the library composition) and K5b on those
factors (per ``nd_solve``, beside its bound), and solves fem2d_P2 p=1 at
L once, printing that solve's launches per kernel (K2's by mode; K1-K5
must launch) and holding it to ``ref_fem2d_p2_L<L>.npz`` (L = 4, 5, 6,
7) by the L=5 bars: z within 1e-6, the Newton its in total within 5 %,
the per-level its, CG and steps printed beside the record's. Each solution and its Newton
iterations are held against the stored JAX x64 run
(``mgbtpu_torch/data/*.npz``): relative 2-norm error <= 1e-6; Newton
iterations within 5 % (for the zoo and parabolic solves: the main ramp's
steps but the last within 5 %, the last, an exact-stopping polish decided
at the objective's roundoff floor, within +-4; phase I within 5 %; for
fem2d_P1 the steps but the last within 5 %, the last within 7 of x64's:
a trace on the card counted 7 iterations of its polish at the roundoff
floor, ROADMAP Queue 3; for the golden spectral n=5 cases the steps but
the last within 5 %, the last within +-4); and the
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
F64_FLOPS = 67e12             # H100 SXM FP64 peak, tensor cores (DMMA; 34e12
                              # outside them; NVIDIA data sheet)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "mgbtpu_torch", "data")
REF = os.path.join(DATA, "ref_fem2d_p2_L5.npz")
TOL_KERNEL = 1e-12
TOL_Z = 1e-6
TOL_ITS = 0.05
FLOOR_ITS = 4     # the exact-stopping polish at the roundoff floor
# fem2d_P1 L=5's polish: a trace on the card counted 7 iterations in it
# with every Newton decrement below one ulp of f0 (ROADMAP Queue 3)
P1_FLOOR_ITS = 7
ZOO = ("p_harmonic", "norton_hoff", "rof", "two_sided_obstacle",
       "elastoplastic_torsion", "minimal_surface")
LONE_CONE = ("p_harmonic", "norton_hoff", "minimal_surface")   # K2, not K6
MESH = ["panel_fwd", "panel_adj", "gram_matvec", "front_factor",
        "front_solve"]      # every kernel of a level solved by ND-CG


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
          f"call (host launch rate): kernel "
          f"{wall_ms(kernel, reps=min(200, 4 * reps))!r}"
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


def forms(ops, K, tag):
    """The forms K1's and K3's C entries take at a level's shapes (K1: 1
    element-group, 2 wide, 3 spread; K3's phase A: 1 staged, 3 spread)."""
    fwd = sys.modules[K.panel_fwd.__module__].form
    adj = sys.modules[K.panel_adj.__module__].form
    shape = ops.panels.shape
    out = (fwd(*shape), adj(*shape))
    print(f"[form] {tag} (nD, N, p, C) = {tuple(shape)}: panel_fwd form "
          f"{out[0]}, panel_adj form {out[1]}")
    return out


def spread_forms(ops, K):
    """Whether K1 and K3 take their spread forms (3) at a level's shapes."""
    shape = ops.panels.shape
    return tuple(sys.modules[fn.__module__].form(*shape) == 3
                 for fn in (K.panel_fwd, K.panel_adj))


def panel_fwd_phase(ops, torch, K, rng, tag):
    """K1 at a level's shapes (``ops``) against its plain version (the
    repeat call bitwise; in the spread form also its split plain version's
    bits), timed against its plain version and one library call:
    ``torch.addmv`` on G in CSR, or on one element's dense (nD*p, C) panel
    view (N = 1) with the gathered s[cols[0]] and Dz0 in its (k, q) order.
    Returns its record."""
    dev = torch.device("cuda")
    nD, N, p, C = ops.panels.shape
    n_J, m = ops.n_J, ops.N * ops.p

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    f8 = 8
    s = t(rng.standard_normal(n_J))
    dz0 = t(rng.standard_normal((m, nD)))
    out = K.panel_fwd(ops.panels, ops.cols, s, dz0)
    ref = K.panel_fwd_plain(ops.panels, ops.cols, s, dz0)
    err = compare(f"panel_fwd {tag}", out, ref)
    same_bits(f"panel_fwd {tag}", out,
              K.panel_fwd(ops.panels, ops.cols, s, dz0))
    if spread_forms(ops, K)[0]:
        same_bits(f"panel_fwd {tag}", out,
                  K.panel_fwd_split_plain(ops.panels, ops.cols, s, dz0),
                  "its split plain version")
    if N == 1:
        P, c0 = ops.panels.reshape(nD * p, C), ops.cols[0]
        dzf = dz0.t().contiguous().reshape(-1)

        def library():
            return torch.addmv(dzf, P, s[c0])

        lib_out = library().reshape(nD, p).t()
    else:
        G, dzf = csr_of_panels(ops), dz0.reshape(-1)

        def library():
            return torch.addmv(dzf, G, s)

        lib_out = library().reshape(m, nD)
    compare(f"panel_fwd {tag} library", lib_out, ref)
    b, o = bound_ms(f8 * (nD * N * p * C + N * C + n_J + 2 * m * nD),
                    2 * nD * m * C + m * nD)
    rec = dict(
        name="panel_fwd", source="mgbtpu_torch/kernels/csrc/panel_fwd.cu",
        replaces="mgbtpu/ops/pallas_dd.py:186", max_abs_err=err,
        bound_ms=b, bound_by=o, **timings(
            f"panel_fwd {tag}",
            lambda: K.panel_fwd(ops.panels, ops.cols, s, dz0),
            lambda: K.panel_fwd_plain(ops.panels, ops.cols, s, dz0),
            library))
    print(f"[bound] panel_fwd {tag}: {b!r} ms ({o})")
    return rec


def panel_adj_phase(lv, torch, K, rng, tag, apart=False):
    """K3 at a level's shapes (``lv``) against its plain version (the
    repeat call bitwise; in the spread form its phase A also against its
    split plain version's bits, in the bulk form against
    ``panel_adj_contrib_rows_plain``'s and the staged form's, and the call
    against that order's with phase B's, ``adjoint_sum_ordered_plain``),
    timed against its plain version and one library call: ``torch.mv`` on
    G' in CSR, or on one element's dense (nD*p, C) panel view transposed
    (N = 1) with Y in its (k, q) order (the per-slot sums; their scatter
    into n_J is left out, so for N = 1 phase A alone,
    ``panel_adj_contrib``, is timed beside it too). ``apart``: phase A
    (``panel_adj_contrib``) and phase B (``adjoint_sum``) also timed
    apart, each beside its bound. Returns (max abs error, its timing row
    with the bound)."""
    dev = torch.device("cuda")
    nD, N, p, C = lv.panels.shape
    m = N * p
    Y = torch.as_tensor(rng.standard_normal((m, nD)), dtype=torch.float64,
                        device=dev)
    mod = sys.modules[K.panel_adj.__module__]
    form = mod.form(nD, N, p, C)
    print(f"[shapes] panel_adj {tag}: n_J={lv.n_J} C={C} K={lv.inv.shape[1]}"
          f"; phase A form {form}")
    args = (lv.panels, lv.cols, lv.inv, Y, lv.n_J)
    out = K.panel_adj(*args)
    ref = K.panel_adj_plain(*args)
    err = compare(f"panel_adj {tag}", out, ref)
    same_bits(f"panel_adj {tag}", out, K.panel_adj(*args))
    if form == 3:
        same_bits(f"panel_adj {tag} phase A",
                  K.panel_adj_contrib(lv.panels, Y),
                  K.panel_adj_contrib_split_plain(lv.panels, Y),
                  "its split plain version")
    if form == 4:
        rows = K.panel_adj_contrib_rows_plain(lv.panels, Y)
        same_bits(f"panel_adj {tag} phase A (bulk form)",
                  K.panel_adj_contrib(lv.panels, Y), rows,
                  "its rows plain version")
        same_bits(f"panel_adj {tag} phase A (bulk form)", rows,
                  in_form(K.panel_adj_contrib, 1, lv.panels, Y),
                  "the staged form")
        same_bits(f"panel_adj {tag} (bulk form)", out,
                  mod.adjoint_sum_ordered_plain(lv.inv, rows),
                  "its rows plain version, then phase B's order")
    if apart:
        contrib = K.panel_adj_contrib(lv.panels, Y)
        f8 = 8
        ba, _ = bound_ms(f8 * (nD * N * p * C + m * nD + N * C),
                         2 * nD * m * C)
        timings(f"panel_adj {tag} phase A (form {form})",
                lambda: K.panel_adj_contrib(lv.panels, Y),
                lambda: mod.panel_adj_contrib_plain(lv.panels, Y))
        print(f"[bound] panel_adj {tag} phase A: {ba!r} ms (bytes)")
        bb, _ = bound_ms(f8 * (lv.inv.numel() + N * C + lv.n_J), 0)
        timings(f"panel_adj {tag} phase B",
                lambda: K.adjoint_sum(lv.cols, lv.inv, contrib, lv.n_J),
                lambda: mod.adjoint_sum_plain(lv.cols, lv.inv, contrib,
                                              lv.n_J))
        print(f"[bound] panel_adj {tag} phase B: {bb!r} ms (bytes)")
    if N == 1:
        PT, c0 = lv.panels.reshape(nD * p, C).t(), lv.cols[0]
        Yf = Y.t().contiguous().reshape(-1)

        def library():
            return torch.mv(PT, Yf)

        lib_out = torch.zeros(lv.n_J, dtype=torch.float64,
                              device=dev).index_add_(0, c0, library())
        ba, _ = bound_ms(8 * (nD * p * C + m * nD + C), 2 * nD * m * C)
        plain_a = sys.modules[K.panel_adj.__module__].panel_adj_contrib_plain
        timings(f"panel_adj {tag} phase A",
                lambda: K.panel_adj_contrib(lv.panels, Y),
                lambda: plain_a(lv.panels, Y), library)
        print(f"[bound] panel_adj {tag} phase A: {ba!r} ms (bytes)")
    else:
        GT, Yf = csr_of_panels(lv, transpose=True), Y.reshape(-1)

        def library():
            return torch.mv(GT, Yf)

        lib_out = library()
    compare(f"panel_adj {tag} library", lib_out, ref)
    b, o = bound_ms(8 * (nD * N * p * C + N * C + m * nD + lv.n_J),
                    2 * nD * m * C)
    row = dict(bound_ms=b, bound_by=o, form=form, **timings(
        f"panel_adj {tag}", lambda: K.panel_adj(*args),
        lambda: K.panel_adj_plain(*args), library))
    print(f"[bound] panel_adj {tag}: {b!r} ms ({o})")
    return err, row


def fwd_cone_phases(prob, ops, torch, K, rng, tag):
    """K1 (``panel_fwd_phase``) and K2 at a level's top-level shapes
    (``ops``, the problem's cone grids), K2 against its plain version
    (bitwise, every mode) and timed in each mode. Returns their
    records."""
    from mgbtpu_torch.solver.mgb import barrier_weights

    dev = torch.device("cuda")
    M = prob.M[0]
    nD = ops.nD
    m = ops.N * ops.p

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    f8 = 8
    k1 = panel_fwd_phase(ops, torch, K, rng, tag)

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
                 + (4 * nz ** 3 + nD * nD if mode == 2 else 0))))
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


def top_level_ops(M, tag, torch):
    """The panel operators of system M's top level, on the card."""
    from mgbtpu_torch.solver.levelops import build_panel_ops

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
    top-level shapes; K5a and K5b on its nested-dissection plan's fronts
    (``level_front_phases``)."""
    ops = top_level_ops(prob.M[0], f"L={L}", torch)
    rng = np.random.default_rng(L)
    fwd_cone_phases(prob, ops, torch, K, rng, f"L={L}")
    node_barrier_level(mg, prob, f"L={L}", 100 + L, torch, K)
    level_front_phases(prob, ops, L, torch, K, rng)
    torch.cuda.synchronize()


def level_front_phases(prob, ops, L, torch, K, rng):
    """K5a on every tree level of level L's nested-dissection plan (the
    fronts of one ``nd_factor`` of seeded SPD element blocks) against its
    plain version, per level and per ``nd_factor`` timed beside its bound,
    the plain version and the library composition; K5b on those factors,
    per ``nd_solve`` beside its bound (``solve_phases``)."""
    from mgbtpu_torch.solver.mgb import ProblemKernels, nd_plan

    t0 = time.time()
    nd = nd_plan(prob.M[0], ops, ProblemKernels.ND_LEAF_ELEMS,
                 torch.device("cuda"))
    print(f"[setup] L={L} ND plan {time.time() - t0!r} s")
    levels, fact = recorded_fronts(nd, ops.N, ops.C, torch, K, rng)
    factor_levels_phase(f"L={L}", levels, torch, K, reps=20, plain_reps=10)
    del levels
    solve_phases(nd, fact, torch, K, rng, tag=f" L={L}")


def kernel_phases(prob, torch, K):
    """Each kernel against its plain version at the top-level shapes."""
    from mgbtpu_torch.solver.levelops import build_panel_ops

    dev = torch.device("cuda")
    M = prob.M[0]
    ops = top_level_ops(prob.M[0], "L=5", torch)
    rng = np.random.default_rng(1234)
    records = list(fwd_cone_phases(prob, ops, torch, K, rng, "L=5"))

    # K3 panel_adj: the top level (the record) and the coarsest level
    ops0 = build_panel_ops(M.D_fine, M.nu, M.R_fine[0],
                           M.geometry.x.shape[0], dev)
    errs, rows = [], {}
    for tag, lv in (("top level", ops), ("coarsest level", ops0)):
        err, rows[tag] = panel_adj_phase(lv, torch, K, rng, tag)
        errs.append(err)
    records.append(dict(
        name="panel_adj", source="mgbtpu_torch/kernels/csrc/panel_adj.cu",
        replaces="mgbtpu/ops/pallas_dd.py:228", max_abs_err=max(errs),
        **rows["top level"]))

    # K4 gram_matvec: the top level (the record) and the coarsest level
    errs, rows = [], {}
    for tag, lv in (("top level", ops), ("coarsest level", ops0)):
        err, rows[tag] = gram_matvec_phase(lv, torch, K, rng, tag)
        errs.append(err)
    records.append(dict(
        name="gram_matvec", source="mgbtpu_torch/kernels/csrc/gram_matvec.cu",
        replaces="mgbtpu/ops/pallas_dd.py:142", max_abs_err=max(errs),
        **rows["top level"]))
    records += front_phases(prob, ops, torch, K, rng)
    torch.cuda.synchronize()
    return records


def hessian_csr(lv, Ln):
    """H = sum_e P_e' L_e L_e' P_e (n_J x n_J) as a CUDA CSR tensor, from
    the element blocks (L_e' P_e)'(L_e' P_e) by a COO sum: the one PyTorch
    call that computes K4's H v is ``torch.mv`` on it (built once, outside
    the timing, as K6's library call takes a pre-formed Hz)."""
    import torch

    nD, N, p, C = lv.panels.shape
    X = torch.einsum("Nqji,jNqc->Nqic", Ln.reshape(N, p, nD, nD), lv.panels)
    Hb = torch.einsum("Nqic,Nqid->Ncd", X, X)
    del X
    rows = lv.cols[:, :, None].expand(N, C, C).reshape(-1)
    cols = lv.cols[:, None, :].expand(N, C, C).reshape(-1)
    return torch.sparse_coo_tensor(
        torch.stack([rows, cols]), Hb.reshape(-1),
        (lv.n_J, lv.n_J)).coalesce().to_sparse_csr()


def gram_matvec_phase(lv, torch, K, rng, tag):
    """K4 at a level's shapes (``lv``) against its plain version (one count
    a call, the repeat call bitwise; where the cluster form takes the shape
    also bitwise equal to ``gram_matvec_cluster_plain`` at the R it picks),
    timed against its plain version and ``torch.mv`` on the assembled
    Hessian in CSR (``hessian_csr``). Returns (max abs error, its timing
    row with the bound)."""
    gm = sys.modules[K.gram_matvec.__module__]
    dev = torch.device("cuda")
    nD, N, p, C = lv.panels.shape
    m = N * p

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    Ln = t(np.tril(rng.standard_normal((m, nD, nD))))
    v = t(rng.standard_normal(lv.n_J))
    args = (lv.panels, lv.cols, lv.inv, Ln, v)
    before = K.gram_matvec.launches
    out = K.gram_matvec(*args)
    ref = K.gram_matvec_plain(*args)
    err = compare(f"gram_matvec {tag}", out, ref)
    same_bits(f"gram_matvec {tag}", out, K.gram_matvec(*args))
    if K.gram_matvec.launches != before + 2:
        raise RuntimeError("gram_matvec: not one count per call")
    form = gm.form(nD, N, p, C)
    print(f"[form] gram_matvec {tag} (nD, N, p, C) = {(nD, N, p, C)}: form "
          f"{form}")
    if form == 2:
        R = gm.cluster_size(nD, N, p, C)
        occ = {r: gm.cluster_occupancy(nD, p, C, r) for r in (1, 2, 4, 8)}
        print(f"[form] gram_matvec {tag}: cluster form, R = {R}; clusters "
              f"the card holds at once by R {occ}")
        same_bits(f"gram_matvec {tag}", out,
                  K.gram_matvec_cluster_plain(*args, R),
                  f"its cluster plain version (R = {R})")
    H = hessian_csr(lv, Ln)

    def library():
        return torch.mv(H, v)

    compare(f"gram_matvec {tag} library", library(), ref)
    b, o = bound_ms(8 * (nD * N * p * C + N * C + m * nD * (nD + 1) // 2
                         + 2 * lv.n_J),
                    4 * nD * m * C + 4 * m * nD * nD)
    row = dict(bound_ms=b, bound_by=o, **timings(
        f"gram_matvec {tag}", lambda: K.gram_matvec(*args),
        lambda: K.gram_matvec_plain(*args), library))
    print(f"[bound] gram_matvec {tag}: {b!r} ms ({o})")
    del H
    return err, row


def front_phases(prob, ops, torch, K, rng):
    """K5a/K5b on the top level's nested-dissection fronts: one
    ``nd_factor`` through the plain fronts records each tree level's
    assembled fronts, and each level's kernel call is held against the
    plain version on the same fronts (factor) and factors (solves)."""
    from mgbtpu_torch.solver.mgb import ProblemKernels, nd_plan

    nd = nd_plan(prob.M[0], ops, ProblemKernels.ND_LEAF_ELEMS,
                 torch.device("cuda"))
    levels, fact = recorded_fronts(nd, ops.N, ops.C, torch, K, rng)
    err, row = factor_levels_phase("L=5", levels, torch, K)
    records = [dict(
        name="front_factor", source="mgbtpu_torch/kernels/csrc/front_factor.cu",
        replaces="mgbtpu/ops/pallas_dd.py:446",
        max_abs_err=max(err, front_l7_phases(torch, K)), **row)]
    records.append(solve_phases(nd, fact, torch, K, rng))
    return records


def recorded_fronts(nd, N, C, torch, K, rng):
    """Each tree level's assembled fronts [(F, amax, bmax)] of one
    ``nd_factor`` (through the plain version) of seeded SPD element blocks
    (N, C, C), and the factors it returns."""
    from mgbtpu_torch.ops.ndchol import nd_factor

    X = rng.standard_normal((N, C, 2 * C))
    He = torch.as_tensor(X @ X.transpose(0, 2, 1) / C, device="cuda")
    levels = []

    def record(F, a, b):
        levels.append((F.clone(), a, b))
        return K.front_factor_plain(F, a, b)

    fact = nd_factor(nd, He, 2 * torch.finfo(torch.float64).eps,
                     factor=record)
    print("[shapes] ND fronts (nk, amax, bmax) leaf..root: "
          f"{[(F.shape[0], a, b) for F, a, b in levels]}")
    return levels, fact


def in_form(fn, code, *args):
    """``fn(*args)`` with its C entry forced to form ``code`` (the wrapper
    module's private ``_FORM``; 0 by shape)."""
    mod = sys.modules[fn.__module__]
    mod._FORM = code
    try:
        return fn(*args)
    finally:
        mod._FORM = 0


def factor_levels_phase(tag, levels, torch, K, reps=50, plain_reps=50):
    """K5a on each tree level's fronts [(F, a, b)] against its plain
    version, the repeat call bitwise, the form its shape rule gives it
    checked (its large count); each level timed in that form and in the
    other form that takes it (the crossover), beside the plain version and
    the library composition; one ``nd_factor``'s worth of calls timed
    against the plain version and the library composition. Returns (max
    abs error, the timing row with the bound)."""
    mod = sys.modules[K.front_factor.__module__]
    errs = []
    for li, (F, a, b) in enumerate(levels):
        code = mod.form_of(F.shape[0], a, b)
        before = K.front_factor.large_launches
        outs = K.front_factor(F, a, b)
        if K.front_factor.large_launches - before != (code == mod.LARGE):
            raise RuntimeError(f"front_factor {tag} level {li}: not in the "
                               f"form its shape gives ({code})")
        for part, out, ref, again in zip(("Lf", "U", "S"), outs,
                                         K.front_factor_plain(F, a, b),
                                         K.front_factor(F, a, b)):
            name = f"front_factor {tag} level {li} {(F.shape[0], a, b)} {part}"
            errs.append(compare(name, out, ref))
            same_bits(name, out, again)
    for li, (F, a, b) in enumerate(levels):
        code = mod.form_of(F.shape[0], a, b)
        other = (mod.LARGE if code != mod.LARGE
                 else mod.ONE_PANEL if a + b <= mod.ONE_PANEL_F else None)
        ms, _ = device_ms(lambda: K.front_factor(F, a, b), 10)
        pms, phid = device_ms(lambda: K.front_factor_plain(F, a, b), 10)
        lms, lhid = device_ms(lambda: factor_library(torch, F, a, b), 10)
        print(f"[time] front_factor {tag} level {li} {(F.shape[0], a, b)}: "
              f"device ms per call {ms!r} ({mod.FORM_NAMES[code]} form); "
              f"plain {pms!r}"
              + ("" if phid else " (host not hidden: an upper bound)")
              + f"; library composition {lms!r}"
              + ("" if lhid else " (host not hidden: an upper bound)")
              + f"; bound {factor_bound([(F, a, b)])[0]!r} ms")
        if other is None:
            print(f"[form] front_factor {tag} level {li} f={a + b}: "
                  f"{mod.FORM_NAMES[code]} {ms!r} ms, the only form that "
                  f"takes it")
            continue
        oms, _ = device_ms(lambda: in_form(K.front_factor, other, F, a, b),
                           10)
        print(f"[form] front_factor {tag} level {li} f={a + b}: "
              f"{mod.FORM_NAMES[code]} {ms!r} ms, {mod.FORM_NAMES[other]} "
              f"{oms!r} ms: the rule's form is "
              f"{'faster' if ms <= oms else 'slower'}")
    bnd, by = factor_bound(levels)
    print(f"[bound] front_factor {tag}: {bnd!r} ms per nd_factor ({by})")
    row = timings(
        f"front_factor {tag} ({len(levels)} levels, one nd_factor)",
        lambda: [K.front_factor(F, a, b) for F, a, b in levels],
        lambda: [K.front_factor_plain(F, a, b) for F, a, b in levels],
        plain_reps=plain_reps, reps=reps)
    factor_library_ms(torch, tag, levels)   # printed: three calls, not one
    return max(errs), dict(bound_ms=bnd, bound_by=by, **row)


def factor_bound(levels):
    """K5a's bound for one ``nd_factor`` over ``levels`` [(F, a, b)]: each
    front's entries read once, Lf, U and S written once; the flops of the
    column-by-column elimination, each symmetric update (A's trailing
    block, S) on its lower triangle only, as the kernel computes it."""
    nbytes = nops = 0
    for F, a, b in levels:
        f, nk = a + b, F.shape[0]
        nbytes += 8 * nk * (f * f + a * a + a * b + b * b)
        for j in range(a):
            w = a - 1 - j
            nops += nk * (w * (w + 1) + 2 * b * w + b * (b + 1) + w + b + 1)
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
    err, _ = factor_levels_phase("L=7", seeded_fronts(torch, shapes, 7),
                                 torch, K, reps=20, plain_reps=10)
    return err


def seeded_fronts(torch, shapes, seed):
    """SPD fronts [(F (nk, f+1, f+1), a, b)] at ``shapes`` [(nk, a, b)], made
    on the card from a generator seeded there."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    levels = []
    for nk, a, b in shapes:
        f = a + b
        X = torch.randn((nk, f, 2 * f), generator=g, dtype=torch.float64,
                        device="cuda")
        F = torch.zeros((nk, f + 1, f + 1), dtype=torch.float64,
                        device="cuda")
        F[:, :f, :f] = X @ X.mT / f + 0.5 * torch.eye(f, device="cuda")
        del X
        levels.append((F, a, b))
    return levels


L2_BYTES = 50e6     # H100 L2 (NVIDIA data sheet)


def solve_bound(levels, n_J):
    """K5b's bound for one ``nd_solve`` over ``levels``: rhs in and x out;
    the forward sweep reads each level's Lf lower triangle and U, the
    vector entries it gathers and writes y; the backward sweep, which
    starts at the root where the forward sweep ended, reads them again
    less what the L2 can still hold: the factors count 2 fbytes - min(
    fbytes, 50 MB) (once below the L2, twice less an L2's worth above
    it); two flops a factor entry a sweep and the separator updates.
    Returns (ms, by, factor bytes)."""
    f8, nops = 8, 0
    fbytes = sum(f8 * L.nk * (L.amax * (L.amax + 1) // 2 + L.amax * L.bmax)
                 for L in levels)
    nbytes = f8 * 2 * (n_J + 1) + 2 * fbytes - min(fbytes, L2_BYTES)
    for L in levels:
        nk, a, b = L.nk, L.amax, L.bmax
        nbytes += f8 * nk * (a + b)
        nops += nk * (2 * a * a + 4 * a * b) + int((L.bdofs < n_J).sum())
    return (*bound_ms(nbytes, nops), fbytes)


def solve_phases(nd, fact, torch, K, rng, tag=""):
    """K5b on the factors of one ``nd_factor``: each tree level's fused
    call in both sweeps against the plain versions, in the form its shape
    rule gives it (its large count checked), timed in that form and in the
    other (the crossover); the whole ``nd_solve`` against the plain
    composition, its launches counted (one a level and sweep, the large
    ones a large level's); the device time per ``nd_solve`` and per launch,
    beside its bound and the same sweeps' triangular solves through
    ``torch.linalg.solve_triangular`` alone."""
    from mgbtpu_torch.ops.ndchol import nd_solve

    mod = sys.modules[K.front_forward.__module__]
    dev = torch.device("cuda")
    fact = [(Lf.contiguous(), U.contiguous()) for Lf, U in fact]
    n_J = nd.n_J
    rhs = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    pad = torch.zeros(1, dtype=torch.float64, device=dev)
    r0 = torch.cat([rhs, pad])
    x0 = torch.cat([torch.as_tensor(rng.standard_normal(n_J), device=dev),
                    pad])
    errs, n_large = [], 0
    for li, (L, (Lf, U)) in enumerate(zip(nd.levels, fact)):
        y = torch.as_tensor(rng.standard_normal((L.nk, L.amax)), device=dev)
        code = mod.form_of(L.nk, L.amax, L.bmax)
        n_large += code == mod.LARGE
        before = K.front_solve.large_launches
        got = []
        for fwd, bwd in ((K.front_forward, K.front_backward),
                         (K.front_forward_plain, K.front_backward_plain)):
            r, x = r0.clone(), x0.clone()
            got.append((*fwd(Lf, U, L.adofs, r, L.b_rows, L.b_inc), r,
                        bwd(Lf, U, L.adofs, L.bdofs, y, x), x))
        if K.front_solve.large_launches - before != 2 * (code == mod.LARGE):
            raise RuntimeError(f"front_solve{tag} level {li}: not in the "
                               f"form its shape gives ({code})")
        for part, out, ref in zip(("y", "upd", "r", "xA", "x"), *got):
            errs.append(compare(f"front_solve{tag} level {li} {part}", out,
                                ref))
        other = mod.ONE_BLOCK if code == mod.LARGE else mod.LARGE
        r, x = r0.clone(), x0.clone()

        def level(c):
            y_ = in_form(K.front_forward, c, Lf, U, L.adofs, r, L.b_rows,
                         L.b_inc)[0]
            in_form(K.front_backward, c, Lf, U, L.adofs, L.bdofs, y_, x)

        ms, _ = device_ms(lambda: level(code), 10)
        oms, _ = device_ms(lambda: level(other), 10)
        print(f"[form] front_solve{tag} level {li} "
              f"{(L.nk, L.amax, L.bmax)} f={L.amax + L.bmax}: both sweeps "
              f"{mod.FORM_NAMES[code]} {ms!r} ms, {mod.FORM_NAMES[other]} "
              f"{oms!r} ms: the rule's form is "
              f"{'faster' if ms <= oms else 'slower'}")

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
    errs.append(compare(f"nd_solve{tag} (front_solve, every level)", x,
                        nd_solve_plain()))
    same_bits(f"nd_solve{tag} (front_solve, every level)", x,
              nd_solve(nd, fact, rhs))
    before = (K.front_solve.launches, K.front_solve.large_launches)
    nd_solve(nd, fact, rhs)
    per_solve = K.front_solve.launches - before[0]
    per_large = K.front_solve.large_launches - before[1]
    if (per_solve, per_large) != (2 * len(nd.levels), 2 * n_large):
        raise RuntimeError(f"nd_solve made {per_solve} front_solve launches, "
                           f"{per_large} large, not one per tree level and "
                           f"sweep, {2 * n_large} large")
    print(f"[kernels] nd_solve{tag}: {per_solve} front_solve launches "
          f"({per_large} in the large form) over {len(nd.levels)} levels")

    bnd, by, fbytes = solve_bound(nd.levels, n_J)
    sweeps = [(Lf, t) for Lf, _ in fact for t in (False, True)]
    rs = [torch.as_tensor(rng.standard_normal((Lf.shape[0], Lf.shape[1], 1)),
                          device=dev) for Lf, _ in sweeps]
    row = timings(
        f"front_solve{tag} (one nd_solve: {per_solve} launches)",
        lambda: nd_solve(nd, fact, rhs),
        nd_solve_plain,
        lambda: [torch.linalg.solve_triangular(Lf.mT if t else Lf, r,
                                               upper=t)
                 for (Lf, t), r in zip(sweeps, rs)], plain_reps=2, reps=10)
    print(f"[time] front_solve{tag}: device ms per launch "
          f"{row['ms'] / per_solve!r}"
          f" ({per_solve} per nd_solve); bound per nd_solve {bnd!r} ms "
          f"({by}; factors {fbytes!r} bytes, counted twice less "
          f"{min(fbytes, L2_BYTES)!r}: the L2's worth the backward sweep "
          f"may find on chip)")
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
    """Each call bitwise against the plain version of the order it runs in
    on the card (``node_barrier_gram_plain``: a runtime-width cone's
    Hessian in the Gram order, every other piece in the reference's order,
    as ``instance`` implies). Where a mode-2 call's table has a
    runtime-width cone, its largest error against the reference's order
    (``node_barrier_plain``) is printed beside ``gram_order_bound``'s
    ((nz^2 + nz + 8) eps times each entry's sum of absolute terms) and must
    lie within it. Returns the largest error against the plain version."""
    import torch

    from mgbtpu_torch.kernels.node_barrier import gram_order_bound

    errs = []
    for label, call in calls.items():
        name = f"node_barrier {tag} {label}"
        out = K.node_barrier(*call)
        ref = K.node_barrier_gram_plain(*call)
        errs.append(compare(name, out, ref))
        same_bits(name, out, ref, "the plain version")
        if call[0] != 2:
            continue
        bound = gram_order_bound(*call[1:6], call[7], call[8])
        if not bool(bound.any()):
            continue
        old = K.node_barrier_plain(*call)
        fin = torch.isfinite(old)
        if not torch.equal(fin, torch.isfinite(out)):
            raise RuntimeError(f"{name}: non-finite pattern differs from "
                               f"the reference order")
        err = (out - old).abs()[fin]
        worst = float((err / bound[fin].clamp_min(1e-300)).max())
        print(f"[kernel] {name}: against the reference order max_abs_err="
              f"{float(err.max())!r}, (a)'s bound up to "
              f"{float(bound[fin].max())!r}, largest error / bound "
              f"{worst!r}")
        if not worst <= 1.0:
            raise RuntimeError(f"{name}: past (a)'s bound of the reference "
                               f"order ({worst})")
    return max(errs)


def cone_library(call):
    """The library yardstick of a mode-2 call whose table has a
    runtime-width cone: one ``torch.einsum("nki,nkl,nlj->nij", A, Hz, A)``
    of its widest such cone, on the same A and a pre-formed Hz (the plain
    version's); None for any other call."""
    import torch

    from mgbtpu_torch.kernels import power_cone as K2
    from mgbtpu_torch.kernels.node_barrier import (CONE_WIDE, LINEAR_WIDE,
                                                   instance)

    mode, y, pieces, args, sel, bw, wc, co, box = call
    if mode != 2:
        return None
    codes = instance(pieces, mode, y.shape[1], co, box is not None).codes
    cones = [pc for pc, c in zip(pieces, codes)
             if CONE_WIDE <= c < LINEAR_WIDE]
    if not cones:
        return None
    pc = max(cones, key=lambda pc: pc.width)
    A, b, p, mu = pc.grids(args)
    q, s = K2.core_parts(A, b, pc.idx, y)
    if co is not None:
        s = s + y[:, co - 1]
    Hz = torch.stack([torch.stack(r, dim=1)
                      for r in K2.core_hess(q, s, p, mu, pc.spec)], dim=1)
    A3 = A.reshape(-1, pc.width, pc.width)
    return lambda: torch.einsum("nki,nkl,nlj->nij", A3, Hz, A3)


def k6_bound(call):
    """(bound ms, "bytes" or "operations") of one K6 call: the rows, bw,
    the pieces' grids, sel and the box read once, the output written once
    (wc read in modes 0 and 1); the operations the function needs per
    piece: its affine map, a few dozen for the closed forms, A'g in modes
    1 and 2, and in mode 2 A'HA (two nz x nz products of a cone's Hessian,
    4 nz^3; a linear block's A' diag(h) A, 2 nc ni^2), then the fold of
    each piece into the output (not the reference order's scalar nz^4
    fold)."""
    from mgbtpu_torch.kernels.node_barrier import POWER

    mode, y, pieces, args, sel, bw, wc, co, box = call
    m, ny = y.shape
    npc = len(pieces)
    grids = sum(g.numel() for pc in pieces for g in pc.grids(args))
    nbytes = 8 * (m * ny + m + grids + (m * npc if sel is not None else 0)
                  + (2 * m if box else 0) + (1, ny, ny * ny)[mode]
                  * m + (m * ny if mode < 2 else 0))
    nops = m * (sum(2 * pc.width * len(pc.idx) * (1 + (mode > 0)) + 30
                    + (0 if mode < 2 else 4 * pc.width ** 3
                       if pc.kind == POWER
                       else 2 * pc.width * len(pc.idx) ** 2)
                    for pc in pieces) + npc * (1, ny, ny * ny)[mode])
    return bound_ms(nbytes, nops)


def k6_time(tag, call, K, plain=True, reps=50):
    """Device ms of one K6 call, its plain version's (unless ``plain`` is
    False) and the library call's (``cone_library``, where the table has a
    runtime-width cone), and its bound (``k6_bound``). The plain version
    timed is the kernel's order (``node_barrier_gram_plain``)."""
    from mgbtpu_torch.kernels.node_barrier import instance

    mode, y, pieces, args, sel, bw, wc, co, box = call
    ny = y.shape[1]
    bnd, by = k6_bound(call)
    print(f"[instance] node_barrier {tag}: "
          f"{instance(pieces, mode, ny, co, box is not None)}")
    row = dict(bound_ms=bnd, bound_by=by, **timings(
        f"node_barrier {tag} (ny={ny}, {len(pieces)} pieces)",
        lambda: K.node_barrier(*call),
        (lambda: K.node_barrier_gram_plain(*call)) if plain else None,
        cone_library(call), plain_reps=2, reps=reps))
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


def node_barrier_level(mg, prob, tag, seed, torch, K):
    """K6 at a 2D level's top-level shapes (``tag``) on random rows: the
    obstacle table and parabolic_solve's pair, each bitwise against its
    plain version in all six calls of ``k6_calls``; timed on the
    obstacle's Hessian (mode 2) and the pair's phase-I Hessian (co mode
    2)."""
    import mgbtpu_torch.solver.parabolic as P
    from mgbtpu_torch import intersect
    from mgbtpu_torch.convex import convex_euclidian_power, convex_linear

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
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
        errs.append(k6_check(f"{tag} {name}", calls, K))
        k6_time(f"{tag} {name} {label}", calls[label], K)
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

    disc = mg.geometry.discretization
    sp = disc.default_slack_space()
    return prepare_amg(mg, state_variables=[("u", "dirichlet"), ("s1", sp),
                                            ("s2", sp)],
                       D=P.default_D_parabolic(disc.dim))


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

    prob = zoo.two_sided_obstacle(mg5, **cuda)
    secs, sol, la, co = counted(torch, K, lambda: mgb_solve(prob, **cuda))
    report("zoo.two_sided_obstacle L=5", secs, sol, "n/a")
    print(f"[solve] zoo.two_sided_obstacle L=5 wall {secs!r} s on {smi}; "
          f"launches {la}")
    require_launches("two_sided_obstacle L=5", la, MESH + ["node_barrier"])
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
    require_launches("parabolic_solve L=5", la_par, MESH + ["node_barrier"])
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

def check_totals(tag, sol, ref, polish_its=None):
    """A p-Laplace solve against its x64 record: the solution within TOL_Z,
    the total Newton its within 5 %; prints the CG counts beside them.
    With ``polish_its`` given, the last ramp step, whose exact-stopping
    polish runs at the objective's roundoff floor, is held apart: within
    ``polish_its`` of x64's, the steps before it within 5 %."""
    z_ref = ref["z"]
    zerr = float(np.linalg.norm(sol.z - z_ref) / np.linalg.norm(z_ref))
    S = sol.SOL_main
    n = None if polish_its is None else -1
    its, its_ref = int(S["its"][:, :n].sum()), int(ref["its"][:, :n].sum())
    last, last_ref = int(S["its"][:, -1].sum()), int(ref["its"][:, -1].sum())
    cg_ref = int(ref["cg"].sum()) if "cg" in ref else None
    print(f"[reference] {tag}: |z - z_ref|/|z_ref| = {zerr!r}; its "
          f"{int(S['its'].sum())} vs {int(ref['its'].sum())} (x64); per "
          f"level {S['its'].sum(axis=1).tolist()} vs "
          f"{ref['its_per_level'].tolist()}; last ramp step "
          f"{last} vs {last_ref}; cg {int(S['cg'].sum())} vs {cg_ref}; "
          f"steps {[S['steps_accepted'], S['steps_attempted']]} vs "
          f"{ref['steps'].tolist()}"
          + ("" if polish_its is None else f"; held: the steps before the "
             f"last, {its} vs {its_ref}, the last within {polish_its}"))
    if not zerr <= TOL_Z:
        raise RuntimeError(f"{tag}: solution differs from the x64 "
                           f"reference: {zerr}")
    if abs(its - its_ref) > TOL_ITS * its_ref:
        raise RuntimeError(f"{tag}: Newton its {its} not within 5% of "
                           f"{its_ref}")
    if polish_its is not None and abs(last - last_ref) > polish_its:
        raise RuntimeError(f"{tag}: last ramp step's its {last} not within "
                           f"{polish_its} of {last_ref}")


def timed_setup(tag, build):
    """build() (a problem's geometry, amg and assemble), its seconds
    printed."""
    t0 = time.time()
    prob = build()
    print(f"[setup] {tag}: geometry + amg + assemble {time.time() - t0!r} s")
    return prob


def require_forms(tag, K, large):
    """The front kernels' large forms launched in the run just counted
    (``large`` True: both did, the fem3d fronts) or not at all (False: the
    fem2d fronts keep their one-block forms); prints their counts."""
    big = (K.front_factor.large_launches, K.front_solve.large_launches)
    print(f"[form] {tag}: large-form launches front_factor {big[0]} of "
          f"{K.front_factor.launches}, front_solve {big[1]} of "
          f"{K.front_solve.launches}")
    if large and not all(big):
        raise RuntimeError(f"{tag}: the large front forms did not launch")
    if not large and any(big):
        raise RuntimeError(f"{tag}: a front took the large form")


def p_laplace_solve(tag, prob, torch, K, smi, need, ref=None,
                    polish_its=None, large=None, k3=None):
    """One p=1 ``mgb_solve`` of ``prob`` on the card, with
    the launch counters set to 0 just before it and read just after:
    prints its wall, counts, host syncs and launches, requires the kernels
    ``need`` to have launched (and the front kernels' large forms to have
    launched, ``large`` True, or not, False: ``require_forms``), checks
    K3's phase-A forms (``k3``: the stored level shapes, or True for none;
    ``k3_forms``), and holds it to the x64 record ``ref`` where given
    (``check_totals``): a file
    under ``mgbtpu_torch/data``, or a record (``ref_record``). Returns the
    solution and the launches."""
    from mgbtpu_torch import mgb_solve
    from mgbtpu_torch.solver.newton import SYNCS

    SYNCS["n"] = 0
    secs, sol, la, _ = counted(torch, K,
                               lambda: mgb_solve(prob, device="cuda"))
    report(tag, secs, sol, SYNCS["n"])
    print(f"[kernels] launches in the {tag} solve ({secs!r} s wall on "
          f"{smi}): {la}; power_cone by mode 0/1/2: "
          f"{K.power_cone_eval.mode_launches}")
    require_launches(tag, la, need)
    if large is not None:
        require_forms(tag, K, large)
    if k3 is not None:
        k3_forms(tag, prob, K, K.panel_adj.bulk_launches,
                 None if k3 is True else k3)
    if isinstance(ref, str):
        ref = np.load(os.path.join(DATA, ref))
    if ref is not None:
        check_totals(tag, sol, ref, polish_its)
    return sol, la


def fem3d_kernel_phases(prob, L, torch, K):
    """K1, K3, K4, K5a and K5b at the fem3d k=3 (Q3, p = 64) level-L
    shapes, where K1's wide form, K4's cluster form, K3's bulk form and
    the front kernels' large forms take them: K1, K3 and K4 against their
    plain versions (K4 also against its cluster plain version's bits, K3
    against its rows plain version's) and timed on the top level of the
    main system (nD = 5) and of the phase-I system (nD = 8), K3's phase A
    and phase B also apart; K5a on every tree level of the top level's
    nested dissection (seeded SPD element blocks), one ``nd_factor``'s
    worth timed; K5b (``solve_phases``) on those factors, one
    ``nd_solve``'s worth timed. Returns their records (launches to be
    filled in)."""
    from mgbtpu_torch.solver.mgb import ProblemKernels, nd_plan

    tag = f"fem3d L={L}"
    rng = np.random.default_rng(3000 + L)
    ops = top_level_ops(prob.M[0], tag, torch)
    k1 = panel_fwd_phase(ops, torch, K, rng, tag)
    err4, row4 = gram_matvec_phase(ops, torch, K, rng, tag)
    err3, row3 = panel_adj_phase(ops, torch, K, rng, tag, apart=True)
    ops1 = top_level_ops(prob.M[1], f"{tag} phase I", torch)
    k1["max_abs_err"] = max(k1["max_abs_err"], panel_fwd_phase(
        ops1, torch, K, rng, f"{tag} phase I")["max_abs_err"])
    err4 = max(err4, gram_matvec_phase(ops1, torch, K, rng,
                                       f"{tag} phase I")[0])
    err3 = max(err3, panel_adj_phase(ops1, torch, K, rng, f"{tag} phase I",
                                     apart=True)[0])
    del ops1
    t0 = time.time()
    nd = nd_plan(prob.M[0], ops, ProblemKernels.ND_LEAF_ELEMS,
                 torch.device("cuda"))
    print(f"[setup] {tag} ND plan {time.time() - t0!r} s")
    shapes = [(lv.nk, lv.amax, lv.bmax) for lv in nd.levels]
    stored = {4: FEM3D_L4, 5: FEM3D_L5}.get(L)
    if stored is not None and shapes != stored:
        raise RuntimeError(f"{tag}: the ND plan's levels {shapes} are not "
                           f"the stored FEM3D_L{L} {stored}")
    levels, fact = recorded_fronts(nd, ops.N, ops.C, torch, K, rng)
    err5, row5 = factor_levels_phase(tag, levels, torch, K, reps=10,
                                     plain_reps=5)
    k5b = solve_phases(nd, fact, torch, K, rng)
    torch.cuda.synchronize()
    name = f" (fem3d k=3 L={L})"
    form3 = K3_FORMS[row3.pop("form")]
    k1["name"] += name
    k5b["name"] += name
    return [k1, k5b, dict(
        name="gram_matvec" + name,
        source="mgbtpu_torch/kernels/csrc/gram_matvec.cu",
        replaces="mgbtpu/ops/pallas_dd.py:142", max_abs_err=err4, **row4),
        dict(name=f"panel_adj{name[:-1]}, {form3} form)",
             source="mgbtpu_torch/kernels/csrc/panel_adj.cu",
             replaces="mgbtpu/ops/pallas_dd.py:228", max_abs_err=err3,
             **row3),
        dict(name="front_factor" + name,
             source="mgbtpu_torch/kernels/csrc/front_factor.cu",
             replaces="mgbtpu/ops/pallas_dd.py:446", max_abs_err=err5,
             **row5)]


def fem3d_problem(L):
    from mgbtpu_torch import amg, assemble, fem3d, subdivide

    return assemble(amg(subdivide(fem3d(k=3), L)), p=1.0, device="cuda")


# (nk, amax, bmax) leaf .. root of the fem3d k=3 L=4 and L=5 plans (the
# main system's NDPlan, from subdivide(fem3d(k=3), L) -> amg ->
# assemble(p=1)); ``fem3d_kernel_phases`` checks each against the plan it
# builds (L=5 with ``--fem3d-level 5``: ~1 minute of host setup). L=5: N =
# 4,096 hexes, n_J = 365,967. The card and CPU tests take them from here.
FEM3D_L4 = [(64, 637, 218), (32, 25, 313), (16, 55, 403), (8, 121, 397),
            (4, 121, 529), (2, 253, 529), (1, 529, 1)]
FEM3D_L5 = [(512, 637, 218), (256, 25, 362), (128, 55, 578), (64, 121, 866),
            (32, 121, 1273), (16, 253, 1669), (8, 529, 1657), (4, 529, 2209),
            (2, 1081, 2209), (1, 2209, 1)]


K3_FORMS = {1: "staged", 3: "spread", 4: "bulk"}   # K3's phase-A forms
# C of each level (coarsest .. top) of the fem3d k=3 main system (nD = 5)
# and phase-I system (nD = 8) at L = 2..5: N = 8^(L-1) hexes of p = 64
# nodes at every level (from subdivide(fem3d(k=3), L) -> amg ->
# assemble(p=1), the levels' panel columns); the shapes K3 meets in the
# fem3d solves. ``k3_forms`` checks the levels a solve built against them;
# the tests take them from here.
FEM3D_K3_C = {2: ((2, 4, 35, 91), (3, 7, 43, 155)),
              3: ((2, 11, 24, 72, 128), (3, 19, 40, 80, 192)),
              4: ((3, 9, 46, 32, 16, 128), (4, 15, 83, 48, 24, 192)),
              5: ((3, 12, 68, 65, 32, 16, 128),
                  (4, 20, 111, 103, 48, 24, 192))}


def fem3d_k3_shapes(L):
    """[(nD, N, p, C)] of every level of the fem3d k=3 level-L main and
    phase-I systems (``FEM3D_K3_C``)."""
    return [(nD, 8 ** (L - 1), 64, c)
            for nD, cs in zip((5, 8), FEM3D_K3_C[L]) for c in cs]


def k3_forms(tag, prob, K, bulk_launches, stored=None):
    """The phase-A form K3 takes at each level of ``prob``'s systems that
    the solve just run built (printed; the C entry's choice must agree
    with ``panel_adj.bulk_form_takes``), each among the stored shapes
    ``stored`` where given; K3's bulk form must have launched in the solve
    (``bulk_launches``) if a level takes it, and not otherwise."""
    mod = sys.modules[K.panel_adj.__module__]
    shapes = []
    for i, M in enumerate(prob.M):
        for pk in getattr(M, "_torch_kernel_cache", {}).values():
            for l in sorted(pk._plain):
                if not hasattr(pk._plain[l], "panels"):
                    continue        # a mesh's level: its shards' shapes
                shape = tuple(pk._plain[l].panels.shape)
                form = mod.form(*shape)
                print(f"[form] {tag} K3 system {i} level {l} (nD, N, p, C) "
                      f"= {shape}: phase A form {form}")
                if (form == 4) != mod.bulk_form_takes(*shape):
                    raise RuntimeError(f"{tag}: K3's C entry takes form "
                                       f"{form} at {shape}, against "
                                       f"bulk_form_takes")
                shapes.append(shape)
    if stored is not None and not set(shapes) <= set(stored):
        raise RuntimeError(f"{tag}: K3's level shapes {sorted(set(shapes))} "
                           f"are not among the stored {sorted(stored)}")
    bulk = any(mod.bulk_form_takes(*sh) for sh in shapes)
    print(f"[form] {tag}: K3 bulk-form launches {bulk_launches}")
    if bulk != (bulk_launches > 0):
        raise RuntimeError(f"{tag}: K3's bulk form launched "
                           f"{bulk_launches} times; a level takes it: "
                           f"{bulk}")


def seeded_nd(torch, shapes, rng):
    """An ND plan's tree levels at ``shapes`` [(nk, a, b)] over made-up dof
    maps on the card: level li's fronts own the next nk * a dofs, each
    front's b boundary dofs drawn from the dofs of the levels above (the
    root's the dump slot)."""
    from types import SimpleNamespace

    from mgbtpu_torch.ops.ndchol import NDLevel, boundary_incidence

    n_J = sum(nk * a for nk, a, _ in shapes)
    start, levels = 0, []
    t = lambda x: torch.as_tensor(x, device="cuda")  # noqa: E731
    for li, (nk, a, b) in enumerate(shapes):
        adofs = np.arange(start, start + nk * a).reshape(nk, a)
        start += nk * a
        pool = np.arange(start, n_J)
        bdofs = np.stack([np.sort(rng.choice(pool, b, replace=False))
                          if len(pool) >= b else np.full(b, n_J)
                          for _ in range(nk)])
        rows, inc = boundary_incidence(bdofs, n_J)
        levels.append(NDLevel(t(adofs), t(bdofs), t(rows), t(inc), li, nk, a,
                              b))
    return SimpleNamespace(levels=tuple(levels), parts=(), n_J=n_J)


def fem3d_l5_phases(torch, K):
    """K5a and K5b at the ten tree levels of the fem3d k=3 L=5 plan
    (``FEM3D_L5``) on seeded SPD fronts made on the card, without the L=5
    problem's host setup: K5a per level (its form, the other form, the
    plain version, the library composition) and per ``nd_factor``
    (``factor_levels_phase``); K5b on its factors over made-up dof maps
    (each level's fronts own distinct dofs, 365,967 in all as in the plan;
    each front's boundary dofs drawn from the levels above, the root's the
    dump slot), per level and per ``nd_solve`` (``solve_phases``). Returns
    the largest K5a and K5b errors."""
    t0 = time.time()
    levels = seeded_fronts(torch, FEM3D_L5, 5)
    torch.cuda.synchronize()
    print(f"[setup] fem3d L=5 seeded fronts on the card {time.time() - t0!r}"
          f" s: (nk, amax, bmax) leaf..root {FEM3D_L5}")
    err_a, _ = factor_levels_phase("fem3d L=5 (seeded)", levels, torch, K,
                                   reps=5, plain_reps=3)
    fact = [K.front_factor(F, a, b)[:2] for F, a, b in levels]
    del levels
    rng = np.random.default_rng(5005)
    nd = seeded_nd(torch, FEM3D_L5, rng)
    row = solve_phases(nd, fact, torch, K, rng, tag=" fem3d L=5 (seeded)")
    del fact
    torch.cuda.synchronize()
    print(f"[time] fem3d L=5 seeded phases {time.time() - t0!r} s")
    return err_a, row["max_abs_err"]


def slice7_solves(prob3d, L3d, torch, K, smi):
    """The solves of the tensor-product and P1 slice on the card: fem3d
    k=3 p=1 at L=3 and at L3d (``prob3d``, the slice's path; L3d = 4 by
    default), fem2d_P1 p=1 at L=5, each held to its x64 record (fem3d at
    L3d where one is stored), and the fem1d golden vector of
    ``tests/test_golden.py``. Returns the L3d solve's launches and wall
    seconds (its checks included)."""
    from mgbtpu_torch import amg, assemble, fem1d, fem2d_P1, subdivide

    cone_mesh = ["power_cone"] + MESH
    p_laplace_solve("fem3d k=3 L=3",
                    timed_setup("fem3d k=3 L=3", lambda: fem3d_problem(3)),
                    torch, K, smi, cone_mesh, "ref_fem3d_k3_L3.npz",
                    large=True, k3=fem3d_k3_shapes(3))
    ref = f"ref_fem3d_k3_L{L3d}.npz"
    if not os.path.exists(os.path.join(DATA, ref)):
        print(f"[reference] fem3d k=3 L={L3d}: no stored x64 record")
        ref = None
    t0 = time.time()
    _, la = p_laplace_solve(f"fem3d k=3 L={L3d}", prob3d, torch, K, smi,
                            cone_mesh, ref, large=True,
                            k3=(fem3d_k3_shapes(L3d) if L3d in FEM3D_K3_C
                                else True))
    la = dict(la, panel_adj_bulk=K.panel_adj.bulk_launches)
    wall = time.time() - t0
    p_laplace_solve("fem2d_P1 L=5", timed_setup("fem2d_P1 L=5", lambda: (
        assemble(amg(subdivide(fem2d_P1(), 5)), p=1.0, device="cuda"))),
        torch, K, smi, cone_mesh, "ref_fem2d_p1_L5.npz", P1_FLOOR_ITS,
        large=False, k3=True)
    gold = np.asarray([-1, -1, -1, 1, 0, 0, 2, 2.0]).reshape(2, -1).T
    sol, _ = p_laplace_solve(
        "fem1d golden", assemble(amg(fem1d(nodes=np.linspace(-1, 1, 3))),
                                 p=1.0, device="cuda"),
        torch, K, smi, ["panel_fwd", "power_cone", "panel_adj"])
    golden_check("fem1d golden", sol.z, gold)
    return la, wall


SPECTRAL_REF = "ref_spectral.npz"
ND_ONLY = ("gram_matvec", "front_factor", "front_solve")  # ND-CG levels


def spectral_problem(kind, n):
    """``amg(<kind>(n=n))`` and its p=1 problem on the card."""
    import mgbtpu_torch
    from mgbtpu_torch import amg, assemble

    mg = amg(getattr(mgbtpu_torch, kind)(n=n))
    return mg, assemble(mg, p=1.0, device="cuda")


def spectral_kernel_phases(mg, prob, torch, K):
    """K1 and K3 at the spectral2d n=32 top level (one element of 1,024
    nodes: nD = 4, C = 1,924) and at parabolic_solve's phase-I rows there
    (nD = 9), where their spread forms run: against their plain versions
    (max relative error, non-finite patterns, a repeat call bitwise) and
    their split plain versions (bitwise: K1's call, K3's phase A), timed
    beside their bound, their plain versions and one library call on the
    element's dense panel view (K3 also its phase A alone beside
    ``torch.mv``); K2 (every mode, bitwise) and K6
    (the obstacle table and the parabolic pair, every mode and the
    cobarrier form, bitwise) at those 1,024 nodes. Returns K1's and K3's
    records (launches to be filled in)."""
    tag = "spectral2d n=32"
    rng = np.random.default_rng(3200)
    ops = top_level_ops(prob.M[0], tag, torch)
    if forms(ops, K, tag) != (3, 3):
        raise RuntimeError(f"{tag}: K1/K3 not in their spread forms")
    k1, _ = fwd_cone_phases(prob, ops, torch, K, rng, tag)
    err3, row3 = panel_adj_phase(ops, torch, K, rng, tag)
    del ops
    tag1 = f"{tag} parabolic phase I"
    ops1 = top_level_ops(parabolic_systems(mg)[1], tag1, torch)
    if forms(ops1, K, tag1) != (3, 3):
        raise RuntimeError(f"{tag1}: K1/K3 not in their spread forms")
    err1 = panel_fwd_phase(ops1, torch, K, rng, tag1)["max_abs_err"]
    err3 = max(err3, panel_adj_phase(ops1, torch, K, rng, tag1)[0])
    del ops1
    node_barrier_level(mg, prob, tag, 3201, torch, K)
    torch.cuda.synchronize()
    name = f" ({tag})"
    k1["name"] += name
    k1["max_abs_err"] = max(k1["max_abs_err"], err1)
    return [k1, dict(name="panel_adj" + name,
                     source="mgbtpu_torch/kernels/csrc/panel_adj.cu",
                     replaces="mgbtpu/ops/pallas_dd.py:228",
                     max_abs_err=err3, **row3)]


def dense_times(tag, M, torch):
    """One ``assemble_dense`` and one ``equilibrated_solve`` (the dense
    level's Newton system: LU and two refinement sweeps) at the top level
    of system M, on the panel plan its solve built: device ms per call on
    seeded SPD node blocks, the assembly's peak memory above its inputs,
    and how ``torch.einsum`` picks its contraction order."""
    from mgbtpu_torch.solver.newton import equilibrated_solve

    dev = torch.device("cuda")
    kern = next(iter(M._torch_kernel_cache.values()))
    ops = kern.ops(M.depth - 1)
    rng = np.random.default_rng(7)
    B = torch.as_tensor(rng.standard_normal((ops.n_nodes, ops.nD, ops.nD)),
                        device=dev)
    Y = B @ B.transpose(1, 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    H = ops.assemble_dense(Y)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    H = H + torch.diag(H.diagonal().abs() + 1.0)
    g = torch.as_tensor(rng.standard_normal(ops.n_J), device=dev)
    a_ms, a_hid = device_ms(lambda: ops.assemble_dense(Y), reps=10)
    s_ms, s_hid = device_ms(lambda: equilibrated_solve(H, g), reps=10)
    oe = torch.backends.opt_einsum
    print(f"[time] {tag} top level (n_J={ops.n_J}, N={ops.N}, p={ops.p}, "
          f"nD={ops.nD}): assemble_dense {a_ms!r} ms, equilibrated_solve "
          f"{s_ms!r} ms (device ms per call"
          + ("" if a_hid and s_hid else "; host not hidden: upper bounds")
          + f"); the assembly's peak memory {extra} bytes above its inputs "
          f"(H: {8 * ops.n_J ** 2}, one (N, p, C, nD) intermediate: "
          f"{8 * ops.N * ops.p * ops.C * ops.nD}); torch.einsum path: "
          f"opt_einsum available {oe.is_available()}, enabled "
          f"{oe.enabled}, strategy {oe.strategy!r}")


def no_mesh_kernels(tag, la):
    """A solve of dense levels only (one element a level) launches no
    kernel of the ND-CG levels."""
    bad = [n for n in ND_ONLY if la[n]]
    if bad:
        raise RuntimeError(f"{tag}: launched {bad} on dense levels")


def spectral_solves(prob32, torch, K, smi):
    """The spectral slice's solves on the card: spectral2d n=32 p=1 (the
    slice's path: K1, K2 and K3 must launch, K4 and K5 must not) and
    spectral1d n=128, each held to its x64 record (``check_totals``), and
    the golden cases of ``tests/test_golden.py``: spectral1d n=5 and
    spectral2d n=5 (the last ramp step, their roundoff-floor polish,
    within FLOOR_ITS), and parabolic_solve on spectral1d n=4 and
    spectral2d n=4 (h=0.5; each step by ``check_record``), each within
    1e-6 of its golden vector. Each prints its wall, counts, host syncs
    and launches, and the dense level's assembly and solve times at its
    top level. Returns the n=32 solve's launches."""
    import mgbtpu_torch.solver.parabolic as P
    from mgbtpu_torch.solver.newton import SYNCS

    need = ["panel_fwd", "power_cone", "panel_adj"]
    _, la32 = p_laplace_solve("spectral2d n=32", prob32, torch, K, smi, need,
                              "ref_spectral2d_n32.npz")
    no_mesh_kernels("spectral2d n=32", la32)
    dense_times("spectral2d n=32", prob32.M[0], torch)
    for kind, n, polish in (("spectral1d", 128, None),
                            ("spectral1d", 5, FLOOR_ITS),
                            ("spectral2d", 5, FLOOR_ITS)):
        tag = f"{kind} n={n}"
        _, prob = timed_setup(tag, lambda: spectral_problem(kind, n))
        ref = ref_record(SPECTRAL_REF, f"{kind}_n{n}")
        sol, la = p_laplace_solve(tag, prob, torch, K, smi, need, ref,
                                  polish)
        no_mesh_kernels(tag, la)
        dense_times(tag, prob.M[0], torch)
        if "gold" in ref:
            golden_check(tag, sol.z, ref["gold"])
    for kind in ("spectral1d", "spectral2d"):
        tag = f"parabolic_solve {kind} n=4 h=0.5"
        mg, _ = spectral_problem(kind, 4)
        ref = ref_record(SPECTRAL_REF, f"parabolic_{kind}_n4")
        steps, mgb = [], P.mgb_solve

        def recording(prob, **kw):
            steps.append(mgb(prob, **kw))
            return steps[-1]

        P.mgb_solve = recording     # records each implicit step's solve
        SYNCS["n"] = 0
        try:
            secs, psol, la, co = counted(torch, K, lambda: P.parabolic_solve(
                mg, h=0.5, p=1.0, device="cuda"))
        finally:
            P.mgb_solve = mgb
        print(f"[solve] {tag} ({len(steps)} steps) wall {secs!r} s on {smi};"
              f" host syncs {SYNCS['n']}; launches {la}, K6 in cobarrier "
              f"form {co}")
        require_launches(tag, la, ["panel_fwd", "panel_adj", "node_barrier"])
        no_mesh_kernels(tag, la)
        if co == 0:
            raise RuntimeError(f"{tag}: no phase-I K6 launch")
        for j, s in enumerate(steps, 1):
            report(f"{tag} step {j} main ramp", None, s, "n/a")
            check_record(f"{tag} step {j}", s, ref_record(
                SPECTRAL_REF, f"parabolic_{kind}_n4/step{j}"))
        dense_times(tag, parabolic_systems(mg)[0], torch)
        golden_check(tag, np.stack(psol.u), ref["gold"])
    return la32


MODEL_M = 57344     # the L=7 node count: K6's wide tables are timed there
LSHAPE = os.path.join(DATA, "lshape_tri6.msh")


def _wide_rows(m, Q, nD, rng):
    """Seeded rows (m, nD) inside a wide table's sets at most nodes: small
    entries, the cones' s rows in (2, 4); about 1 % of the nodes pushed
    across the walls."""
    from mgbtpu_torch.kernels.node_barrier import POWER

    Dz = rng.uniform(-0.3, 0.3, (m, nD))
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == POWER})
    Dz[:, s_rows] = rng.uniform(2.0, 4.0, (m, len(s_rows)))
    bad = rng.choice(m, m // 100, replace=False)
    Dz[bad] *= rng.choice([-6.0, 6.0], (len(bad), nD))
    return Dz


def wide_tables(m, rng):
    """K6's tables past its first limits (4 pieces, 12 rows, cones
    nz <= 5), made up at m seeded nodes: six pieces over 10 rows (14 in
    phase I), a lone nz = 7 cone that K2 refuses on the three-field model's
    rows (10, the cone on rows 4..9 and 3, 15 in phase I with its 4
    component rows) with a full A, and five pieces over 16 rows, 20 with
    the phase-I box; as (name, Convex, D rows, phase-I component rows)."""
    import mgbtpu_torch as mt

    x = np.zeros((m, 2))
    cone, lin = mt.convex_euclidian_power, mt.convex_linear

    def rand_A(n):
        return np.tile(np.eye(n).reshape(1, -1), (m, 1)) \
            + 0.01 * rng.standard_normal((m, n * n))

    six = (cone(x=x, idx=(1, 2, 9), p=1.0), cone(x=x, idx=(3, 8), p=2.0),
           cone(x=x, idx=(4, 5, 6, 9), A_grid=rand_A(4), p=1.5),
           lin(x=x, idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
               b=lambda _: np.array([2.0, 2.0])),
           lin(x=x, idx=(0, 7), A_grid=rng.standard_normal((m, 6)),
               b_grid=rng.uniform(2.0, 4.0, (m, 3))),
           lin(x=x, idx=(7,), A=lambda _: np.array([[1.0]]),
               b=lambda _: np.array([3.0])))
    rows20 = [cone(x=x, idx=(3 * k, 3 * k + 1, 3 * k + 2, 15 - k // 2),
                   p=(1.0, 2.0, 1.5, 1.0)[k]) for k in range(4)]
    rows20.append(lin(x=x, idx=(12, 13), A_grid=rng.standard_normal((m, 4)),
                      b_grid=rng.uniform(2.0, 4.0, (m, 2))))
    return [("six pieces", mt.convex_piecewise(six, x=x), 10, 3),
            ("cone nz=7", cone(x=x, idx=(4, 5, 6, 7, 8, 9, 3),
                               A_grid=rand_A(7), p=2.0), 10, 4),
            ("20 rows", mt.intersect(x, *rows20), 16, 3)]


def wide_node_barrier_phases(torch, K):
    """K6's made-up wide tables (``wide_tables``) at m = 57,344 seeded
    nodes: each in modes 0/1/2 as the barrier and in the phase-I form
    (slack and component rows with the box), bitwise equal to the plain
    version, each mode 2 call timed beside its bound; the lone nz = 7 cone
    through ``Convex.barrier_terms`` launches K6, not K2."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(5734)
    m = MODEL_M
    w = np.full(m, 1.0 / m)
    for name, Q, nD, nu in wide_tables(m, rng):
        Dz = torch.as_tensor(_wide_rows(m, Q, nD, rng), dtype=torch.float64,
                             device=dev)
        calls = k6_calls(Q, Dz, nu, w, torch, K, rng)
        k6_check(f"{name} m={m}", calls, K)
        for label in ("mode 2", "co mode 2"):
            k6_time(f"{name} m={m} {label}", calls[label], K)
        if name == "cone nz=7":
            args = tuple(torch.as_tensor(a, device=dev) for a in Q.args)
            K.reset_launches()
            Q.barrier_terms(2, args, Dz, *calls["mode 2"][5:7])
            la = K.launches()
            print(f"[kernels] Convex.barrier_terms of the lone nz=7 cone: {la}; "
                  f"node_barrier with a wide piece "
                  f"{K.node_barrier.wide_launches}")
            if la["node_barrier"] != 1 or la["power_cone"] != 0 \
                    or K.node_barrier.wide_launches != 1:
                raise RuntimeError("the lone nz=7 cone did not route to K6")
    torch.cuda.synchronize()


def model_table_phases(tag, model, seed, torch, K):
    """K6 on the piece table a solved Model's lowering gives it, at the
    top level's nodes and rows (the path's own shapes): the solution's rows
    D z with 1 % of the nodes pushed outside (each cone's s row negative),
    in the six calls of ``k6_calls`` (the phase-I form with the model's own
    component rows), bitwise equal to the plain version; its mode 2 and co
    mode 2 calls timed (the plain version in mode 2 only: its thousands of
    small launches outrun the device's queue, so each timing of it spins
    for seconds). Returns (largest error, {label: timing row})."""
    from mgbtpu_torch.kernels.node_barrier import POWER

    prob = model._lowered["prob"]
    M, Q = prob.M[0], prob.Q
    rng = np.random.default_rng(seed)
    Dz = model._Dz()
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == POWER})
    bad = rng.choice(len(Dz), max(len(Dz) // 100, 1), replace=False)
    Dz[np.ix_(bad, s_rows)] = -rng.uniform(0.0, 1.0, (len(bad), len(s_rows)))
    print(f"[tables] {tag}: {len(Q.pieces)} pieces over {Dz.shape[1]} rows "
          f"({Dz.shape[1] + 1 + M.nu} in phase I), m = {Dz.shape[0]}")
    calls = k6_calls(Q, torch.as_tensor(Dz, device="cuda"), M.nu,
                     np.asarray(M.w, np.float64), torch, K, rng)
    err = k6_check(tag, calls, K)
    rows = {label: k6_time(f"{tag} {label}", calls[label], K,
                           plain=label == "mode 2")
            for label in ("mode 2", "co mode 2")}
    torch.cuda.synchronize()
    return err, rows


def check_duals(tag, got, ref):
    """Each dual within 1e-6 of the x64 record's, relative to its largest
    entry."""
    for key, d in got.items():
        d_ref = ref[f"dual_{key}"]
        err = float(np.abs(d - d_ref).max() / np.abs(d_ref).max())
        print(f"[reference] {tag} dual({key}): max |mu - mu_x64| / "
              f"max |mu_x64| = {err!r}")
        if not err <= TOL_Z:
            raise RuntimeError(f"{tag}: dual {key} differs from x64: {err}")


def model_solve(tag, name, mg, torch, K, smi, need, ref):
    """``port_models.MODELS[name]`` built on ``mg`` with ``Model(mg)`` (no
    device: the card) and solved with the launch counters set to 0 just
    before and read just after; prints its wall, counts and launches,
    requires ``need`` to have launched and holds it to its x64 record
    (``check_record``). Returns (model, constraints, solution, launches,
    K6's launches in cobarrier form, K6's with a wide piece)."""
    import mgbtpu_torch
    import port_models
    from mgbtpu_torch.solver.newton import SYNCS

    t0 = time.time()
    m, cons = port_models.MODELS[name](mgbtpu_torch, mg)
    SYNCS["n"] = 0
    secs, sol, la, co = counted(torch, K, lambda: m.solve(**port_models.SOLVE))
    wide = K.node_barrier.wide_launches
    report(tag, secs, sol, SYNCS["n"])
    print(f"[kernels] launches in the {tag} solve ({secs!r} s wall on "
          f"{smi}; lowering + amg + solve {time.time() - t0!r} s): {la}; "
          f"node_barrier by mode 0/1/2 {K.node_barrier.mode_launches}, in "
          f"cobarrier form {co}, with a wide piece {wide}; power_cone by "
          f"mode {K.power_cone_eval.mode_launches}; status {m.status}")
    require_launches(tag, la, need)
    check_record(tag, sol, ref)
    return m, cons, sol, la, co, wide


def html_check(tag, sol):
    """``plot3d_html`` of a card solution into a temporary directory: the
    structure ``tests/test_plot.py`` checks (balanced brackets in the
    script, the mesh's three arrays), without matplotlib."""
    import tempfile

    from mgbtpu_torch import plot3d_html

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        path = plot3d_html(sol, os.path.join(tmp, "view.html"))
        text = open(path).read()
        secs = time.time() - t0
    js = re.search(r"<script>(.*)</script>", text, re.S).group(1)
    mesh = json.loads(re.search(r"const MESH=(.*?);\n", text).group(1))
    ok = all(js.count(a) == js.count(b)
             for a, b in (("(", ")"), ("{", "}"), ("[", "]")))
    ok = ok and len(mesh["v"]) == len(mesh["c"]) == sol.z.shape[0] \
        and len(mesh["t"]) > 0
    print(f"[html] {tag}: plot3d_html wrote {len(text)} bytes in {secs!r} s "
          f"({len(mesh['v'])} vertices, {len(mesh['t'])} triangles); "
          f"structure ok: {ok}; matplotlib imported: "
          f"{'matplotlib' in sys.modules}")
    if not ok:
        raise RuntimeError(f"{tag}: plot3d_html structure")


def slice9_solves(mg5, torch, K, smi):
    """The front ends' paths on the card. (A) ``examples/model_dsl.py``'s
    elastoplastic torsion at L=5 through ``Model`` (K1, K3-K6 must launch),
    then ``dual()`` of its three constraints (the equality's through one
    mode-1 K6 launch), held to ``ref_model_torsion_L5.npz``, and
    ``plot3d_html`` of its solution. (B) the committed L-shaped mesh
    through ``gmsh_import`` (P2 with the bubble), ``assemble(amg(g),
    p=1.0)`` and ``mgb_solve`` (K1-K5 must launch), held to
    ``ref_gmsh_lshape.npz``. (C) the five-constraint model at L=3 (phase I
    over the five-piece cobarrier) and the three-field model (one nz = 7
    cone: K6's runtime-width instance, not K2), held to
    ``ref_model_five_L3.npz``. After each Model's solve, K6 is held on the
    table its lowering gave it (``model_table_phases``). Returns the
    runtime-width cone's kernel record: the three-field table's error and
    mode 2 time, and the three-field solve's K6 launches with a wide
    piece."""
    from mgbtpu_torch import (amg, assemble, fem2d_P2, gmsh_import,
                              mgb_solve, subdivide)
    from mgbtpu_torch.solver.newton import SYNCS

    ref = dict(np.load(os.path.join(DATA, "ref_model_torsion_L5.npz")))
    need = MESH + ["node_barrier"]
    m, cons, sol, _, _, _ = model_solve("Model torsion L=5", "torsion", mg5,
                                        torch, K, smi, need, ref)
    model_table_phases("Model torsion L=5 table", m, 91, torch, K)
    duals = {}
    for key in ("eq", "cone", "lin"):
        K.reset_launches()
        duals[key] = m.dual(cons[key])
        torch.cuda.synchronize()
        print(f"[kernels] dual({key}) of Model torsion L=5: launches "
              f"{K.launches()}; node_barrier by mode "
              f"{K.node_barrier.mode_launches}")
        if key == "eq" and K.node_barrier.mode_launches[1] == 0:
            raise RuntimeError("dual(eq): no mode-1 K6 launch")
    check_duals("Model torsion L=5", duals, ref)
    html_check("Model torsion L=5", sol)

    t0 = time.time()
    out = gmsh_import(LSHAPE)
    g = out.geometry
    print(f"[setup] gmsh_import {os.path.basename(LSHAPE)}: "
          f"{time.time() - t0!r} s; {g.x.shape[1]} triangles, {g.x.shape[0]} "
          f"nodes each, regions "
          f"{ {k: len(v) for k, v in out.regions.items()} }")
    prob = timed_setup("Gmsh L-shape", lambda: assemble(amg(g), p=1.0,
                                                        device="cuda"))
    SYNCS["n"] = 0
    secs, solb, la, _ = counted(torch, K, lambda: mgb_solve(prob,
                                                            device="cuda"))
    report("Gmsh L-shape", secs, solb, SYNCS["n"])
    print(f"[kernels] launches in the Gmsh L-shape solve ({secs!r} s wall on "
          f"{smi}; {prob.M[0].depth} levels): {la}")
    require_launches("Gmsh L-shape", la, ["power_cone"] + MESH)
    check_record("Gmsh L-shape", solb,
                 dict(np.load(os.path.join(DATA, "ref_gmsh_lshape.npz"))))

    mg3 = amg(subdivide(fem2d_P2(), 3))
    five = ref_record("ref_model_five_L3.npz", "five_constraints")
    m5, _, _, _, co, _ = model_solve(
        "Model five constraints L=3", "five_constraints", mg3, torch, K,
        smi, ["panel_fwd", "panel_adj", "node_barrier"], five)
    if co == 0:
        raise RuntimeError("five constraints: no phase-I K6 launch")
    model_table_phases("Model five constraints L=3 table", m5, 92, torch, K)
    fields = ref_record("ref_model_five_L3.npz", "three_fields")
    m3, _, _, la, _, wide = model_solve(
        "Model three fields L=3", "three_fields", mg3, torch, K, smi,
        ["panel_fwd", "panel_adj", "node_barrier"], fields)
    if wide == 0 or la["power_cone"] != 0:
        raise RuntimeError("three fields: the nz=7 cone did not run in "
                           "K6's runtime-width instance")
    err, rows = model_table_phases("Model three fields L=3 table", m3, 93,
                                   torch, K)
    return dict(name="node_barrier (runtime-width cone nz=7, three-field "
                "model L=3)", source="mgbtpu_torch/kernels/csrc/node_barrier.cu",
                replaces="mgbtpu/ops/pallas_dd.py:258", max_abs_err=err,
                launches=wide, **rows["mode 2"])


TABLE_M = 4096      # seeded nodes at which the table kernels are timed


def table_kernel_tables(m, rng):
    """The tables past K6's parameter kernels that the wide models lower
    to, made up at m seeded nodes: 17 pieces (a p = 1 cone on rows 1, 2 and
    16 bounds on row 0) over 3 rows, a cone of nz = 17 over 33 rows (a full
    A) and one of nz = 33 over 65 rows; as (name, Convex, D rows, phase-I
    component rows)."""
    import mgbtpu_torch as mt

    x = np.zeros((m, 2))
    cone, lin = mt.convex_euclidian_power, mt.convex_linear
    bounds = [lin(x=x, idx=(0,), A=lambda _: np.array([[-1.0]]),
                  b=lambda _, c=c: np.array([2.0 + c])) for c in range(16)]
    A17 = np.tile(np.eye(17).reshape(1, -1), (m, 1)) \
        + 0.01 * rng.standard_normal((m, 289))
    return [("17 pieces", mt.intersect(x, cone(x=x, idx=(1, 2), p=1.0),
                                       *bounds), 3, 2),
            ("cone nz=17", cone(x=x, idx=tuple(range(1, 32, 2)) + (32,),
                                A_grid=A17, p=2.0), 33, 17),
            ("cone nz=33", cone(x=x, idx=tuple(range(1, 64, 2)) + (64,),
                                p=2.0), 65, 33)]


def check_floor_record(tag, sol, ref, floor_from=3):
    """A fem1d solve on 8 nodes against its x64 record: z within TOL_Z,
    the same accepted and attempted steps, the same Newton its on the
    steps before ``floor_from``; from it on the decrement sits at the
    objective's roundoff floor (ROADMAP Queue 3, fem1d): each step within
    +-1, the last (the exact-stopping polish) within FLOOR_ITS."""
    z = ref["z"]
    zerr = float(np.linalg.norm(sol.z - z) / np.linalg.norm(z))
    S = sol.SOL_main
    its, its_ref = S["its"].sum(axis=0), ref["its"].sum(axis=0)
    steps = [S["steps_accepted"], S["steps_attempted"]]
    print(f"[reference] {tag}: |z - z_ref|/|z_ref| = {zerr!r}; its per "
          f"ramp step {its.tolist()} vs {its_ref.tolist()} (x64); steps "
          f"{steps} vs {ref['steps'].tolist()}")
    fails = []
    if not zerr <= TOL_Z:
        fails.append(f"solution error {zerr}")
    if steps != ref["steps"].tolist() or len(its) != len(its_ref):
        fails.append("steps")
    elif np.any(its[:floor_from] != its_ref[:floor_from]) \
            or np.abs(its - its_ref)[floor_from:-1].max(initial=0) > 1 \
            or abs(int(its[-1]) - int(its_ref[-1])) > FLOOR_ITS:
        fails.append("Newton its")
    if fails:
        raise RuntimeError(f"{tag}: " + "; ".join(fails))


def table_kernel_phases(torch, K, smi):
    """K6's table kernels: the three fem1d models past the parameter
    kernels (``port_models.WIDE_MODELS``: 17 constraints, 16 and 32 fields)
    through ``Model(mg)`` on the card, each held to its x64 record
    (``ref_model_wide.npz``) with the table kernels launched, and K6 on
    the table its lowering gave it (bitwise in the six calls); then the
    made-up tables of ``table_kernel_tables`` at TABLE_M nodes, bitwise in
    every mode and form, each Hessian timed beside its bound and the
    library's A' Hz A. Returns the kernel record of the nz = 33 cone (a
    node on 128 lanes, its Hessian's rows built in shared memory), with the
    32-field solve's table launches."""
    import mgbtpu_torch
    import port_models
    from mgbtpu_torch.kernels.node_barrier import last_in_global

    mg = mgbtpu_torch.amg(mgbtpu_torch.fem1d(
        nodes=np.linspace(-1.0, 1.0, 5)))
    launches = {}
    for k, name in enumerate(port_models.WIDE_MODELS):
        m, _ = port_models.MODELS[name](mgbtpu_torch, mg)
        secs, sol, la, co = counted(torch, K,
                                    lambda: m.solve(**port_models.SOLVE))
        launches[name] = K.node_barrier.table_launches
        report(f"Model {name}", secs, sol, "n/a")
        print(f"[kernels] launches in the Model {name} solve ({secs!r} s "
              f"wall on {smi}): {la}; node_barrier in its table kernels "
              f"{launches[name]}, by mode 0/1/2 "
              f"{K.node_barrier.mode_launches}, in cobarrier form {co}")
        if launches[name] == 0:
            raise RuntimeError(f"Model {name}: no table-kernel launch")
        check_floor_record(f"Model {name}", sol,
                           ref_record("ref_model_wide.npz", name))
        model_table_phases(f"Model {name} table", m, 94 + k, torch, K)
    rng = np.random.default_rng(4096)
    w = np.full(TABLE_M, 1.0 / TABLE_M)
    dev = torch.device("cuda")
    for name, Q, nD, nu in table_kernel_tables(TABLE_M, rng):
        Dz = torch.as_tensor(_wide_rows(TABLE_M, Q, nD, rng),
                             dtype=torch.float64, device=dev)
        calls = k6_calls(Q, Dz, nu, w, torch, K, rng)
        err = k6_check(f"{name} m={TABLE_M}", calls, K)
        rows = {label: k6_time(f"{name} m={TABLE_M} {label}", calls[label],
                               K)
                for label in ("mode 2", "co mode 2")}
        print(f"[instance] {name} co mode 2 (the last call): rows built "
              f"in {'global' if last_in_global() else 'shared'} memory")
    return dict(name="node_barrier (table kernel: cone nz=33 over 65 rows)",
                source="mgbtpu_torch/kernels/csrc/node_barrier.cu",
                replaces="mgbtpu/ops/pallas_dd.py:258", max_abs_err=err,
                launches=launches["thirty_two_fields"], **rows["mode 2"])


MESH_SHARDS = 4     # the mesh phase's shards, all on cuda:0


class _Module:
    """A module's stand-in with some attributes replaced."""

    def __init__(self, module, **replaced):
        self._module = module
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._module, name)


class ShardSpy:
    """Which shard each launch of K1-K6 ran on, during a mesh solve: the
    wrappers the package calls are wrapped (each still counts its own
    launches, as always) and each call is attributed to a shard after the
    solve, by the tensors it was given: K1, K3 and K4 by the shard's panels,
    K5a and K5b by the ND plan part's adofs, K2 and K6 by the rows of the
    node grids they read (a shard's bw is a slice of the level's). A call
    on a whole level (one that does not divide, K3's phase B on the first
    device, an ND level above the split) counts as "whole"."""

    def __init__(self, n_nodes):
        self.n_nodes = n_nodes
        self.calls = []

    def __enter__(self):
        import mgbtpu_torch.convex.convex as CV
        import mgbtpu_torch.kernels as KK
        import mgbtpu_torch.ops.ndchol as ND

        calls = self.calls

        def spy(mod, attr, name, key):
            real = getattr(mod, attr)

            def fn(*a, **k):
                calls.append((name, key(*a)))
                return real(*a, **k)

            if key is None:     # K2: a stand-in module around the wrapper
                fn = _Module(real, power_cone_eval=lambda *a, **k: spy_k2(
                    real.power_cone_eval, a, k))
            self.saved.append((mod, attr, real))
            setattr(mod, attr, fn)

        def spy_k2(real, a, k):
            calls.append(("power_cone", ("rows", _rows(a[6]))))
            return real(*a, **k)

        self.saved = []
        for attr, name in (("panel_fwd", "panel_fwd"),
                           ("panel_adj", "panel_adj"),
                           ("panel_adj_contrib", "panel_adj"),
                           ("gram_matvec", "gram_matvec"),
                           ("gram_matvec_contrib", "gram_matvec"),
                           ("adjoint_sum", "panel_adj")):
            spy(KK, attr, name, lambda first, *a: ("ptr",
                                                   first.data_ptr()))
        spy(ND, "front_forward", "front_solve",
            lambda Lf, U, adofs, *a: ("ptr", adofs.data_ptr()))
        spy(ND, "front_backward", "front_solve",
            lambda Lf, U, adofs, *a: ("ptr", adofs.data_ptr()))
        spy(ND, "_factor_level", "front_factor",
            lambda F, L, *a: ("ptr", L.adofs.data_ptr()))
        spy(CV, "node_barrier", "node_barrier",
            lambda mode, Dz, pc, args, sel, bw, *a: ("rows", _rows(bw)))
        # K2's wrapper counts through its module's global name, so the
        # spy goes into the module the Convex reads it from, a stand-in
        spy(CV, "K2", "power_cone", None)
        return self

    def __exit__(self, *exc):
        for mod, attr, real in self.saved:
            setattr(mod, attr, real)

    def per_shard(self, kerns, mesh):
        """{kernel: [launches on shard 0..n-1, whole-level launches]}"""
        n = mesh.size
        distinct = len(set(mesh.devices)) == n
        owner = {}
        for kern in kerns:
            # every level built: the solve levels and the V-cycle's
            for ops in kern._plain.values():
                for d, o in enumerate(getattr(ops, "shards", ())):
                    owner[o.panels.data_ptr()] = d
                nd = ops.nd
                for parts in (nd.parts if nd is not None else ()):
                    for d, P in enumerate(parts):
                        owner[P.adofs.data_ptr()] = d
        out = {}
        for name, (kind, v) in self.calls:
            if kind == "ptr":
                d = owner.get(v, n)
            elif v[2] == self.n_nodes:     # (device, offset, rows)
                d = n
            else:
                d = mesh.devices.index(v[0]) if distinct else v[1] // v[2]
            out.setdefault(name, [0] * (n + 1))[d] += 1
        return out


def _rows(bw):
    """Where a K2/K6 call's node rows lie: (device, offset in the
    level's rows, rows)."""
    return bw.device, bw.storage_offset(), bw.shape[0]


def mesh_kernels(M, mesh):
    """The ProblemKernels of M's solves under ``mesh`` (the main and the
    phase-I ones)."""
    return [k for k in getattr(M, "_torch_kernel_cache", {}).values()
            if k.mesh is mesh]


def mesh_solve(tag, prob, mesh, torch, K, smi, need, systems):
    """One ``mgb_solve(prob, mesh=mesh)`` with the launch counters set to 0
    just before and read just after, and each launch attributed to a shard
    (``ShardSpy``); requires every kernel of ``need`` on every shard.
    Returns (seconds, solution, launches, per-shard launches, syncs)."""
    from mgbtpu_torch import mgb_solve
    from mgbtpu_torch.solver.newton import SYNCS

    SYNCS["n"] = 0
    with ShardSpy(prob.M[0].n_nodes) as spy:
        secs, sol, la, co = counted(torch, K,
                                    lambda: mgb_solve(prob, mesh=mesh))
    syncs = SYNCS["n"]
    kerns = [k for M in systems for k in mesh_kernels(M, mesh)]
    per = spy.per_shard(kerns, mesh)
    report(tag, secs, sol, syncs)
    print(f"[mesh] {tag}: {secs!r} s wall on {smi}; launches {la}, K6 in "
          f"cobarrier form {co}; per shard (0..{mesh.size - 1}, then whole "
          f"levels): {per}")
    missing = [f"{n} on shard {d}" for n in need
               for d in range(mesh.size)
               if per.get(n, [0] * (mesh.size + 1))[d] == 0]
    if missing:
        raise RuntimeError(f"{tag}: not launched: {missing}")
    return secs, sol, la, per, syncs, co


def mesh_phases(mg5, prob, sol0, wall0, torch, K, smi):
    """fem2d_P2 p=1 L=5 with ``mesh=make_mesh(devices=[cuda:0] * 4)``: held
    to the unsharded solve of this process (max abs 5e-12) and to the x64
    record, K1-K5 on every shard; its Gram matvec's transfers, its ND
    factor's bytes per device against ``nd_memory_report``, its host syncs
    and wall beside the unsharded wall. Then zoo.two_sided_obstacle L=5 and
    zoo.p_harmonic L=3 from s = 0 under the same mesh (K6 on every shard,
    in the cobarrier form in phase I), each against its x64 record; the
    L=5 solve over distinct cards where there are two or more."""
    import mgbtpu_torch as mt
    from mgbtpu_torch import zoo
    from mgbtpu_torch.ops.ndchol import nd_factor, nd_memory_report
    from mgbtpu_torch.parallel.sharding import TRANSFERS, reset_transfers

    cuda0 = torch.device("cuda", 0)
    mesh = mt.make_mesh(devices=[cuda0] * MESH_SHARDS)
    tag = f"fem2d_P2 p=1 L=5 mesh of {MESH_SHARDS} shards on cuda:0"
    reset_transfers()
    secs, sol, la, per, syncs, _ = mesh_solve(tag, prob, mesh, torch, K,
                                              smi, MESH, prob.M)
    gap = float(np.abs(sol.z - sol0.z).max())
    same = bool(np.array_equal(sol.z, sol0.z))
    print(f"[mesh] {tag}: max |z - z_unsharded| = {gap!r} (bitwise equal: "
          f"{same}); wall {secs!r} s against the unsharded {wall0!r} s; "
          f"host syncs {syncs}; transfers in the solve {dict(TRANSFERS)}")
    if not gap <= 5e-12:
        raise RuntimeError(f"{tag}: differs from the unsharded solve: {gap}")
    check_totals(tag, sol, np.load(REF))

    (kern,) = [k for k in mesh_kernels(prob.M[0], mesh)]
    ops = kern.ops(prob.M[0].depth - 1)
    eye = torch.eye(ops.nD, dtype=torch.float64, device=cuda0)
    Ln = ops.split(eye.expand(ops.n_nodes, ops.nD, ops.nD).contiguous())
    v = torch.ones(ops.n_J, dtype=torch.float64, device=cuda0)
    reset_transfers()
    ops.gram_apply(Ln, v)
    torch.cuda.synchronize()
    print(f"[mesh] one Gram matvec at L=5's top level (n_J = {ops.n_J}): "
          f"transfers {dict(TRANSFERS)}")
    nv, ns = 8 * ops.n_J, 8 * ops.N // MESH_SHARDS * ops.C
    if TRANSFERS != dict(gathers=MESH_SHARDS, broadcasts=1,
                         bytes=nv + MESH_SHARDS * ns, largest=max(nv, ns)):
        raise RuntimeError("Gram matvec transfers differ from one broadcast "
                           "and each shard's per-slot contributions")
    nd = ops.nd
    fact = nd_factor(nd, ops.gram_blocks(Ln), 1.0)
    rep = nd_memory_report(nd)
    got = [0] * MESH_SHARDS
    for li, lvl in enumerate(fact):
        if li < len(nd.parts):
            for d, (Lf, U) in enumerate(lvl):
                got[d] += Lf.nbytes + U.nbytes
        else:
            got[0] += lvl[0].nbytes + lvl[1].nbytes
    print(f"[mesh] ND factor bytes per device {got} (nd_memory_report "
          f"{rep['device_factor_bytes']}), of {rep['factor_bytes']} in all; "
          f"{len(nd.parts)} of {len(nd.levels)} tree levels split "
          f"({[L.nk for L in nd.levels]} fronts)")
    if got != rep["device_factor_bytes"]:
        raise RuntimeError("ND factor bytes differ from nd_memory_report")
    del fact

    prob_o = zoo.two_sided_obstacle(mg5, device="cuda")
    _, sol_o, _, _, _, _ = mesh_solve(
        f"zoo.two_sided_obstacle L=5 mesh of {MESH_SHARDS}", prob_o, mesh,
        torch, K, smi, MESH + ["node_barrier"], prob_o.M)
    check_record("two_sided_obstacle L=5 mesh", sol_o,
                 ref_record("ref_obstacle_L5.npz", "two_sided_obstacle"))
    behaviour("two_sided_obstacle", mg5, sol_o.z)
    mg3 = mt.amg(mt.subdivide(mt.fem2d_P2(), 3))
    prob_p = zoo.p_harmonic(mg3, s_init=0.0, device="cuda")
    _, sol_p, _, _, _, co = mesh_solve(
        f"zoo.p_harmonic L=3 from s=0 mesh of {MESH_SHARDS}", prob_p, mesh,
        torch, K, smi, ["panel_fwd", "panel_adj", "node_barrier"], prob_p.M)
    if co == 0:
        raise RuntimeError("p_harmonic L=3 mesh: no phase-I K6 launch")
    check_record("p_harmonic L=3 from s=0 mesh", sol_p,
                 ref_record("ref_phase1_L3.npz", "p_harmonic"))

    if torch.cuda.device_count() >= 2:
        cards = mt.make_mesh()
        tag = f"fem2d_P2 p=1 L=5 mesh of {cards.size} cards"
        _, solc, _, _, _, _ = mesh_solve(tag, prob, cards, torch, K, smi,
                                         MESH, prob.M)
        gap = float(np.abs(solc.z - sol0.z).max())
        print(f"[mesh] {tag}: max |z - z_unsharded| = {gap!r}")
        if not gap <= 5e-12:
            raise RuntimeError(f"{tag}: differs from the unsharded solve")
        check_totals(tag, solc, np.load(REF))
    else:
        print(f"[mesh] the L=5 solve over distinct cards was not run: "
              f"{torch.cuda.device_count()} card")


PRECOND = ("vcycle", "fsai", "fsai2", "fsai2a")   # MGBTPU_BIG_PRE choices
PERTURBED = ("plain_dots", "ulp_f", "ulp_g")     # the records' own reruns
PCG_CAP = 150                                    # pcg_solve's CG budget


class big_pre:
    """``newton.BIG_PRE`` and ProblemKernels' level knobs set for a block
    (as a user's MGBTPU_BIG_PRE, MGBTPU_DENSE_MAX, MGBTPU_DENSE_BASE)."""

    def __init__(self, choice, **knobs):
        self.choice, self.knobs = choice, knobs

    def __enter__(self):
        from mgbtpu_torch.solver import mgb as MT, newton as NT

        self.old = (NT.BIG_PRE, {k: getattr(MT.ProblemKernels, k)
                                 for k in self.knobs})
        NT.BIG_PRE = self.choice
        for k, v in self.knobs.items():
            setattr(MT.ProblemKernels, k, v)

    def __exit__(self, *exc):
        from mgbtpu_torch.solver import mgb as MT, newton as NT

        NT.BIG_PRE = self.old[0]
        for k, v in self.old[1].items():
            setattr(MT.ProblemKernels, k, v)


def precond_bars(ref, tol_z):
    """(z bar, bar on the main ramp's steps but the last, bar on the last,
    whether the steps are held equal): ``tol_z``, 5 % and FLOOR_ITS, or
    twice the largest move of the record's own perturbed JAX runs (a
    last-bit change that leaves the method as it is) where that is larger;
    the accepted/attempted steps equal unless those runs change them.
    Many of these CG solves stop at their cap, where a last-bit difference
    steers the ramp."""
    z, its = ref["z"], ref["its"].sum(axis=0)
    body, last = int(its[:-1].sum()), int(its[-1])
    dz = db = dl = 0
    for n in PERTURBED:
        its_n = ref[f"{n}/its"].sum(axis=0)
        dz = max(dz, np.linalg.norm(ref[f"{n}/z"] - z) / np.linalg.norm(z))
        db = max(db, abs(int(its_n[:-1].sum()) - body))
        dl = max(dl, abs(int(its_n[-1]) - last))
    steady = all(np.array_equal(ref[f"{n}/steps"], ref["steps"])
                 for n in PERTURBED)
    return (max(tol_z, 2 * dz), max(TOL_ITS * body, 2 * db),
            max(FLOOR_ITS, 2 * dl), steady)


def check_precond_record(tag, sol, ref):
    """A solve under a large-level preconditioner against its x64 record
    (``precond_bars``, z at the card's TOL_Z): the same steps, z, the
    Newton its; the CG totals printed beside the record's."""
    S = sol.SOL_main
    its, its_ref = S["its"].sum(axis=0), ref["its"].sum(axis=0)
    zerr = float(np.linalg.norm(sol.z - ref["z"]) / np.linalg.norm(ref["z"]))
    bz, bb, bl, steady = precond_bars(ref, TOL_Z)
    steps = [S["steps_accepted"], S["steps_attempted"]]
    print(f"[reference] {tag}: |z - z_ref|/|z_ref| = {zerr!r} (bar "
          f"{float(bz)!r}); main its {int(its[:-1].sum())} + {int(its[-1])} "
          f"(final step) vs {int(its_ref[:-1].sum())} + {int(its_ref[-1])} "
          f"(x64; bars {float(bb)!r}, {float(bl)!r}); cg {int(S['cg'].sum())} vs "
          f"{int(ref['cg'].sum())} (x64); steps {steps} vs "
          f"{ref['steps'].tolist()}" + ("" if steady else " (not held: the "
                                         "record's own reruns change them)"))
    fails = []
    if steady and steps != ref["steps"].tolist():
        fails.append("steps")
    if not zerr <= bz:
        fails.append(f"solution error {zerr}")
    if abs(int(its[:-1].sum()) - int(its_ref[:-1].sum())) > bb:
        fails.append("its before the final step")
    if abs(int(its[-1]) - int(its_ref[-1])) > bl:
        fails.append("final-step its")
    if fails:
        raise RuntimeError(f"{tag}: " + "; ".join(fails))


def precond_state(choice, state, prob, torch, K, mesh=None):
    """One ``make_pcg_pre`` + ``pcg_solve`` on the card at the top level of
    ``prob`` (fem2d_P2 L=5, default knobs) under ``choice``, at the record's
    ``state``, over ``mesh`` where given. At p=2, t=100 held to
    ``ref_pcg_L5_<choice>.npz`` (x within 1e-8 relative, the CG count
    within +-1, lambda_max within 1e-12); at the deep state x and the CG
    count are printed beside the record's and a converged solve is held to
    its own exit test. The transfers between shards (``TRANSFERS``) are
    printed for the preconditioner's setup and for the solve. Returns the
    launches, the context, the Hessian, the preconditioner, the level's
    ops, x and the CG count."""
    import mgbtpu_torch
    from mgbtpu_torch.parallel.sharding import TRANSFERS, reset_transfers
    from mgbtpu_torch.solver import mgb as MT, newton as NT
    from mgbtpu_torch.solver.newton import SYNCS

    tag = f"{choice} L=5 {state}" + (
        "" if mesh is None else f" mesh of {mesh.size} shards on cuda:0")
    ref = np.load(os.path.join(DATA, f"ref_pcg_L5_{choice}.npz"))
    mgbtpu_torch.mgb_cleanup(prob)
    M1 = prob.M[0]
    kern = MT._kernels_for(M1, prob.Q, None, NT.linesearch_backtracking(),
                           torch.device("cuda", 0), mesh)
    l = M1.depth - 1
    t0 = time.time()
    ops = kern.ops(l)
    setup = time.time() - t0
    ctx = ops.pcg_ctx
    if ctx is None or ctx.nd is not None:
        raise RuntimeError(f"{tag}: the level has no {choice} context")
    w = M1.w
    t = float(ref[f"{state}/t"])
    z = (np.asarray(prob.g_grid).T.reshape(-1) if state == "p2" else
         np.load(REF)["z"].T.reshape(-1))
    fa = kern._fargs(l, z, w[:, None] * (t * prob.f_grid),
                     MT.barrier_weights(w, None),
                     tuple(kern.tensor(a) for a in prob.Q.args))
    s0 = torch.zeros((ops.n_J,), dtype=torch.float64, device="cuda")
    SYNCS["n"] = 0
    K.reset_launches()
    H, g = kern.fns[2](s0, *fa), kern.fns[1](s0, *fa)
    torch.cuda.synchronize()
    reset_transfers()
    t0 = time.time()
    pre = NT.make_pcg_pre(H)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    tr_pre = dict(TRANSFERS)
    la_pre = K.launches()["gram_matvec"]    # (a mesh's ShardSpy wraps K4)
    reset_transfers()
    x, k = NT.pcg_solve(H, g, pre=pre)
    torch.cuda.synchronize()
    t_solve = time.time() - t0 - t_pre
    tr_solve = dict(TRANSFERS)
    la = K.launches()
    k_ref = int(ref[f"{state}/cg"])
    xr = torch.as_tensor(ref[f"{state}/x"], device="cuda")
    d = x - xr
    err2 = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(xr))
    errH = float((torch.dot(d, ops.gram_apply(H.Lnode, d))
                  / torch.dot(xr, ops.gram_apply(H.Lnode, xr))).sqrt())
    levels = [o.n_J for o in ctx.coarse_ops]
    lmax = pre[1][1][ctx.n_levels][1] if pre[0] == "vcycle" else None
    print(f"[precond] {tag}: n_J {ops.n_J}, chosen levels {levels} "
          f"(dense base {levels[ctx.dense_level]}), lambda_max {lmax!r} "
          f"(x64 {float(ref[f'{state}/lambda_max']) if lmax else None!r}); "
          f"cg {k} (x64 {k_ref}); |x - x_ref|/|x_ref| {err2!r}, in the "
          f"H-norm {errH!r}; wall: level setup {setup!r} s, preconditioner "
          f"{t_pre!r} s, pcg_solve {t_solve!r} s; K4 launches "
          f"{la['gram_matvec']} ({la_pre} in the preconditioner); "
          f"launches {la}; host syncs {SYNCS['n']}")
    if mesh is not None:
        print(f"[mesh] {tag}: transfers in make_pcg_pre {tr_pre}; in "
              f"pcg_solve {tr_solve}, per CG iteration "
              f"{ {n: v / max(k, 1) for n, v in tr_solve.items()} }")
    if levels != ref[f"{state}/levels"].tolist():
        raise RuntimeError(f"{tag}: chosen levels {levels}")
    if state == "p2":
        if abs(k - k_ref) > 1:
            raise RuntimeError(f"{tag}: cg {k} vs {k_ref}")
        if lmax is not None and abs(
                lmax - float(ref[f"{state}/lambda_max"])) > 1e-12 * lmax:
            raise RuntimeError(f"{tag}: lambda_max {lmax}")
        if not err2 <= 1e-8:
            raise RuntimeError(f"{tag}: x differs by {err2}")
    if state == "deep" and k < PCG_CAP:
        # pcg_solve's own exit test, checked afresh: at t = 1/tol the
        # Hessian carries Dz's last bits through slacks of ~1/t (K1's sums
        # and the batched node Cholesky differ from the CPU's in their last
        # bits), so x and the CG count are reported beside the record's,
        # and the solve is held to its tolerance
        from mgbtpu_torch.solver.newton import PCG_RTOL, pcg_operators

        _, mv_s, dt = pcg_operators(H, pre)
        res = float(torch.linalg.vector_norm(mv_s(x * dt) - g / dt)
                    / torch.linalg.vector_norm(g / dt))
        print(f"[precond] {tag}: equilibrated residual {res!r}")
        if not res <= 2 * PCG_RTOL:
            raise RuntimeError(f"{tag}: residual {res}")
    require_launches(tag, la, ["panel_fwd", "power_cone", "panel_adj",
                               "gram_matvec"])
    return la, ctx, H, pre, ops, x, k


def mesh_pcg_phases(prob, xs, torch, K, smi):
    """Each choice's ``make_pcg_pre`` + ``pcg_solve`` at fem2d_P2 L=5's top
    level at p=2, t=100 (``precond_state``, held to the record as there)
    over ``make_mesh(devices=[cuda:0] * 4)``: x and the CG count bitwise
    equal to the unsharded call's of this process (``xs``), K1-K4 on every
    shard (``ShardSpy``), the transfers per CG iteration printed."""
    import mgbtpu_torch as mt

    mesh = mt.make_mesh(devices=[torch.device("cuda", 0)] * MESH_SHARDS)
    for choice in PRECOND:
        tag = f"{choice} L=5 p2 mesh of {MESH_SHARDS} shards on cuda:0"
        with big_pre(choice), ShardSpy(prob.M[0].n_nodes) as spy:
            out = precond_state(choice, "p2", prob, torch, K, mesh=mesh)
        la, ctx, _, _, ops, x, k = out
        per = spy.per_shard(mesh_kernels(prob.M[0], mesh), mesh)
        x1, k1 = xs[choice]
        same = bool(torch.equal(x, x1)) and k == k1
        print(f"[mesh] {tag}: {type(ops).__name__} levels "
              f"{[type(o).__name__ for o in ctx.coarse_ops]}; launches per "
              f"shard (0..{MESH_SHARDS - 1}, then whole levels) {per}; x "
              f"and cg {k} bitwise equal to the unsharded call's: {same}")
        if not same:
            raise RuntimeError(f"{tag}: differs from the unsharded call "
                               f"(cg {k} vs {k1})")
        missing = [f"{n} on shard {d}" for n in
                   ("panel_fwd", "power_cone", "panel_adj", "gram_matvec")
                   for d in range(MESH_SHARDS)
                   if per.get(n, [0] * (MESH_SHARDS + 1))[d] == 0]
        if missing:
            raise RuntimeError(f"{tag}: not launched: {missing}")
        mt.mgb_cleanup(prob)


def mesh_ramp_phase(mg, L, unsharded, torch, K, smi):
    """``assemble`` -> ``mgb_solve`` of fem2d_P2 p=1 on ``mg`` (level L)
    under the V-cycle (DENSE_MAX=50, DENSE_BASE=40) over
    ``make_mesh(devices=[cuda:0] * 4)``: bitwise equal to the same ramp
    unsharded (``unsharded``, (seconds, solution) of this process, or run
    here when None), K1-K4 on every shard, the transfers and the walls
    printed; at L=3 also held to the record."""
    import mgbtpu_torch as mt
    from mgbtpu_torch import assemble, mgb_solve
    from mgbtpu_torch.parallel.sharding import TRANSFERS, reset_transfers
    from mgbtpu_torch.solver.newton import SYNCS

    mesh = mt.make_mesh(devices=[torch.device("cuda", 0)] * MESH_SHARDS)
    tag = (f"vcycle fem2d_P2 p=1 L={L} (DENSE_MAX=50, DENSE_BASE=40) mesh "
           f"of {MESH_SHARDS} shards on cuda:0")
    with big_pre("vcycle", DENSE_MAX=50, DENSE_BASE=40):
        if unsharded is None:
            prob = assemble(mg, p=1.0, device="cuda")
            SYNCS["n"] = 0
            secs, sol, _, _ = counted(torch, K, lambda: mgb_solve(
                prob, device="cuda"))
            report(f"vcycle L={L} unsharded", secs, sol, SYNCS["n"])
            unsharded = (secs, sol)
        prob = assemble(mg, p=1.0, device="cuda")
        reset_transfers()
        secs, sol, la, per, syncs, _ = mesh_solve(
            tag, prob, mesh, torch, K, smi,
            ["panel_fwd", "power_cone", "panel_adj", "gram_matvec"], prob.M)
    top = mesh_kernels(prob.M[0], mesh)[0].ops(prob.M[0].depth - 1)
    s1, sol1 = unsharded
    same = bool(np.array_equal(sol.z, sol1.z))
    cg = int(sol.SOL_main["cg"].sum())
    print(f"[mesh] {tag}: bitwise equal to the unsharded ramp: {same}; wall "
          f"{secs!r} s against the unsharded {s1!r} s; chosen levels "
          f"{[(type(o).__name__, o.n_J) for o in top.pcg_ctx.coarse_ops]}; "
          f"transfers {dict(TRANSFERS)}, per CG iteration "
          f"{ {n: v / max(cg, 1) for n, v in TRANSFERS.items()} }")
    if not same:
        raise RuntimeError(f"{tag}: differs from the unsharded ramp")
    if la["front_factor"] or la["front_solve"]:
        raise RuntimeError(f"{tag}: the ND solver ran")
    if L == 3:
        check_precond_record(tag, sol, np.load(os.path.join(
            DATA, "ref_fem2d_p2_L3_vcycle.npz")))


def precond_times(H, pre, ops, torch, tag):
    """Device ms of one application of the preconditioner M_s (the
    V-cycle's cycle, or FSAI's G'(G r) with fsai2's coarse correction:
    library calls, and K4 on the V-cycle's levels) and of one equilibrated
    Hessian apply (K4 at the top level): a CG iteration's two big parts."""
    from mgbtpu_torch.solver.newton import pcg_operators

    M_s, mv_s, _ = pcg_operators(H, pre)
    r = torch.randn(ops.n_J, dtype=torch.float64, device="cuda")
    ms, hid = device_ms(lambda: M_s(r), reps=20)
    k4, hid4 = device_ms(lambda: mv_s(r))
    print(f"[time] {tag}: device ms per CG iteration: the preconditioner "
          f"({pre[0]}) {ms!r}{'' if hid else ' (host not hidden: an upper bound)'}"
          f", the Hessian apply (K4 at n_J {ops.n_J}) {k4!r}"
          f"{'' if hid4 else ' (host not hidden)'}; wall ms per call (host "
          f"launch rate) {wall_ms(lambda: M_s(r), reps=20)!r}")
    return ms, k4


def precond_phases(torch, K, smi, full=False):
    """The large-level preconditioners (``MGBTPU_BIG_PRE``): (a) each
    choice's ``make_pcg_pre`` + ``pcg_solve`` at the top level of fem2d_P2
    L=5 (n_J = 5,057) with the default knobs, at p=2, t=100 and at the p=1
    ramp's last t, held to ``ref_pcg_L5_<choice>.npz``; then K4 at the
    V-cycle's levels against its plain version and timed; (a)'s p=2 solves
    over a mesh (``mesh_pcg_phases``); (b) each choice's ``assemble`` ->
    ``mgb_solve`` of fem2d_P2 p=1 at L=3 with DENSE_MAX=50 and
    DENSE_BASE=40, held to ``ref_fem2d_p2_L3_<choice>.npz``
    (``precond_bars``); the V-cycle ramp at L=2 over a mesh
    (``mesh_ramp_phase``); with ``full``, the L=3 one over a mesh, and the
    V-cycle ramp at L=4 with the default knobs against
    ``ref_fem2d_p2_L4_vcycle.npz``. Returns the kernel record of K4 at the
    V-cycle's levels."""
    from mgbtpu_torch import amg, assemble, fem2d_P2, mgb_solve, subdivide
    from mgbtpu_torch.solver.newton import SYNCS

    mg5 = amg(subdivide(fem2d_P2(), 5))
    probs = {"p2": assemble(mg5, p=2.0, device="cuda"),
             "deep": assemble(mg5, p=1.0, device="cuda")}
    launches = rows = None
    xs = {}
    for choice in PRECOND:
        with big_pre(choice):
            for state in ("p2", "deep"):
                la, ctx, H, pre, ops, x, k = precond_state(
                    choice, state, probs[state], torch, K)
                if state == "p2":
                    xs[choice] = (x, k)
                    precond_times(H, pre, ops, torch, f"{choice} L=5 p2")
                if choice == "vcycle" and state == "deep":
                    launches = la
                    rng = np.random.default_rng(1905)
                    # the top level and the chosen coarse levels (with the
                    # default knobs at L=5 only the dense base)
                    levels = [ops] + list(ctx.coarse_ops)
                    rows = [gram_matvec_phase(o, torch, K, rng,
                                              f"vcycle L=5 n_J={o.n_J}")
                            for o in levels]
    err, row = rows[0]
    record = dict(name="gram_matvec vcycle", route="cuda",
                  source="mgbtpu_torch/kernels/csrc/gram_matvec.cu",
                  replaces="mgbtpu/ops/pallas_dd.py:142",
                  launches=launches["gram_matvec"],
                  max_abs_err=max(e for e, _ in rows), **row)

    mesh_pcg_phases(probs["p2"], xs, torch, K, smi)
    del probs

    mg3 = amg(subdivide(fem2d_P2(), 3))
    for choice in PRECOND:
        tag = f"{choice} fem2d_P2 p=1 L=3 (DENSE_MAX=50, DENSE_BASE=40)"
        with big_pre(choice, DENSE_MAX=50, DENSE_BASE=40):
            prob = assemble(mg3, p=1.0, device="cuda")
            SYNCS["n"] = 0
            secs, sol, la, _ = counted(torch, K,
                                       lambda: mgb_solve(prob,
                                                         device="cuda"))
        if choice == "vcycle":
            vcycle3 = (secs, sol)
        report(tag, secs, sol, SYNCS["n"])
        print(f"[kernels] launches in the {tag} solve ({secs!r} s wall on "
              f"{smi}): {la}")
        require_launches(tag, la, ["panel_fwd", "power_cone", "panel_adj",
                                   "gram_matvec"])
        if la["front_factor"] or la["front_solve"]:
            raise RuntimeError(f"{tag}: the ND solver ran")
        check_precond_record(tag, sol, np.load(os.path.join(
            DATA, f"ref_fem2d_p2_L3_{choice}.npz")))
    # the mesh ramp at L=2 by default: at L=3 it took 40.1 s over 4 shards
    # of one H100 (18.1 s unsharded)
    mesh_ramp_phase(amg(subdivide(fem2d_P2(), 2)), 2, None, torch, K, smi)
    if full:
        mesh_ramp_phase(mg3, 3, vcycle3, torch, K, smi)
        tag = "vcycle fem2d_P2 p=1 L=4 (default knobs)"
        with big_pre("vcycle"):
            prob = assemble(amg(subdivide(fem2d_P2(), 4)), p=1.0,
                            device="cuda")
            SYNCS["n"] = 0
            secs, sol, la, _ = counted(torch, K,
                                       lambda: mgb_solve(prob,
                                                         device="cuda"))
        report(tag, secs, sol, SYNCS["n"])
        print(f"[kernels] launches in the {tag} solve ({secs!r} s wall on "
              f"{smi}): {la}")
        check_precond_record(tag, sol, np.load(os.path.join(
            DATA, "ref_fem2d_p2_L4_vcycle.npz")))
    return record


def golden_check(tag, got, gold):
    """``tests/test_golden.py``'s bar: the 2-norm of the difference from
    the golden vector below 1e-6."""
    gerr = float(np.linalg.norm(got - gold))
    print(f"[reference] {tag}: |z - z_gold| = {gerr!r} (golden vector of "
          f"tests/test_golden.py)")
    if not gerr < 1e-6:
        raise RuntimeError(f"{tag}: golden error {gerr}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", type=int, action="append", default=[],
                    help="also time K1/K2/K5/K6 at this level's shapes and "
                    "solve fem2d_P2 there once, against its x64 record")
    ap.add_argument("--fem3d-level", type=int, default=4,
                    help="the level of the fem3d k=3 solve and of the wide "
                    "kernel shapes (default 4)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one L=5 solve (torch.profiler)")
    ap.add_argument("--precond-full", action="store_true",
                    help="also run the V-cycle ramp at L=4 with the default "
                    "knobs against its x64 record (minutes), and the L=3 "
                    "V-cycle ramp over a mesh")
    args = ap.parse_args(argv)
    t_start = time.time()

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
    require_forms("fem2d_P2 p=1 L=5", K, large=False)
    k3_forms("fem2d_P2 p=1 L=5", prob, K, K.panel_adj.bulk_launches)

    check_totals("fem2d_P2 p=1 L=5", sol, np.load(REF))
    mesh_phases(mg5, prob, sol, s2, torch, K, smi)

    launches_par = slice2_solves(torch, K, smi, mg5)
    for r in records:
        r["launches"] = (launches_par if r["name"] == "node_barrier"
                         else launches)[r["name"]]

    L3d = args.fem3d_level
    prob3d = timed_setup(f"fem3d k=3 L={L3d}", lambda: fem3d_problem(L3d))
    wide = fem3d_kernel_phases(prob3d, L3d, torch, K)
    launches3d, wall3d = slice7_solves(prob3d, L3d, torch, K, smi)
    for r in wide:
        kern = r["name"].split()[0]
        r["launches"] = launches3d["panel_adj_bulk" if "bulk form" in
                                   r["name"] else kern]
    records += wide
    if args.profile:
        from mgbtpu_torch import mgb_solve
        from mgbtpu_torch.solver.newton import SYNCS

        profile(lambda: _timed_solve(prob3d, mgb_solve, torch, SYNCS),
                wall3d, f"fem3d k=3 L={L3d}")
    del prob3d
    if L3d != 5:
        errs5 = dict(zip(("front_factor", "front_solve"),
                         fem3d_l5_phases(torch, K)))
        for r in wide:
            kern = r["name"].split()[0]
            if kern in errs5:
                r["max_abs_err"] = max(r["max_abs_err"], errs5[kern])

    mg32, prob32 = timed_setup("spectral2d n=32",
                               lambda: spectral_problem("spectral2d", 32))
    spread = spectral_kernel_phases(mg32, prob32, torch, K)
    launches32 = spectral_solves(prob32, torch, K, smi)
    for r in spread:
        r["launches"] = launches32[r["name"].split()[0]]
    records += spread

    wide_node_barrier_phases(torch, K)
    records.append(slice9_solves(mg5, torch, K, smi))
    records.append(table_kernel_phases(torch, K, smi))
    records.append(precond_phases(torch, K, smi, full=args.precond_full))

    for L in args.level:
        level_run(L, torch, K, smi)
    if args.profile:
        profile(run, s2)
    print(f"[time] chip_smoke: {time.time() - t_start!r} s in all")

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in ({"route": "cuda", **r} for r in records)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def level_run(L, torch, K, smi):
    """``--level L``: the kernels at level L's shapes (``level_phases``),
    then one fem2d_P2 p=1 solve at L with its launches (K1-K5 must launch),
    held to ``ref_fem2d_p2_L<L>.npz`` where there is one
    (``check_totals``)."""
    t_level = time.time()
    mgL, probL, run_L = solve(L, torch)
    level_phases(mgL, probL, L, torch, K)
    _, (sL, solL, syL), la, _ = counted(torch, K, run_L)
    report(f"L={L}", sL, solL, syL)
    print(f"[kernels] launches in the L={L} solve: {la}; power_cone by "
          f"mode 0/1/2: {K.power_cone_eval.mode_launches}")
    require_launches(f"fem2d_P2 p=1 L={L}", la,
                     [n for n in la if n != "node_barrier"])
    ref = os.path.join(DATA, f"ref_fem2d_p2_L{L}.npz")
    if os.path.exists(ref):
        check_totals(f"fem2d_P2 p=1 L={L}", solL, np.load(ref))
    else:
        print(f"[reference] fem2d_P2 p=1 L={L}: no x64 record")
    print(f"[time] --level {L}: {time.time() - t_level!r} s (setup, kernel "
          f"phases and the solve) on {smi}")


def print_ptxas(secs, info):
    """K6's functions as ptxas reports them (registers, stack, spills):
    its kernels, and any callee that was not inlined."""
    print(f"[ptxas] node_barrier.cu built in {secs!r} s (nvcc, beside the "
          f"other kernels' builds)")
    for fn, r in sorted(info.items()):
        m = re.search(r"(node_barrier_(?:wide_|table_)?kernel)ILi(\d+)ELi"
                      r"(\d+)E", fn)
        label = f"{m[1]}<mode {m[2]}, form {m[3]}>" if m else fn
        print(f"[ptxas] {label}: {r.get('registers')} registers, "
              f"{r.get('stack')} bytes stack, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spill stores / loads")


def profile(run, wall, tag="L=5"):
    """One solve (``run``) under torch.profiler: the device's busy time
    against the profiled wall and against ``wall``, the unprofiled solve's;
    prints the top kernels by device time and the top host ops by CPU
    time."""
    from torch.profiler import ProfilerActivity, profile as tprof

    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        secs, _, _ = run()
    t0 = time.time()
    ka = pr.key_averages()
    busy = device_us(ka) / 1e6
    print(f"[profile] averaging the trace took {time.time() - t0!r} s")
    print(f"[profile] {tag} solve {secs!r} s wall under the profiler, device "
          f"busy {busy!r} s: {busy / secs!r} of the profiled wall, "
          f"{busy / wall!r} of the unprofiled solve's {wall!r} s")
    print(ka.table(sort_by="self_device_time_total", row_limit=40))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=25))


if __name__ == "__main__":
    sys.exit(main())

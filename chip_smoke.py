#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mgbtpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the check: L=5, kernels + solve
    python3 chip_smoke.py --level 7       # also solve fem2d_P2 L=7 once
    python3 chip_smoke.py --profile       # also profile one L=5 solve

In order: prints the card's name and power limit; builds the six CUDA
kernels from ``mgbtpu_torch/kernels/csrc`` (one nvcc per source, in
parallel); holds each kernel against its plain PyTorch version on the card
at the fem2d_P2 L=5 top-level shapes (seeded inputs; the front kernels on
every tree level of that level's nested dissection; max relative error
<= 1e-12, identical non-finite patterns) and times kernel,
plain version and, where one exists, a single PyTorch library call (device
time per call, the host hidden behind a spin kernel); solves
fem2d_P2, p=1, L=5 twice through ``assemble``/``mgb_solve`` on the card,
counting kernel launches over the second solve (every kernel must launch);
holds the solution and the Newton iterations against the stored JAX x64
reference (``mgbtpu_torch/data/ref_fem2d_p2_L5.npz``: relative 2-norm
error <= 1e-6, total iterations within 5%). Prints one JSON line of
kernel records, then ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero, before that line, on any failure or without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOPS = 34e12             # H100 SXM FP64, non-tensor (NVIDIA data sheet)
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "mgbtpu_torch", "data", "ref_fem2d_p2_L5.npz")
TOL_KERNEL = 1e-12
TOL_Z = 1e-6
TOL_ITS = 0.05


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


def timings(name, kernel, plain, library=None, plain_reps=50):
    """Device ms per call of the kernel, its plain version and the library
    call (None without one); prints the host launch rate beside them."""
    out, notes = {}, []
    for key, fn, reps in (("ms", kernel, 50), ("plain_ms", plain, plain_reps),
                          ("library_ms", library, 50)):
        if fn is None:
            out[key] = None
            continue
        out[key], hidden = device_ms(fn, reps)
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


def kernel_phases(prob, torch, K):
    """Each kernel against its plain version at the top-level shapes."""
    from mgbtpu_torch.solver.levelops import build_panel_ops
    from mgbtpu_torch.solver.mgb import barrier_weights

    dev = torch.device("cuda")
    M = prob.M[0]
    ops = build_panel_ops(M.D_fine, M.nu, M.R_fine[-1],
                          M.geometry.x.shape[0], dev)
    nD, N, p, C = ops.panels.shape
    n_J, m = ops.n_J, ops.N * ops.p
    print(f"[shapes] top level: nD={nD} N={N} p={p} C={C} n_J={n_J} m={m}")
    rng = np.random.default_rng(1234)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    records = []
    f8 = 8
    panel_bytes = f8 * (nD * N * p * C + N * C)

    # K1 panel_fwd
    s = t(rng.standard_normal(n_J))
    dz0 = t(rng.standard_normal((m, nD)))
    err = compare("panel_fwd", K.panel_fwd(ops.panels, ops.cols, s, dz0),
                  K.panel_fwd_plain(ops.panels, ops.cols, s, dz0))
    G = csr_of_panels(ops)
    dzf = dz0.reshape(-1)
    compare("panel_fwd library", torch.addmv(dzf, G, s).reshape(m, nD),
            K.panel_fwd_plain(ops.panels, ops.cols, s, dz0))
    b, o = bound_ms(panel_bytes + f8 * (n_J + 2 * m * nD),
                    2 * nD * m * C + m * nD)
    records.append(dict(
        name="panel_fwd", source="mgbtpu_torch/kernels/csrc/panel_fwd.cu",
        replaces="mgbtpu/ops/pallas_dd.py:186", max_abs_err=err,
        bound_ms=b, bound_by=o, **timings(
            "panel_fwd", lambda: K.panel_fwd(ops.panels, ops.cols, s, dz0),
            lambda: K.panel_fwd_plain(ops.panels, ops.cols, s, dz0),
            lambda: torch.addmv(dzf, G, s))))

    # K2 power_cone_eval (timed in mode 2, the Hessian blocks)
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
    idx = (1, 2, 3)
    errs = []
    for mode in (0, 1, 2):
        errs.append(compare(
            f"power_cone mode {mode}",
            K.power_cone_eval(mode, Dz, A, bb, pp, mu, bw, wc, idx, 2),
            K.power_cone_plain(mode, Dz, A, bb, pp, mu, bw, wc, idx, 2)))
        ms, _ = device_ms(lambda: K.power_cone_eval(mode, Dz, A, bb, pp, mu,
                                                    bw, wc, idx, 2))
        print(f"[time] power_cone mode {mode}: device ms per call {ms!r}")
    nz = 3
    b, o = bound_ms(f8 * m * (nD + nz * nz + nz + 3 + nD * nD),   # no wc
                    m * (5 * nz * nz + 2 * nz ** 4 + nD * nD + 30))
    records.append(dict(
        name="power_cone", source="mgbtpu_torch/kernels/csrc/power_cone.cu",
        replaces="mgbtpu/ops/pallas_dd.py:258", max_abs_err=max(errs),
        bound_ms=b, bound_by=o, **timings(
            "power_cone mode 2",
            lambda: K.power_cone_eval(2, Dz, A, bb, pp, mu, bw, wc, idx, 2),
            lambda: K.power_cone_plain(2, Dz, A, bb, pp, mu, bw, wc, idx, 2),
            plain_reps=2)))

    # K3 panel_adj
    Y = t(rng.standard_normal((m, nD)))
    err = compare("panel_adj", K.panel_adj(ops.panels, ops.cols, ops.inv, Y, n_J),
                  K.panel_adj_plain(ops.panels, ops.cols, ops.inv, Y, n_J))
    GT = csr_of_panels(ops, transpose=True)
    Yf = Y.reshape(-1)
    compare("panel_adj library", torch.mv(GT, Yf),
            K.panel_adj_plain(ops.panels, ops.cols, ops.inv, Y, n_J))
    b, o = bound_ms(panel_bytes + f8 * (m * nD + n_J), 2 * nD * m * C)
    records.append(dict(
        name="panel_adj", source="mgbtpu_torch/kernels/csrc/panel_adj.cu",
        replaces="mgbtpu/ops/pallas_dd.py:228", max_abs_err=err,
        bound_ms=b, bound_by=o, **timings(
            "panel_adj",
            lambda: K.panel_adj(ops.panels, ops.cols, ops.inv, Y, n_J),
            lambda: K.panel_adj_plain(ops.panels, ops.cols, ops.inv, Y, n_J),
            lambda: torch.mv(GT, Yf))))

    # K4 gram_matvec
    Ln = t(np.tril(rng.standard_normal((m, nD, nD))))
    v = t(rng.standard_normal(n_J))
    err = compare("gram_matvec", K.gram_matvec(ops.panels, ops.cols, ops.inv, Ln, v),
                  K.gram_matvec_plain(ops.panels, ops.cols, ops.inv, Ln, v))
    b, o = bound_ms(panel_bytes + f8 * (m * nD * (nD + 1) // 2 + 2 * n_J),
                    4 * nD * m * C + 4 * m * nD * nD)
    records.append(dict(
        name="gram_matvec", source="mgbtpu_torch/kernels/csrc/gram_matvec.cu",
        replaces="mgbtpu/ops/pallas_dd.py:142", max_abs_err=err,
        bound_ms=b, bound_by=o, **timings(
            "gram_matvec",
            lambda: K.gram_matvec(ops.panels, ops.cols, ops.inv, Ln, v),
            lambda: K.gram_matvec_plain(ops.panels, ops.cols, ops.inv, Ln,
                                        v))))
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
    f8, records = 8, []

    errs = []
    for li, (F, a, b) in enumerate(levels):
        for part, out, ref in zip(("Lf", "U", "S"), K.front_factor(F, a, b),
                                  K.front_factor_plain(F, a, b)):
            errs.append(compare(f"front_factor level {li} {part}", out, ref))
    nbytes = nops = 0
    for F, a, b in levels:
        f, nk = a + b, F.shape[0]
        nbytes += f8 * nk * (f * f + a * a + a * b + b * b)
        for j in range(a):
            w = a - 1 - j
            nops += nk * (w * (w + 1) + 2 * b * w + 2 * b * b + w + b + 1)
    bnd, by = bound_ms(nbytes, nops)
    records.append(dict(
        name="front_factor", source="mgbtpu_torch/kernels/csrc/front_factor.cu",
        replaces="mgbtpu/ops/pallas_dd.py:446", max_abs_err=max(errs),
        bound_ms=bnd, bound_by=by, **timings(
            f"front_factor ({len(levels)} levels, one nd_factor)",
            lambda: [K.front_factor(F, a, b) for F, a, b in levels],
            lambda: [K.front_factor_plain(F, a, b) for F, a, b in levels])))

    rhs = [torch.as_tensor(rng.standard_normal((F.shape[0], a)), device=dev)
           for F, a, _ in levels]
    pairs = [(Lf.contiguous(), r, tr) for (Lf, _), r in zip(fact, rhs)
             for tr in (False, True)]
    errs = [compare(f"front_solve level {i // 2} transpose={tr}",
                    K.front_solve(Lf, r, tr), K.front_solve_plain(Lf, r, tr))
            for i, (Lf, r, tr) in enumerate(pairs)]
    nbytes = sum(f8 * r.numel() * ((r.shape[1] + 1) / 2 + 2)
                 for Lf, r, _ in pairs)
    nops = sum(r.shape[0] * r.shape[1] ** 2 for Lf, r, _ in pairs)
    bnd, by = bound_ms(nbytes, nops)
    records.append(dict(
        name="front_solve", source="mgbtpu_torch/kernels/csrc/front_solve.cu",
        replaces="mgbtpu/ops/pallas_dd.py:446", max_abs_err=max(errs),
        bound_ms=bnd, bound_by=by, **timings(
            f"front_solve ({len(pairs)} sweeps, one nd_solve)",
            lambda: [K.front_solve(Lf, r, tr) for Lf, r, tr in pairs],
            lambda: [K.front_solve_plain(Lf, r, tr) for Lf, r, tr in pairs],
            lambda: [torch.linalg.solve_triangular(
                Lf.mT if tr else Lf, r[:, :, None], upper=tr)
                for Lf, r, tr in pairs])))
    return records


def solve(L, torch):
    """Assembles fem2d_P2, p=1 at level L for the card; returns the problem
    and a runner of one timed ``mgb_solve`` -> (seconds, solution, host
    syncs)."""
    from mgbtpu_torch import amg, assemble, fem2d_P2, mgb_solve, subdivide
    from mgbtpu_torch.solver.newton import SYNCS

    t0 = time.time()
    prob = assemble(amg(subdivide(fem2d_P2(), L)), p=1.0, device="cuda")
    print(f"[setup] L={L}: subdivide + amg + assemble {time.time() - t0!r} s")
    return prob, lambda: _timed_solve(prob, mgb_solve, torch, SYNCS)


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
    print(f"[solve] {tag}: {secs!r} s, its per level {its.tolist()} "
          f"total {int(its.sum())}, steps {S['steps_accepted']}/"
          f"{S['steps_attempted']} (accepted/attempted), "
          f"cg {int(S['cg'].sum())}, host syncs {syncs}, "
          f"|z| {float(np.linalg.norm(sol.z))!r}, its per ramp step "
          f"{S['its'][-1].tolist()}")
    if not np.all(np.isfinite(sol.z)):
        raise RuntimeError(f"{tag}: non-finite solution")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", type=int, action="append", default=[],
                    help="also solve fem2d_P2 at this level once")
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

    prob, run = solve(5, torch)
    records = kernel_phases(prob, torch, K)

    s1, sol1, syncs1 = run()
    report("L=5 first", s1, sol1, syncs1)
    K.reset_launches()
    s2, sol, syncs = run()
    launches = K.launches()
    report("L=5 second", s2, sol, syncs)
    print(f"[solve] second solve bitwise equal to the first: "
          f"{bool(np.array_equal(sol.z, sol1.z))}")
    print(f"[kernels] launches in the second L=5 solve: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    for r in records:
        r["launches"] = launches[r["name"]]

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

    for L in args.level:
        _, run_L = solve(L, torch)
        sL, solL, syL = run_L()
        report(f"L={L}", sL, solL, syL)
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

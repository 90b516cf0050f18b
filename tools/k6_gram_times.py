#!/usr/bin/env python3
"""Device times of K6 ``node_barrier`` on the tables that run its
runtime-width cone (the wide and the table kernels), beside the bytes
bound, the library's A' Hz A and the plain version, and the wall of the
Models' solves that run it, on one CUDA card.

    python3 tools/k6_gram_times.py [ROOT]

ROOT (optional) is a second tree, e.g. a parent commit unpacked with
``git archive`` into a gitignored directory: its ``mgbtpu_torch`` is loaded
beside this checkout's (as ``mgbtpu_torch_root``, its kernels built under
ROOT/build), and each call and solve is timed in turns, ROOT's first
(a, b, b, a). Each tree's K6 is held to the bits of its own plain
version of the order it runs (this checkout: ``chip_smoke.k6_check``,
which also holds it to the reference order by ``gram_order_bound``;
ROOT: ``node_barrier_plain``, or ``node_barrier_gram_plain`` where it has
one).

Tables (``chip_smoke.k6_calls``: modes 0/1/2 as the barrier and in the
phase-I form): the cones of nz = 33 over 65 rows and nz = 17 over 33 rows
and the 17 pieces of ``chip_smoke.table_kernel_tables`` at 4,096 seeded
nodes; the lone nz = 7 cone of ``chip_smoke.wide_tables`` at 57,344; the
tables the Models' lowerings give K6 at their own nodes and rows (the
17-constraint, 16- and 32-field models on fem1d's 8 nodes, the
three-field model at L=3's 224), from this checkout's solves. Each call
prints one ``[k6]`` line: {tree: [ms, ms]} device ms in turns
(``chip_smoke.device_ms``), the library's and the plain version's ms and
the bound. Each Model's solve prints one ``[solve]`` line: {tree: [s, s]}
wall seconds in turns, with its Newton its and K6 launches by mode.
``--no-solves`` skips the solves.
"""
import importlib
import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch as mt  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
import port_models  # noqa: E402

MODELS = ("seventeen_constraints", "sixteen_fields", "thirty_two_fields",
          "three_fields")


def load_tree(root):
    """ROOT's ``mgbtpu_torch``, loaded as ``mgbtpu_torch_root``."""
    name = "mgbtpu_torch_root"
    pkg = os.path.join(os.path.abspath(root), "mgbtpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(f"{name}.kernels")
    return mod


def reps_for(fn):
    """Calls a timing: about half a second of device time, 2 to 50."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return int(max(2, min(50, 0.5 / max(time.perf_counter() - t0, 1e-6))))


def time_call(tag, call, trees, smi):
    """The call in each tree's K6 in turns; prints the [k6] line."""
    for label, KK in trees:
        if label == "b":
            continue
        plain = getattr(KK, "node_barrier_gram_plain", KK.node_barrier_plain)
        C.same_bits(f"{tag} {label}", KK.node_barrier(*call), plain(*call),
                    "its plain version")
    got = {label: [] for label, _ in trees}
    fns = [(label, (lambda KK=KK: KK.node_barrier(*call)))
           for label, KK in trees]
    for label, fn in fns + fns[::-1]:
        got[label].append(C.device_ms(fn, reps_for(fn))[0])
    lib = C.cone_library(call)
    lib_ms = C.device_ms(lib, 50)[0] if lib is not None else None
    plain_ms = C.device_ms(lambda: K.node_barrier_gram_plain(*call), 2)[0]
    bnd, by = C.k6_bound(call)
    mode, y = call[0], call[1]
    print(f"[k6] {tag} (m={y.shape[0]}, ny={y.shape[1]}, mode {mode}): "
          f"device ms {got}, library {lib_ms!r}, plain {plain_ms!r}, bound "
          f"{bnd!r} ({by}) on {smi}", flush=True)


def model_solve(pkg, name):
    """(wall s, model, solution, K6 launches by mode) of ``name`` built and
    solved with ``pkg`` on the card."""
    mg = pkg.amg(pkg.subdivide(pkg.fem2d_P2(), 3)) if name == "three_fields" \
        else pkg.amg(pkg.fem1d(nodes=np.linspace(-1.0, 1.0, 5)))
    m, _ = port_models.MODELS[name](pkg, mg)
    pkg.kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = m.solve(**port_models.SOLVE)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, m, sol,
            list(pkg.kernels.node_barrier.mode_launches))


def main():
    if not torch.cuda.is_available():
        sys.exit("k6_gram_times: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    trees = []
    if args:
        R = load_tree(args[0])
        print(f"[tree] ROOT {os.path.abspath(args[0])} (a), this checkout "
              f"{HERE} (b)")
        R.kernels.build_all()
        trees.append(("a", R))
    K.build_all()
    trees.append(("b", mt))
    ktrees = [(label, pkg.kernels) for label, pkg in trees]
    dev = torch.device("cuda")
    rng = np.random.default_rng(4096)
    m = C.TABLE_M
    tables = [(f"{name} m={m}", Q, nD, nu, m) for name, Q, nD, nu
              in C.table_kernel_tables(m, rng)]
    tables += [(f"{name} m={C.MODEL_M}", Q, nD, nu, C.MODEL_M)
               for name, Q, nD, nu in C.wide_tables(C.MODEL_M, rng)
               if name == "cone nz=7"]
    for tag, Q, nD, nu, mm in tables:
        Dz = torch.as_tensor(C._wide_rows(mm, Q, nD, rng),
                             dtype=torch.float64, device=dev)
        calls = C.k6_calls(Q, Dz, nu, np.full(mm, 1.0 / mm), torch, K, rng)
        C.k6_check(tag, calls, K)
        for label, call in calls.items():
            time_call(f"{tag} {label}", call, ktrees, smi)
        del calls, Dz
    for k, name in enumerate(MODELS):
        if "--no-solves" not in sys.argv:
            walls = {label: [] for label, _ in trees}
            for label, pkg in trees + trees[::-1]:
                secs, _, sol, modes = model_solve(pkg, name)
                walls[label].append(secs)
                its = sol.SOL_main["its"].sum(axis=0).tolist()
                print(f"[solve] Model {name} ({label}): {secs!r} s wall, "
                      f"its per ramp step {its}, node_barrier by mode "
                      f"{modes}", flush=True)
            print(f"[solve] Model {name}: wall s {walls} on {smi}",
                  flush=True)
        # K6 on the table this checkout's lowering gives it, at its rows
        model = model_solve(mt, name)[1]
        prob = model._lowered["prob"]
        M, Q = prob.M[0], prob.Q
        calls = C.k6_calls(Q, torch.as_tensor(model._Dz(), device=dev), M.nu,
                           np.asarray(M.w, np.float64), torch, K,
                           np.random.default_rng(94 + k))
        C.k6_check(f"Model {name} table", calls, K)
        for label in ("mode 0", "mode 1", "mode 2", "co mode 2"):
            time_call(f"Model {name} table {label}", calls[label], ktrees,
                      smi)


if __name__ == "__main__":
    main()

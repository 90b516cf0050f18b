#!/usr/bin/env python3
"""Device times of K6 ``node_barrier``'s wide kernels beside its table
kernels on the tables the wide kernels take, on one CUDA card.

    python3 tools/k6_wide_vs_table.py

The tables are the ones ``chip_smoke.py`` runs in the wide kernels: the
lone nz = 7 cone of ``chip_smoke.wide_tables`` at 57,344 seeded nodes
(10 rows, 15 in phase I) and the three-field Model's table at its L=3 top
level (a cone nz = 7 over 10 rows, m = 224, on the solution's rows with
1 % of the nodes pushed outside). Each of the six calls of
``chip_smoke.k6_calls`` (modes 0/1/2, barrier and phase-I form) runs in
its wide kernel (``node_barrier``) and, forced, in the table kernel of the
same mode and form (``node_barrier._launch_table`` with the same
runtime-width instances); both are held bitwise against the plain version
of their order (``node_barrier_gram_plain``) and timed in turns (wide,
table, table, wide; ``chip_smoke.device_ms``). Prints one
``[wide-vs-table]`` line a call and the card's name and power limit."""
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch as mt  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
import port_models  # noqa: E402
from mgbtpu_torch.kernels import _build  # noqa: E402

# the module (the package exports its function under the same name)
NB = sys.modules["mgbtpu_torch.kernels.node_barrier"]


def table_launch(call):
    """The call in the table kernel of its mode and form."""
    mode, Dz, pieces, args, sel, bw, wc, co, box = call
    m, ny = Dz.shape
    inst = NB.instance(pieces, mode, ny, co, box is not None)
    out = torch.empty(((m,), (m, ny), (m, ny, ny))[mode], dtype=torch.float64,
                      device=Dz.device)
    _build.check(NB.NAME, NB._launch_table(mode, Dz, pieces, inst.codes, args,
                                           sel, bw, wc, co, box, out))
    return out


def compare(tag, calls, reps):
    for label, call in calls.items():
        mode, Dz, pieces, _, _, _, _, co, box = call
        inst = NB.instance(pieces, mode, Dz.shape[1], co, box is not None)
        if not inst.wide or inst.table:
            raise SystemExit(f"{tag} {label}: not a wide-kernel call ({inst})")
        ref = K.node_barrier_gram_plain(*call)
        C.same_bits(f"{tag} {label} wide kernel", K.node_barrier(*call), ref,
                    "the plain version")
        C.same_bits(f"{tag} {label} table kernel", table_launch(call), ref,
                    "the plain version")
        times = {"wide": [], "table": []}
        for which in ("wide", "table", "table", "wide"):
            fn = ((lambda: K.node_barrier(*call)) if which == "wide"
                  else (lambda: table_launch(call)))
            ms, hidden = C.device_ms(fn, reps=reps)
            times[which].append(ms if hidden else f"{ms!r} (host not hidden)")
        print(f"[wide-vs-table] {tag} {label} (ny={Dz.shape[1]}, m="
              f"{Dz.shape[0]}): device ms per call, wide kernel "
              f"{times['wide']}, table kernel {times['table']}")


def main():
    if not torch.cuda.is_available():
        sys.exit("k6_wide_vs_table: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {smi.strip()}")
    _build.build_all(("node_barrier",))
    rng = np.random.default_rng(5734)
    m = C.MODEL_M
    w = np.full(m, 1.0 / m)
    for name, Q, nD, nu in C.wide_tables(m, rng):
        if name != "cone nz=7":
            continue
        Dz = torch.as_tensor(C._wide_rows(m, Q, nD, rng), dtype=torch.float64,
                             device="cuda")
        compare(f"{name} m={m}", C.k6_calls(Q, Dz, nu, w, torch, K, rng), 20)
    mg = mt.amg(mt.subdivide(mt.fem2d_P2(), 3))
    model, _ = port_models.MODELS["three_fields"](mt, mg)
    model.solve(**port_models.SOLVE)
    M, Q = model._lowered["prob"].M[0], model._lowered["prob"].Q
    rng = np.random.default_rng(96)
    Dz = model._Dz()
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == NB.POWER})
    bad = rng.choice(len(Dz), max(len(Dz) // 100, 1), replace=False)
    Dz[np.ix_(bad, s_rows)] = -rng.uniform(0.0, 1.0, (len(bad), len(s_rows)))
    calls = C.k6_calls(Q, torch.as_tensor(Dz, device="cuda"), M.nu,
                       np.asarray(M.w, np.float64), torch, K, rng)
    compare(f"three-field Model L=3 m={len(Dz)}", calls, 50)


if __name__ == "__main__":
    main()

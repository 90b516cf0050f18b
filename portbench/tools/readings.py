"""The readings that the limits of a cell are set from, on the card.

    python3 portbench/tools/readings.py --workload <cell> --seeds S1 S2 ...

One process builds the cell's configuration once, then for each seed solves
the run's probe request (its data drawn from the seed) and prints, as one
JSON line, the reference's numbers for

- ``sound``: the program's answer;
- ``control``: the lower-precision control, the answer rounded to float32
  (no float32 program can return one nearer the float64 answer);
- ``unchanged``: the answer left at its start (the state returned unchanged);
- ``half``: half of the nodes' answers left at their start;
- ``altered``: one free node's u moved by 1e-6 of the largest |u|;
- ``short`` (with ``--short``, a second solve a seed): the program's answer
  with its t-ramp stopped one step short, at t = 1/(``SHORT`` tol), judged
  at t = 1/tol: an approximate answer, what a solve that drops its last
  t-step returns.

The benchmark's runs do not run this; ``limits/<cell>.json`` holds the
limits set from its output, and ``PERF.md`` the readings.
"""
import argparse
import json
import os
import sys
import time

if not __package__:     # run as a script: the checkout's root, not tools/
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import generator, harness, reference  # noqa: E402
from portbench.reference import certify  # noqa: E402


# the ramp's t-step factor (``mgb_core``'s kappa): a ramp that ends this
# factor short of 1/tol has dropped its last step
SHORT = 6.5


def faults(disc, z, g, rng):
    """The planted faults' answers, each from the sound answer z."""
    start = g.copy()
    half = z.copy()
    pick = rng.permutation(len(z))[: len(z) // 2]
    half[pick] = start[pick]
    altered = z.copy()
    free = np.flatnonzero(~disc.boundary[disc.dof])
    k = free[rng.integers(len(free))]
    altered[k, 0] += 1e-6 * np.abs(z[:, 0]).max()
    return {"unchanged": start, "half": half, "altered": altered,
            "control": z.astype(np.float32).astype(np.float64)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--short", action="store_true",
                    help="also solve each seed's probe with the ramp one "
                         "step short and read it")
    args = ap.parse_args(argv)
    import mgbtpu_torch as mt

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    cfg = cell.cfg
    disc = reference.build(cfg)
    t0 = time.time()
    mg = mt.amg(mt.subdivide(harness._element(mt, cfg), int(cfg["level"])))
    M = Q = None
    t = 1.0 / float(cfg["tol"])
    print(f"[setup] {time.time() - t0:.3f} s", file=sys.stderr, flush=True)
    for seed in args.seeds:
        mix = generator.Mix(cell.mix, disc.x, seed)
        f, g = mix.request(mix.PROBE)
        prob = mt.assemble(mg, p=float(cfg["p"]), M=M, Q=Q, f_grid=f,
                           g_grid=g, device=args.device)
        M, Q = prob.M, prob.Q
        t0 = time.time()
        sol = mt.mgb_solve(prob, device=args.device, tol=float(cfg["tol"]))
        secs = time.time() - t0
        z = np.asarray(sol.z, dtype=np.float64)
        out = {"seed": seed, "solve_s": secs,
               "its": int(sol.SOL_main["its"].sum()),
               "sound": certify.readings(disc, f, g, z, t)}
        rng = np.random.default_rng([seed % 2 ** 64, 7])
        for name, zf in faults(disc, z, g, rng).items():
            out[name] = certify.readings(disc, f, g, zf, t)
        if args.short:
            t0 = time.time()
            sol = mt.mgb_solve(prob, device=args.device,
                               tol=SHORT * float(cfg["tol"]))
            out["short_solve_s"] = time.time() - t0
            out["short"] = certify.readings(
                disc, f, g, np.asarray(sol.z, dtype=np.float64), t)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

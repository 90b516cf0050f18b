#!/usr/bin/env python3
"""fem2d_P2 p=1 L=5 over a mesh of distinct cards, on a machine with two or
more (the mesh phase of ``chip_smoke.py`` shards one card only).

    python3 tools/mesh_cards.py

Builds the kernels, solves once unsharded and then over ``make_mesh()``
(every card) and over ``make_mesh(devices=[cuda:0] * n)`` (n shards on one
card), each twice, in turns; prints each solve's wall, Newton and CG
counts, its launches per shard (``chip_smoke.ShardSpy``) and its transfers,
and fails unless every mesh solve gives the unsharded bits, with K1-K5 on
every shard. Prints the cards' names and power limits first.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    import torch

    if torch.cuda.device_count() < 2:
        print("mesh_cards: needs two or more cards", file=sys.stderr)
        return 2
    import chip_smoke as C
    import mgbtpu_torch as mt
    import mgbtpu_torch.kernels as K
    from mgbtpu_torch.parallel.sharding import TRANSFERS, reset_transfers

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"[build] {K.build_all(force=True)!r} s")
    _, prob, run = C.solve(5, torch)
    run()
    n = torch.cuda.device_count()
    meshes = {f"{n} cards": mt.make_mesh(),
              f"{n} shards on cuda:0": mt.make_mesh(
                  devices=[torch.device("cuda", 0)] * n)}
    for rnd in range(2):
        secs, sol0, syncs = run()
        C.report(f"unsharded (round {rnd})", secs, sol0, syncs)
        for tag, mesh in meshes.items():
            reset_transfers()
            secs, sol, _, per, syncs, _ = C.mesh_solve(
                f"{tag} (round {rnd})", prob, mesh, torch, K, smi, C.MESH,
                prob.M)
            same = bool(np.array_equal(sol.z, sol0.z))
            print(f"[mesh] {tag}: {secs!r} s wall, bitwise equal to the "
                  f"unsharded solve: {same}; transfers {dict(TRANSFERS)}")
            if not same:
                raise RuntimeError(f"{tag}: differs from the unsharded "
                                   f"solve")
    print(f"[time] mesh_cards: done at {time.strftime('%H:%M:%S')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

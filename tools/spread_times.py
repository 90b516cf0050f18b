#!/usr/bin/env python3
"""Device times of K1 ``panel_fwd`` and K3 ``panel_adj`` at one element of
many rows (the spectral levels), in their spread forms and in the forms
that also take the shape, beside their plain versions, one library call
and the bytes bound, on one CUDA card.

    python3 tools/spread_times.py

Shapes (nD, N = 1, p, C), seeded panels: the top levels of spectral1d
n = 128 (3, 1, 128, 254), spectral2d n = 16 (4, 1, 256, 452) and n = 32
(4, 1, 1024, 1924), one row of spectral2d n = 32's nodes (1, 1, 1024,
1924) and its parabolic phase-I rows (9, 1, 1024, 3972). Each form that
takes a shape (K1: the spread form 3 and, for p*nD <= 1,024, the wide
form 2; K3: the spread form 3 and, for p*nD <= 4,096, the staged phase A
1) is timed in turns (a, b, b, a) and held to the other's bits. The
library call is ``torch.addmv`` (K1, with Dz0) or ``torch.mv`` (K3, the
per-slot sums) on the element's dense (nD*p, C) panel view. Each line is
a ``[spread]`` line.
"""
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
from mgbtpu_torch.solver.levelops import inverse_incidence  # noqa: E402

SHAPES = [(3, 128, 254), (4, 256, 452), (1, 1024, 1924), (4, 1024, 1924),
          (9, 1024, 3972)]


def in_form(fn, code, *args):
    mod = sys.modules[fn.__module__]
    mod._FORM = code
    try:
        return fn(*args)
    finally:
        mod._FORM = 0


def time_forms(tag, fn, codes, args, reps=100):
    """The forms ``codes`` of ``fn(*args)`` timed in turns, their bits held
    to each other. Returns {code: [ms, ms]}."""
    outs = [in_form(fn, c, *args) for c in codes]
    for o in outs[1:]:
        C.same_bits(f"{tag} forms", o, outs[0], "the other form")
    got = {c: [] for c in codes}
    for c in codes + codes[::-1]:
        got[c].append(C.device_ms(lambda: in_form(fn, c, *args), reps)[0])
    return got


def main():
    if not torch.cuda.is_available():
        sys.exit("spread_times: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    K.build_all(("panel_fwd", "panel_adj"))
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    for nD, p, Cw in SHAPES:
        n_J = Cw + 37
        cols = np.sort(rng.choice(n_J, Cw, replace=False))[None, :]
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        panels = t(rng.standard_normal((nD, 1, p, Cw)))
        colt, inv = t(cols), t(inverse_incidence(cols, n_J))
        s, dz0 = t(rng.standard_normal(n_J)), t(rng.standard_normal((p, nD)))
        Y = t(rng.standard_normal((p, nD)))
        b1, _ = C.bound_ms(8 * (nD * p * Cw + Cw + n_J + 2 * p * nD), 0)
        b3, _ = C.bound_ms(8 * (nD * p * Cw + Cw + p * nD + n_J), 0)
        P, c0 = panels.reshape(nD * p, Cw), colt[0]
        dzf = dz0.t().contiguous().reshape(-1)
        Yf = Y.t().contiguous().reshape(-1)
        tag = f"(nD, N, p, C) = ({nD}, 1, {p}, {Cw})"
        fwd = time_forms(f"panel_fwd {tag}", K.panel_fwd,
                         [3, 2] if p * nD <= 1024 else [3],
                         (panels, colt, s, dz0))
        adj = time_forms(f"panel_adj {tag}", K.panel_adj,
                         [3, 1] if p * nD <= 4096 else [3],
                         (panels, colt, inv, Y, n_J))
        lib1 = C.device_ms(lambda: torch.addmv(dzf, P, s[c0]), 100)[0]
        lib3 = C.device_ms(lambda: torch.mv(P.t(), Yf), 100)[0]
        pl1 = C.device_ms(lambda: K.panel_fwd_plain(panels, colt, s, dz0),
                          50)[0]
        pl3 = C.device_ms(lambda: K.panel_adj_plain(panels, colt, inv, Y,
                                                    n_J), 50)[0]
        print(f"[spread] panel_fwd {tag}: device ms by form {fwd}, plain "
              f"{pl1!r}, torch.addmv {lib1!r}, bound {b1!r} (bytes)")
        print(f"[spread] panel_adj {tag}: device ms by form {adj}, plain "
              f"{pl3!r}, torch.mv {lib3!r}, bound {b3!r} (bytes)")


if __name__ == "__main__":
    main()

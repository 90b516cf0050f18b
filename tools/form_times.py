#!/usr/bin/env python3
"""Device times of K1 ``panel_fwd``, K4 ``gram_matvec`` and K5a
``front_factor`` in each of their forms, at the shapes where the C entries
choose between them, on one CUDA card.

    python3 tools/form_times.py [ROOT]

ROOT (default: this checkout) is the tree whose ``mgbtpu_torch`` and
``chip_smoke.py`` are used, so that two versions can be timed in one call:
run it over each tree in turn (A, B, B, A). Where a wrapper's module has
the private ``_FORM`` (0: the C entry's choice by shape; 1: the staged
form, 2: the wide form), each form that takes the shape is timed and held
to the other's bits; a wrapper without it (an older tree) is timed in the
C entry's choice only. Each time is printed as a ``[form]`` line, the
forms in turns (staged, wide, wide, staged).

Shapes: K1 and K4 at the fem2d_P2 L=5 top level (its real panels) and on
seeded panels at the fem3d Q3 element's p = 64, nD = 5, N = 512 with C at
the last the staged forms take (K1 90, K4 82); K5a on seeded SPD fronts at
every tree level of the fem2d_P2 L=5 and L=7 plans and of the fem3d k=3
L=4 plan (the shapes ``chip_smoke.py`` prints).
"""
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
from mgbtpu_torch import amg, assemble, fem2d_P2, subdivide  # noqa: E402
from mgbtpu_torch.solver.levelops import inverse_incidence  # noqa: E402

# (nk, amax, bmax) leaf .. root
ND_LEVELS = {
    "fem2d_P2 L=5": [(64, 73, 16), (32, 3, 24), (16, 7, 32), (8, 7, 39),
                     (4, 15, 31), (2, 15, 31), (1, 31, 1)],
    "fem2d_P2 L=7": [(1024, 73, 16), (512, 3, 24), (256, 7, 32),
                     (128, 7, 48), (64, 15, 64), (32, 15, 96), (16, 31, 128),
                     (8, 31, 159), (4, 63, 127), (2, 63, 127), (1, 127, 1)],
    "fem3d k=3 L=4": [(64, 637, 218), (32, 25, 313), (16, 55, 403),
                      (8, 121, 397), (4, 121, 529), (2, 253, 529),
                      (1, 529, 1)],
}
STAGED_FITS = {"panel_fwd": 90, "gram_matvec": 82}   # last C at p=64, nD=5
FRONT_FITS = 790                                     # last f of K5a's panel


def forms_of(fn, fits):
    """The forms to time: [(label, code)]."""
    if not hasattr(sys.modules[fn.__module__], "_FORM"):
        return [("shape", 0)]
    return [("staged", 1), ("wide", 2)] if fits else [("wide", 2)]


def in_form(fn, code, *args):
    mod = sys.modules[fn.__module__]
    if code:
        mod._FORM = code
    try:
        return fn(*args)
    finally:
        if code:
            mod._FORM = 0


def time_forms(tag, fn, fits, args, reps=50):
    """Each form of ``fn(*args)`` timed in turns; the forms' bits held to
    each other. Returns {label: [ms, ms]}."""
    forms = forms_of(fn, fits)
    outs = [in_form(fn, code, *args) for _, code in forms]
    for o in outs[1:]:
        a = o if isinstance(o, tuple) else (o,)
        b = outs[0] if isinstance(outs[0], tuple) else (outs[0],)
        C.same_bits(f"{tag} forms", torch.cat([x.flatten() for x in a]),
                    torch.cat([x.flatten() for x in b]), "the other form")
    order = forms + forms[::-1]
    got = {label: [] for label, _ in forms}
    for label, code in order:
        ms, hidden = C.device_ms(lambda: in_form(fn, code, *args), reps)
        got[label].append(ms)
        print(f"[form] {tag} {label}: device ms per call {ms!r}"
              + ("" if hidden else " (host not hidden: an upper bound)"))
    return got


def seeded_panels(rng, nD, N, p, Cw, n_J):
    cols = np.sort(np.stack([rng.choice(n_J, Cw, replace=False)
                             for _ in range(N)]), axis=1)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return (t(rng.standard_normal((nD, N, p, Cw))), t(cols),
            t(inverse_incidence(cols, n_J)), n_J)


def panel_shapes(rng):
    """(tag, panels, cols, inv, n_J, {kernel: fits}) at the K1/K4 shapes."""
    M = assemble(amg(subdivide(fem2d_P2(), 5)), p=1.0, device="cuda").M[0]
    ops = C.top_level_ops(M, "fem2d_P2 L=5", torch)
    yield ("fem2d_P2 L=5", ops.panels, ops.cols, ops.inv, ops.n_J,
           {"panel_fwd": True, "gram_matvec": True})
    for name, Cw in STAGED_FITS.items():
        yield (f"p=64 nD=5 C={Cw}", *seeded_panels(rng, 5, 512, 64, Cw,
                                                   45000), {name: True})


def main():
    if not torch.cuda.is_available():
        sys.exit("form_times: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    K.build_all(("panel_fwd", "gram_matvec", "front_factor"))
    rng = np.random.default_rng(11)
    for tag, panels, cols, inv, n_J, which in panel_shapes(rng):
        nD, N, p, _ = panels.shape
        s = torch.as_tensor(rng.standard_normal(n_J), device="cuda")
        dz0 = torch.as_tensor(rng.standard_normal((N * p, nD)),
                              device="cuda")
        Ln = torch.as_tensor(np.tril(rng.standard_normal((N * p, nD, nD))),
                             device="cuda")
        if "panel_fwd" in which:
            time_forms(f"panel_fwd {tag}", K.panel_fwd, True,
                       (panels, cols, s, dz0))
        if "gram_matvec" in which:
            time_forms(f"gram_matvec {tag}", K.gram_matvec, True,
                       (panels, cols, inv, Ln, s))
    g = torch.Generator(device="cuda").manual_seed(7)
    for plan, shapes in ND_LEVELS.items():
        total = {}
        for li, (nk, a, b) in enumerate(shapes):
            f = a + b
            X = torch.randn((nk, f, 2 * f), generator=g, dtype=torch.float64,
                            device="cuda")
            F = torch.zeros((nk, f + 1, f + 1), dtype=torch.float64,
                            device="cuda")
            F[:, :f, :f] = X @ X.mT / f + 0.5 * torch.eye(f, device="cuda")
            del X
            got = time_forms(f"front_factor {plan} level {li} {(nk, a, b)}",
                             K.front_factor, f <= FRONT_FITS, (F, a, b),
                             reps=10)
            for label, ms in got.items():
                total.setdefault(label, []).append(min(ms))
        print(f"[form] front_factor {plan}: sum over levels of the faster "
              f"turn, ms per nd_factor: "
              + ", ".join(f"{k} {sum(v)!r} ({len(v)} levels)"
                          for k, v in total.items()))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device times of K1 ``panel_fwd``, K4 ``gram_matvec`` and K5a
``front_factor`` in each of their forms, at the shapes where the C entries
choose between them, on one CUDA card.

    python3 tools/form_times.py [ROOT] [--chains]

ROOT (default: this checkout) is the tree whose ``mgbtpu_torch`` and
``chip_smoke.py`` are used, so that two versions can be timed in one call:
run it over each tree in turn (A, B, B, A). The plans' shapes come from
this checkout's ``chip_smoke.py`` whatever ROOT is, and so do the made-up
dof maps of ``--chains`` (``seeded_nd``). Where a wrapper's module has
the private ``_FORM`` (0: the C entry's choice by shape; 1: the staged
form, 2: the wide form of K1 and K4, the large form of K5a), each form
that takes the shape is timed and held to the other: K1's and K4's forms
to each other's bits, K5a's to 1e-12 relative (its large form sums in
another order); a wrapper without it (an older tree) is timed in the C
entry's choice only. Each time is printed as a ``[form]`` line, the forms
in turns (staged, other, other, staged).

Shapes: K1 and K4 at the fem2d_P2 L=5 top level (its real panels) and on
seeded panels at the fem3d Q3 element's p = 64, nD = 5, N = 512 with C at
the last the staged forms take (K1 90, K4 82); K5a on seeded SPD fronts at
every tree level of the fem2d_P2 L=5 and L=7 plans and of the fem3d k=3
L=4 plan (the shapes ``chip_smoke.py`` prints).

``--chains`` times instead the two chains of launches a fem3d solve makes
at the L=4 and L=5 plans' shapes, in the forms the shape rule gives: K5a
over every tree level one after another (one ``nd_factor``'s worth, on
seeded SPD fronts) and ``nd_solve`` over those factors (K5b, both sweeps,
on made-up dof maps: each level's fronts own distinct dofs, their
boundary dofs drawn from the levels above), printed as ``[chain]`` lines.
"""
import importlib.util
import os
import subprocess
import sys

_ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = os.path.abspath(_ARGS[0] if _ARGS else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
from mgbtpu_torch.ops.ndchol import nd_solve  # noqa: E402
from mgbtpu_torch import amg, assemble, fem2d_P2, subdivide  # noqa: E402
from mgbtpu_torch.solver.levelops import inverse_incidence  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_here", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "chip_smoke.py"))
HERE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(HERE)

# (nk, amax, bmax) leaf .. root
ND_LEVELS = {
    "fem2d_P2 L=5": [(64, 73, 16), (32, 3, 24), (16, 7, 32), (8, 7, 39),
                     (4, 15, 31), (2, 15, 31), (1, 31, 1)],
    "fem2d_P2 L=7": [(1024, 73, 16), (512, 3, 24), (256, 7, 32),
                     (128, 7, 48), (64, 15, 64), (32, 15, 96), (16, 31, 128),
                     (8, 31, 159), (4, 63, 127), (2, 63, 127), (1, 127, 1)],
    "fem3d k=3 L=4": HERE.FEM3D_L4,
}
STAGED_FITS = {"panel_fwd": 90, "gram_matvec": 82}   # last C at p=64, nD=5
FRONT_FITS = 790                                     # last f of K5a's panel


def forms_of(fn, fits):
    """The forms to time: [(label, code)]."""
    if not hasattr(sys.modules[fn.__module__], "_FORM"):
        return [("shape", 0)]
    other = "large" if fn is K.front_factor else "wide"
    return [("staged", 1), (other, 2)] if fits else [(other, 2)]


def time_forms(tag, fn, fits, args, reps=50):
    """Each form of ``fn(*args)`` timed in turns; the forms held to each
    other (bits; K5a's to 1e-12). Returns {label: [ms, ms]}."""
    forms = forms_of(fn, fits)
    outs = [C.in_form(fn, code, *args) for _, code in forms]
    for o in outs[1:]:
        a = o if isinstance(o, tuple) else (o,)
        b = outs[0] if isinstance(outs[0], tuple) else (outs[0],)
        a, b = (torch.cat([x.flatten() for x in t]) for t in (a, b))
        if fn is K.front_factor:
            C.compare(f"{tag} forms", a, b)
        else:
            C.same_bits(f"{tag} forms", a, b, "the other form")
    order = forms + forms[::-1]
    got = {label: [] for label, _ in forms}
    for label, code in order:
        ms, hidden = C.device_ms(lambda: C.in_form(fn, code, *args), reps)
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


def chains():
    """K5a per nd_factor and K5b per nd_solve at the fem3d L=4 and L=5
    plans' shapes (see the module's note)."""
    rng = np.random.default_rng(13)
    for L, shapes in ((4, HERE.FEM3D_L4), (5, HERE.FEM3D_L5)):
        levels = C.seeded_fronts(torch, shapes, L)
        ms_f, hid_f = C.device_ms(
            lambda: [K.front_factor(F, a, b) for F, a, b in levels], 5)
        fact = [K.front_factor(F, a, b)[:2] for F, a, b in levels]
        del levels
        nd = HERE.seeded_nd(torch, shapes, rng)
        rhs = torch.as_tensor(rng.standard_normal(nd.n_J), device="cuda")
        ms_s, hid_s = C.device_ms(lambda: nd_solve(nd, fact, rhs), 10)
        del fact
        print(f"[chain] fem3d L={L}: front_factor {ms_f!r} ms per "
              f"nd_factor ({len(shapes)} calls), front_solve {ms_s!r} ms "
              f"per nd_solve ({2 * len(shapes)} calls)"
              + ("" if hid_f and hid_s else
                 " (host not hidden: an upper bound)"))
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("form_times: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi} [tree] {ROOT}")
    if "--chains" in sys.argv:
        K.build_all(("front_factor", "front_solve"))
        chains()
        return
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
    for plan, shapes in ND_LEVELS.items():
        total = {}
        for li, (F, a, b) in enumerate(C.seeded_fronts(torch, shapes, 7)):
            got = time_forms(f"front_factor {plan} level {li} "
                             f"{(F.shape[0], a, b)}", K.front_factor,
                             a + b <= FRONT_FITS, (F, a, b), reps=10)
            for label, ms in got.items():
                total.setdefault(label, []).append(min(ms))
        print(f"[form] front_factor {plan}: sum over levels of the faster "
              f"turn, ms per nd_factor: "
              + ", ".join(f"{k} {sum(v)!r} ({len(v)} levels)"
                          for k, v in total.items()))


if __name__ == "__main__":
    main()

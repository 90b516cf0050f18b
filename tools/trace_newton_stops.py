"""Traces the stopping tests of both Newton loops, the JAX package's and the
port's, iteration by iteration, on one Model case of
``tests/test_torch_model.py`` (default ``equality_reaction``) or one of
``port_models.WIDE_MODELS``, on the CPU. A field model's JAX side is its
one-field equivalent, the source of its x64 record
(``tests/test_torch_reference_wide_models.py``).

Each Newton iteration ends with two tests: the exact one,
``ymin <= y_new and |g_new| >= theta * g_min``, and the inexact one,
``sqrt(lambda^2) < lambda_tol``, which is off on an iteration solved at
the loose tolerance (the first of each ramp step). For every iteration of
the main ramp this prints the step, the iteration, y, y_new, |g_new|,
theta * g_min, sqrt(lambda^2) and which test fired, for each package, then
each package's Newton counts per step.

Neither package changes: both are copied into ``build/newton_trace/`` with
one print added after the stopping tests, and each side runs in its own
process from there. Run from the repository root:

    JAX_PLATFORMS=cpu python tools/trace_newton_stops.py [case]

``--port-only`` traces the port alone (no JAX needed) and ``--card`` runs
it on the card, for a wide Model:

    python3 tools/trace_newton_stops.py thirty_two_fields --port-only --card
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "newton_trace")

PRINTS = {
    "mgbtpu": ("            stopped = stop_inexact | stop_exact\n",
               '            jax.debug.print("TRACE {k} {y} {yn} {gn} {tg} {si}'
               ' {a} {b}", k=k, y=Y.hi(y), yn=Y.hi(yn), gn=G.norm(gn), '
               'tg=theta * gmin, si=sqrt_inc, a=stop_exact, b=stop_inexact)\n'),
    "mgbtpu_torch": ("            stop_exact = ymin <= yn and gn_norm >= "
                     "theta * gmin\n",
                     '            print(f"TRACE {k} {y!r} {yn!r} {gn_norm!r} '
                     '{theta * gmin!r} {sqrt_inc!r} {stop_exact} '
                     '{stop_inexact}")\n'),
}

RUN = """
import sys
sys.path[:0] = [{out!r}, {tests!r}]
sys.path.append({root!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import mgbtpu, mgbtpu_torch
import test_torch_model as T
pkg = mgbtpu if {side!r} == "mgbtpu" else mgbtpu_torch
assert pkg.__file__.startswith({out!r})
m, kw, _ = getattr(T, {case!r})(pkg)
sol = m.solve(**kw)
print("ITS", np.asarray(sol.SOL_main["its"])[-1].tolist())
"""


RUN_MODEL = """
import sys
sys.path[:0] = [{out!r}]
sys.path.append({root!r})
import numpy as np
if {side!r} == "mgbtpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import mgbtpu as pkg
    kw = {{}}
else:
    import mgbtpu_torch as pkg
    kw = {{}} if {card!r} else dict(device="cpu")
assert pkg.__file__.startswith({out!r})
import port_models
mg = pkg.amg(pkg.fem1d(nodes=np.linspace(-1.0, 1.0, 5)))
n = dict(sixteen_fields=16, thirty_two_fields=32).get({case!r})
if {side!r} == "mgbtpu" and n:
    c = port_models.field_coefficients(n)
    m, _ = port_models.n_fields(pkg, mg, 1, [float(np.linalg.norm(c))])
else:
    m, _ = port_models.MODELS[{case!r}](pkg, mg, **kw)
sol = m.solve(**port_models.SOLVE)
print("ITS", np.asarray(sol.SOL_main["its"]).sum(axis=0).tolist())
"""
WIDE_MODELS = ("seventeen_constraints", "sixteen_fields", "thirty_two_fields")


def copy_with_print(side):
    dst = os.path.join(OUT, side)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, side), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "solver", "newton.py")
    anchor, line = PRINTS[side]
    src = open(path).read()
    if src.count(anchor) != 1:
        raise SystemExit(f"{side}: the stopping test moved; update PRINTS")
    # the print goes after the statement (the port's on the line after it)
    open(path, "w").write(src.replace(anchor, anchor + line))


def trace(side, case, card=False):
    run = RUN_MODEL if case in WIDE_MODELS else RUN
    code = run.format(out=OUT, tests=os.path.join(ROOT, "tests"), root=ROOT,
                      side=side, case=case, card=card)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT)
    if out.returncode:
        raise SystemExit(out.stderr[-3000:])
    rows, its, step = [], None, -1
    for ln in out.stdout.splitlines():
        if ln.startswith("TRACE "):
            f = ln.split()[1:]
            step += f[0] == "0"
            rows.append((step, *f))
        elif ln.startswith("ITS "):
            its = ln[4:]
    return rows, its


def main(argv):
    flags = {a for a in argv[1:] if a.startswith("--")}
    names = [a for a in argv[1:] if not a.startswith("--")]
    case = names[0] if names else "equality_reaction"
    sides = ("mgbtpu_torch",) if "--port-only" in flags else tuple(PRINTS)
    for side in sides:
        copy_with_print(side)
    print("side step it y y_new |g_new| theta*g_min sqrt(lambda^2) "
          "stop_exact stop_inexact")
    for side in sides:
        rows, its = trace(side, case, card="--card" in flags)
        for r in rows:
            print(side, *r)
        print(f"{side} Newton its per main ramp step: {its}")


if __name__ == "__main__":
    main(sys.argv)

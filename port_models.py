"""The Model DSL problems that the port's checks solve (``chip_smoke.py`` and
the tests; no part of either package), each written once as a function of
the package that builds it (``mgbtpu_torch``, or the JAX package where a
parity test or a reference record needs the same description):
``build(pkg, mg, **model_kw)`` returns the model, before ``solve``, and its
constraints by name.

- ``torsion``: ``examples/model_dsl.py``'s elastoplastic torsion (u
  continuous with Dirichlet 0, s broken from 0.5, s >= |grad u|^2, s <= 1,
  min 0.5 s + 4 u): nD = 4, a cone nz = 3 and a linear block nc = 1.
- ``five_constraints``: u continuous with Dirichlet data x_0, s broken with
  no start (phase I runs), s >= |grad u| (p = 1) and u <= 2 + c for
  c = 0..3, min s + 0.5 u: a table of five pieces.
- ``three_fields``: u, v, w continuous with Dirichlet 0, s broken from 1,
  s >= |(grad u, grad v, grad w)|^2, min 0.5 s + u + 0.5 v - 0.25 w: one
  cone of nz = 7 over nD = 10 rows, past K2's limits (K6's runtime-width
  cone).
"""
from __future__ import annotations

SOLVE = dict(tol=1e-6)      # the solve options of every problem here


def torsion(pkg, mg, **model_kw):
    m = pkg.Model(mg, **model_kw)
    u = m.variable("u")
    s = m.variable("s", start=0.5)
    eq = m.dirichlet(u, 0.0)
    cone = m.epigraph(s, u.grad(), p=2.0)
    lin = m.constrain(1.0 - 1.0 * s >= 0.0)
    m.minimize(0.5 * s + 4.0 * u)
    return m, dict(eq=eq, cone=cone, lin=lin)


def five_constraints(pkg, mg, n_bounds=4, **model_kw):
    m = pkg.Model(mg, **model_kw)
    u = m.variable("u")
    s = m.variable("s")
    eq = m.dirichlet(u, lambda x: x[0])
    cone = m.epigraph(s, u.grad(), p=1.0)
    out = dict(eq=eq, cone=cone)
    for c in range(n_bounds):
        out[f"u<={2 + c}"] = m.constrain(u <= 2.0 + c)
    m.minimize(s + 0.5 * u)
    return m, out


def seventeen_constraints(pkg, mg, **model_kw):
    return five_constraints(pkg, mg, n_bounds=16, **model_kw)


def three_fields(pkg, mg, **model_kw):
    m = pkg.Model(mg, **model_kw)
    u, v, w = (m.variable(n) for n in ("u", "v", "w"))
    s = m.variable("s", start=1.0)
    for f in (u, v, w):
        m.dirichlet(f, 0.0)
    cone = m.epigraph(s, u.grad() + v.grad() + w.grad(), p=2.0)
    m.minimize(0.5 * s + 1.0 * u + 0.5 * v - 0.25 * w)
    return m, dict(cone=cone)


def field_coefficients(n):
    return [(-1.0) ** i / (i + 1) for i in range(n)]


def n_fields(pkg, mg, n, coefficients=None, **model_kw):
    c = field_coefficients(n) if coefficients is None else coefficients
    m = pkg.Model(mg, **model_kw)
    fs = [m.variable(f"u{i}") for i in range(n)]
    s = m.variable("s", start=1.0)
    grads = fs[0].grad()
    for f in fs:
        m.dirichlet(f, 0.0)
    for f in fs[1:]:
        grads = grads + f.grad()
    cone = m.epigraph(s, grads, p=2.0)
    obj = 0.5 * s
    for ci, f in zip(c, fs):
        obj = obj + ci * f
    m.minimize(obj)
    return m, dict(cone=cone)


def sixteen_fields(pkg, mg, **model_kw):
    return n_fields(pkg, mg, 16, **model_kw)


def thirty_two_fields(pkg, mg, **model_kw):
    return n_fields(pkg, mg, 32, **model_kw)


MODELS = {"torsion": torsion, "five_constraints": five_constraints,
          "three_fields": three_fields,
          "seventeen_constraints": seventeen_constraints,
          "sixteen_fields": sixteen_fields,
          "thirty_two_fields": thirty_two_fields}
# the models past K6's 16-piece, 32-row kernels, each on fem1d's 5 nodes
WIDE_MODELS = ("seventeen_constraints", "sixteen_fields",
               "thirty_two_fields")

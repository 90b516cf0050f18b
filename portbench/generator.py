"""The one traffic generator: a mix's file of parameters -> requests.

A request is the data of one solve on the configuration's mesh: the cost
grid f (m, 2 + dim; columns u, grad u..., s) and the start grid g (m, 2;
columns u, s), whose u column is also the Dirichlet data. The window's
requests are a study of ``study.size`` loads, drawn once from the mix's own
``study.seed``, so that every run does the same work; a run's ``--seed``
draws the order of each pass over the study and the data of its probe, a
request solved once the window has closed, so that every run also checks
fresh data. A mix file holds:

- ``load``: the u column of f, ``base`` + ``amplitude`` * phi(x);
- ``dirichlet``: the u column of g, |x|^2 + ``amplitude`` * phi(x);
- ``slack_start``: the s column of g at every node (100 starts strictly
  feasible; 0 makes `mgb_driver` run phase I first);
- ``study.warmup`` (default 0): the index of the load that set-up solves to
  build the plans, drawn like the study's; an index of ``study.size`` or
  more is a load the window never sends.

phi is a smooth field of ``modes`` products of cosines, wavenumbers up to
``max_wavenumber`` per axis, coefficients and phases drawn from the
request's seed, scaled to |phi| <= 1. The gradient columns of f are 0 and
its s column 1, as in the package defaults.
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def _rng(seed: int, index: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, index, stream])


def smooth_field(x: np.ndarray, spec: dict, rng: np.random.Generator):
    """sum_j a_j prod_d cos(pi k_jd (x_d + 1) / 2 + theta_jd) / modes."""
    modes, kmax = int(spec["modes"]), int(spec["max_wavenumber"])
    d = x.shape[1]
    a = rng.uniform(-1.0, 1.0, modes)
    k = rng.integers(0, kmax + 1, (modes, d))
    theta = rng.uniform(0.0, 2 * np.pi, (modes, d))
    out = np.zeros(len(x))
    for j in range(modes):
        term = np.full(len(x), a[j])
        for b in range(d):
            term *= np.cos(np.pi * k[j, b] * (x[:, b] + 1.0) / 2 + theta[j, b])
        out += term
    return out / modes


class Mix:
    """The requests of one mix on the nodes x (m, dim) of a configuration,
    for a run with seed ``seed``."""

    PROBE = -1

    def __init__(self, spec: dict, x: np.ndarray, seed: int):
        self.spec = spec
        self.x = np.asarray(x, dtype=np.float64)
        self.seed = int(seed)
        self.size = int(spec["study"]["size"])
        self.warmup = int(spec["study"].get("warmup", 0))

    def order(self, n_pass: int):
        """The study's loads in the order of pass ``n_pass``."""
        return np.random.default_rng(
            [self.seed % 2 ** 64, n_pass, 2]).permutation(self.size)

    def request(self, index: int):
        """(f, g) of study load ``index`` (past the study: a load drawn the
        same way that the window never sends), or of the run's probe
        (``Mix.PROBE``)."""
        if index == self.PROBE:
            seed, index, stream = self.seed, 0, 2
        else:
            seed, stream = self.spec["study"]["seed"], 0
        x, spec = self.x, self.spec
        m, d = x.shape
        load, bc = spec["load"], spec["dirichlet"]
        f = np.zeros((m, d + 2))
        f[:, 0] = load["base"] + load["amplitude"] * smooth_field(
            x, load, _rng(seed, index, stream))
        f[:, -1] = 1.0
        g = np.empty((m, 2))
        g[:, 0] = (x * x).sum(axis=1) + bc["amplitude"] * smooth_field(
            x, bc, _rng(seed, index, stream + 1))
        g[:, 1] = float(spec["slack_start"])
        return f, g

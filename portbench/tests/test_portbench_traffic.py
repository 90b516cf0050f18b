"""The one generator: the window's study is the same for every seed, its
pass orders and the probe depend on the seed alone."""
import numpy as np
import pytest

from portbench import generator
from portbench.reference import hex_qk

X = hex_qk.build({"level": 2, "reference": {"dim": 3, "order": 3}}).x
SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3]
MIXES = ["solve_stream", "phase1_stream"]


def _u(fg):
    f, g = fg
    return np.concatenate([f[:, 0], g[:, 0]])


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    spec = generator.load_mix(name)
    for seed in SEEDS:
        a, b = generator.Mix(spec, X, seed), generator.Mix(spec, X, seed)
        for i in [a.PROBE] + list(range(a.size)):
            fa, ga = a.request(i)
            fb, gb = b.request(i)
            assert np.array_equal(fa, fb) and np.array_equal(ga, gb)
        for p in range(3):
            assert np.array_equal(a.order(p), b.order(p))


@pytest.mark.parametrize("name", MIXES)
def test_study_fixed_probe_and_order_from_the_seed(name):
    spec = generator.load_mix(name)
    mixes = [generator.Mix(spec, X, seed) for seed in SEEDS]
    study = [[_u(m.request(i)) for i in range(m.size)] for m in mixes]
    for other in study[1:]:
        for a, b in zip(study[0], other):
            assert np.array_equal(a, b)
    for i in range(len(study[0])):
        for j in range(i):
            assert not np.allclose(study[0][i], study[0][j])
    probe = [_u(m.request(m.PROBE)) for m in mixes]
    for i in range(len(probe)):
        assert not any(np.allclose(probe[i], s) for s in study[0])
        for j in range(i):
            assert not np.allclose(probe[i], probe[j])
    orders = [tuple(m.order(p)) for m in mixes for p in range(4)]
    assert all(sorted(o) == list(range(mixes[0].size)) for o in orders)
    assert len(set(orders)) > 1


@pytest.mark.parametrize("name", MIXES)
def test_requests_around_the_defaults(name):
    spec = generator.load_mix(name)
    mix = generator.Mix(spec, X, 2 ** 31 + 1)
    amp = spec["load"]["amplitude"]
    for i in [mix.PROBE] + list(range(mix.size)):
        f, g = mix.request(i)
        assert f.shape == (len(X), 5) and g.shape == (len(X), 2)
        assert np.all(np.abs(f[:, 0] - spec["load"]["base"]) <= amp)
        assert np.all(f[:, 1:4] == 0) and np.all(f[:, 4] == 1)
        assert np.all(np.abs(g[:, 0] - (X * X).sum(1))
                      <= spec["dirichlet"]["amplitude"])
        assert np.all(g[:, 1] == spec["slack_start"])


def test_warmup_load_from_the_mix():
    """Set-up's load is the study's first unless the mix names another;
    one past the study is drawn alike, the same for every seed, and is
    none of the loads the window sends."""
    spec = generator.load_mix("solve_stream")
    assert generator.Mix(spec, X, 3).warmup == 0
    past = dict(spec, study=dict(spec["study"], warmup=spec["study"]["size"]))
    mixes = [generator.Mix(past, X, seed) for seed in SEEDS]
    warm = [_u(m.request(m.warmup)) for m in mixes]
    assert all(np.array_equal(warm[0], w) for w in warm[1:])
    m = mixes[0]
    assert not any(np.allclose(warm[0], _u(m.request(i)))
                   for i in range(m.size))
    f, _ = m.request(m.warmup)
    assert np.all(np.abs(f[:, 0] - spec["load"]["base"])
                  <= spec["load"]["amplitude"])

"""PyTorch port, K6 ``node_barrier``'s instance choice on the CPU: every
piece table that the port's constructors build (each zoo problem's set,
``assemble``'s p-Laplace cone, ``parabolic_solve``'s pair, and
``convex_linear``/``convex_piecewise``/``intersect`` of the zoo's pieces)
has a kernel instance in barrier and phase-I form, within the kernel's
limits; a table outside them is refused with ValueError on the CPU as on
the card. Also the ctypes mirror's layout check and the ptxas report's
parser, on made-up library answers. The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""
import ctypes

import numpy as np
import pytest
import torch

import mgbtpu_torch as mt
import mgbtpu_torch.solver.parabolic as P
from mgbtpu_torch.kernels import _build
from mgbtpu_torch.kernels.node_barrier import (LAYOUT, LINEAR, LINEAR_ANY,
                                               POWER, Piece, _Table,
                                               check_layout, instance,
                                               instance_code, instance_name,
                                               node_barrier)

torch.set_num_threads(1)
ZOO = ["p_harmonic", "norton_hoff", "rof", "two_sided_obstacle",
       "elastoplastic_torsion", "minimal_surface"]


@pytest.fixture(scope="module")
def mg():
    return mt.amg(mt.subdivide(mt.fem2d_P2(), 1))


def _forms(Q, nD, nu):
    """(mode, ny, co, box) of the barrier and the phase-I form of Q over nD
    rows and nu solution components."""
    for mode in (0, 1, 2):
        yield mode, nD, None, False
        yield mode, nD + 1 + nu, nD + 1, True


def _holds(Q, nD, nu, templated=True):
    for mode, ny, co, box in _forms(Q, nD, nu):
        inst = instance(Q.pieces, mode, ny, co, box)
        assert inst.mode == mode and inst.form == (2 if box else 0)
        assert len(inst.codes) == len(Q.pieces)
        if templated:      # the constructors' shapes have their own instance
            assert LINEAR_ANY not in inst.codes, str(inst)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_tables_have_instances(mg, name):
    prob = getattr(mt.zoo, name)(mg, device="cpu")
    M = prob.M[0]
    _holds(prob.Q, len(M.D_fine), M.nu)


@pytest.mark.parametrize("p", [1.0, 1.5, 2.0])
def test_p_laplace_cone_has_instances(mg, p):
    """``assemble``'s default cone: K2 takes its barrier, K6 its phase I."""
    prob = mt.assemble(mg, p=p, device="cpu")
    M = prob.M[0]
    nD = len(M.D_fine)
    _holds(prob.Q, nD, M.nu)
    spec = {1.0: 2, 1.5: 0, 2.0: 1}[p]
    assert instance(prob.Q.pieces, 2, nD + 1 + M.nu, nD + 1,
                    True).codes == (3 + spec,)


@pytest.mark.parametrize("p", [1.0, 1.5])
def test_parabolic_pair_has_instances(mg, p):
    """parabolic_solve's pair over its 5 rows, 9 in phase I."""
    Q = mt.intersect(
        mg, mt.convex_euclidian_power(mg, idx=P.parabolic_idx1(2), p=2.0),
        mt.convex_euclidian_power(mg, idx=P.parabolic_idx2(2), p=p))
    _holds(Q, 5, 3)
    assert instance(Q.pieces, 2, 9, 6, True).codes == (1, 3 + (p == 1.0) * 2)


def test_combinations_of_the_zoo_pieces_have_instances(mg):
    """convex_linear on its own and at its widest, convex_piecewise and
    intersect of the zoo's pieces up to the 4 the kernel takes."""
    lone = {n: getattr(mt.zoo, n)(mg, device="cpu").Q
            for n in ("p_harmonic", "minimal_surface")}
    obstacle = mt.zoo.two_sided_obstacle(mg, device="cpu").Q
    x = mg.geometry.xflat()
    n = x.shape[0]
    box = mt.convex_linear(mg, idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
                           b=lambda _: np.array([0.1, 1.0]))
    widest = mt.convex_linear(mg, idx=(0, 1, 2, 3, 4),
                              A_grid=np.ones((n, 20)),
                              b_grid=np.ones((n, 4)))
    _holds(box, 4, 2)
    _holds(widest, 7, 3, templated=False)
    assert instance(widest.pieces, 2, 7).codes == (LINEAR_ANY,)
    both = mt.intersect(mg, lone["p_harmonic"], lone["minimal_surface"])
    _holds(both, 7, 3)
    four = mt.convex_piecewise(
        (lone["p_harmonic"], lone["minimal_surface"], box, widest),
        select_grid=np.ones((n, 4)), mg=mg)
    _holds(four, 8, 3, templated=False)
    pieces_of = mt.intersect(mg, box, mt.convex_euclidian_power(
        mg, idx=(1, 2, 3), p=2.0))
    _holds(pieces_of, 4, 2)
    assert [instance_name(c) for c in
            instance(obstacle.pieces, 2, 4).codes] == ["power<3, 1>",
                                                        "linear<2, 1>"]


def _cone(idx, spec=1, offset=0):
    return Piece(POWER, tuple(idx), len(idx), spec, offset)


@pytest.mark.parametrize("pieces,mode,ny,co,box,what", [
    ((_cone((0, 1)),) * 5, 2, 4, None, False, "5 pieces"),
    ((), 2, 4, None, False, "0 pieces"),
    ((_cone((0, 1)),), 2, 13, None, False, "rows exceed"),
    ((_cone((0, 1, 2, 3, 4, 5)),), 2, 8, None, False, "outside the kernel"),
    ((_cone((0, 1), spec=3),), 0, 4, None, False, "outside the kernel"),
    ((Piece(LINEAR, (0,), 5),), 1, 4, None, False, "outside the kernel"),
    ((Piece(LINEAR, (0, 1, 2, 3, 4, 5), 1),), 1, 8, None, False,
     "outside the kernel"),
    ((_cone((0, 4)),), 1, 4, None, False, "idx"),
    ((_cone((0, 3)),), 1, 5, 4, True, "idx"),       # row 3 is the slack
    ((_cone((0, 1)),), 3, 4, None, False, "mode 3"),
    ((_cone((0, 1)),), 2, 4, None, True, "cobarrier form"),
    ((_cone((0, 1)),), 2, 4, 3, False, "cobarrier width"),
    ((_cone((0, 1)),), 2, 4, 4, True, "component row"),
])
def test_tables_outside_the_limits_are_refused(pieces, mode, ny, co, box,
                                               what):
    with pytest.raises(ValueError, match=what):
        instance(pieces, mode, ny, co, box)


def test_the_wrapper_refuses_them_on_the_cpu():
    """The plain version is the kernel's stand-in on the CPU: it takes the
    tables the kernel takes, no more."""
    m = 6

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float64)

    wide = _cone((0, 1, 2, 3, 4, 5))
    with pytest.raises(ValueError, match="outside the kernel"):
        node_barrier(0, ones(m, 6), (wide,),
                     (ones(m, 36), ones(m, 6), ones(m), ones(m)), None,
                     ones(m), ones(m, 6))
    with pytest.raises(ValueError, match="rows exceed"):
        node_barrier(0, ones(m, 13), (_cone((0, 1)),),
                     (ones(m, 4), ones(m, 2), ones(m), ones(m)), None,
                     ones(m), ones(m, 13))


def test_instance_codes_and_names():
    names = {instance_name(instance_code(POWER, nz, nz, s))
             for nz in range(2, 6) for s in range(3)}
    assert len(names) == 12 and "power<5, 0>" in names
    assert instance_name(instance_code(LINEAR, 1, 1, 0)) == "linear<1, 1>"
    assert instance_name(instance_code(LINEAR, 2, 1, 0)) == "linear<2, 1>"
    assert instance_code(LINEAR, 3, 2, 0) == LINEAR_ANY
    assert instance_code(POWER, 3, 2, 0) == -1        # ni != nz
    inst = instance((_cone((1, 2, 3)), Piece(LINEAR, (0,), 2)), 2, 7, 5,
                    True)
    assert str(inst) == ("node_barrier_kernel<mode 2, cobarrier + box> "
                         "[power<3, 1>, linear<2, 1>]")


def _library(size=None, offsets=None):
    """Made-up exported entries of the C library: the mirror's own answers
    unless given."""
    layout = [v for _, v in LAYOUT]
    size = ctypes.sizeof(_Table) if size is None else size
    offsets = layout if offsets is None else offsets
    return (lambda: size, lambda f: offsets[f] if f < len(offsets) else -1)


def test_layout_check_accepts_the_mirror():
    check_layout(*_library())
    assert ctypes.sizeof(_Table) == 4 * 72 + 7 * 8 + 8 + 5 * 4 + 4


@pytest.mark.parametrize("bad", ["size"] + [label for label, _ in LAYOUT])
def test_layout_check_refuses_a_mismatch(bad):
    """A C struct one field longer or shorter than its mirror, in its size
    or at any of the offsets checked, raises at load, before any
    launch."""
    layout = [v for _, v in LAYOUT]
    if bad == "size":
        kw = dict(size=ctypes.sizeof(_Table) - 8)
    else:
        f = [label for label, _ in LAYOUT].index(bad)
        kw = dict(offsets=layout[:f] + [layout[f] - 8] + layout[f + 1:])
    with pytest.raises(RuntimeError, match=f"its ctypes mirror.*{bad}"):
        check_layout(*_library(**kw))


def test_ptxas_report_parser():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z19node_barrier_kernelILi2ELi1EEv8NBKTable' for 'sm_90a'
ptxas info    : Function properties for _Z19node_barrier_kernelILi2ELi1EEv8NBKTable
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 584 bytes cmem[0]
ptxas info    : Function properties for __internal_accurate_pow
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""
    info = _build.parse_ptxas(text)
    assert info["_Z19node_barrier_kernelILi2ELi1EEv8NBKTable"] == dict(
        registers=168, stack=0, spill_stores=0, spill_loads=0)
    assert info["__internal_accurate_pow"]["stack"] == 16
    assert "registers" not in info["__internal_accurate_pow"]

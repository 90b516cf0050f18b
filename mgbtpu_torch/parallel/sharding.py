"""Multi-device solves (torch port of ``mgbtpu/parallel/sharding.py``).

One process drives every shard, as JAX's single controller drives a mesh:
the host-stepped t-ramp, the Newton loop and the CG loop stay one loop, and
each level operator runs one kernel launch per shard on that shard's
device. The rule is JAX's ``node_sharding``: an element or node axis
shards into contiguous equal ranges, one a device, when its size divides
by the mesh size; a level whose axis does not divide runs whole on the
first device, with nothing copied per shard. The level coefficient
vectors (n_J,) and the dense Newton systems live on the first device, and
s and the CG vectors are broadcast from there. What a level sums over its
elements or nodes (f0, the adjoint's and the Gram products' column sums,
the Gram diagonal, the dense assembly, the ND solve's separator updates)
is summed once on the first device, from each shard's per-node or
per-slot pieces gathered in shard order, in the order one device sums it:
a mesh gives the bits of one device (``tests/test_torch_sharding.py``).

Usage:
    mesh = make_mesh()                              # every card
    mesh = make_mesh(devices=["cuda:0"] * 4)        # 4 shards on one card
    mesh = make_mesh(devices=["cpu"] * 8)           # 8 shards on the CPU
    sol = mgb_solve(prob, mesh=mesh)

``TRANSFERS`` counts the cross-shard traffic: every piece gathered to the
first device and every broadcast, with their bytes (a transfer counts
whether or not its source and destination are the same device, so a mesh
of repeated devices counts what a mesh of distinct cards would move).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# cross-shard traffic: "gathers" (a shard's piece moved to the first
# device, one each), "broadcasts" (a tensor sent to every shard, one each),
# "bytes" (all of it), "largest" (the largest single tensor moved)
TRANSFERS = {"gathers": 0, "broadcasts": 0, "bytes": 0, "largest": 0}


def reset_transfers():
    for k in TRANSFERS:
        TRANSFERS[k] = 0


def _count(kind, t, copies):
    TRANSFERS[kind] += copies
    TRANSFERS["bytes"] += copies * t.numel() * t.element_size()
    TRANSFERS["largest"] = max(TRANSFERS["largest"],
                               t.numel() * t.element_size())


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of torch devices, one a shard; a device may repeat."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def broadcast(self, t, copy=False):
        """t (on the first device) on every shard's device: read-only (no
        copy where the device is t's own), or with ``copy`` a copy each
        shard may write."""
        _count("broadcasts", t, 1)
        return [t.to(d, copy=copy) for d in self.devices]

    def gather(self, t, device):
        """A shard's piece t moved to ``device`` (the first device, or a
        device of the ND tree)."""
        _count("gathers", t, 1)
        return t.to(device)


def make_mesh(n_devices=None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every card,
    ``torch.cuda.device_count()``; raises without one, there is no CPU
    fallback), its first ``n_devices`` when given.

    ``devices`` may repeat a device, as in ``["cpu"] * 8`` or
    ``["cuda:0"] * 4``: one process then stands in for several devices,
    as XLA's forced host device count does for the JAX package's tests.
    The shards run the same code as on a mesh of distinct cards."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "mgbtpu_torch.make_mesh: no CUDA device is available; pass "
                "devices=['cpu'] * n for a mesh of CPU shards")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("mgbtpu_torch.make_mesh: no devices")
    for d in devices:
        if d.type == "cuda" and d.index is None:
            raise ValueError(f"mgbtpu_torch.make_mesh: give the card's "
                             f"index ({d}:0)")
    return Mesh(tuple(devices))


def shard_ranges(mesh: Mesh, size: int):
    """The contiguous equal ranges [lo, hi) of an axis of ``size`` over the
    mesh, one a device; None when the size does not divide (the axis stays
    whole on the first device)."""
    n = mesh.size
    if size % n:
        return None
    k = size // n
    return [(d * k, (d + 1) * k) for d in range(n)]


def node_sharding(mesh: Mesh, shape, shard_sizes):
    """The axis of an array of ``shape`` that shards, as JAX's
    ``node_sharding`` picks it: the first whose size is in
    ``shard_sizes`` (node count, element count) and divides by the mesh
    size; None when none does (the array stays whole)."""
    for ax, sz in enumerate(shape):
        if sz in shard_sizes and sz % mesh.size == 0:
            return ax
    return None

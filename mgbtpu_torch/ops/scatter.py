"""Deterministic scatter-add.

``index_add_`` on a CUDA tensor accumulates with atomics, in an order that
changes from run to run; ``index_put_(accumulate=True)`` on CUDA sorts the
indices first and sums each run of equal indices in a fixed order. On the
CPU ``index_add_`` is sequential (and so is the reference's scatter-add).
"""
from __future__ import annotations

import torch


def scatter_add(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """out[idx[i]] += vals[i] in place, same bits on every run; returns out."""
    if out.is_cuda:
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)

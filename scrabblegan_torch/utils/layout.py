"""The memory layout that the down-block pool (kernels/pool.py), the blocks
(ops/blocks.py) and the non-local block (ops/attention.py) keep: they take
their input's layout and hand it on. It is not in ops/: the pool's module
is imported by an exported program's loader, which takes no model code
(train/export.py)."""

from __future__ import annotations

import torch


def memory_format(t: torch.Tensor) -> torch.memory_format:
    """channels_last for a channels_last tensor that is not also
    NCHW-contiguous, else contiguous_format: a tensor that is both (one
    channel, or one pixel) counts as NCHW."""
    if not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format

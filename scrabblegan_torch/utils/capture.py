"""What every CUDA graph capture of the port shares: the capture lock and the
kernels' launch counters kept exact under replay.

- `CAPTURE_LOCK` is held for the length of a capture (train/graphs.py,
  models/forward_graphs.py); a device round trip from another thread (the
  stall watchdog's probe) takes it first, since a device-wide
  synchronisation during a capture would invalidate it.
- The hand-written kernels count their launches (`kernels/attention.py`,
  the attention's also by width, `kernels/fused_block.py` and
  `kernels/pool.py`). A capture launches nothing, so the counts it added
  are taken back (`add_counts(counts, -1)`) and added again on every
  replay (`add_counts(counts)`).
"""

from __future__ import annotations

import threading

from scrabblegan_torch.kernels import attention, fused_block, pool

CAPTURE_LOCK = threading.Lock()
# the kernels' counters (module, attribute), kept exact under replay
COUNTERS = ((attention, "launches"), (attention, "bwd_launches"),
            (attention, "bwd_dout_copies"), (fused_block, "launches"),
            (pool, "launches"), (pool, "bwd_launches"))


def counter_values() -> tuple[int, ...]:
    """COUNTERS' values, then the attention launches by width
    (`attention.WIDTH_COUNTERS`)."""
    return (tuple(getattr(module, name) for module, name in COUNTERS)
            + tuple(attention.width_launches[key] for key in attention.WIDTH_COUNTERS))


def add_counts(counts: tuple[int, ...], sign: int = 1) -> None:
    for (module, name), n in zip(COUNTERS, counts):
        setattr(module, name, getattr(module, name) + sign * n)
    for key, n in zip(attention.WIDTH_COUNTERS, counts[len(COUNTERS):]):
        attention.width_launches[key] += sign * n

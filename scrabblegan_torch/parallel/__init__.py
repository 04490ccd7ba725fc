"""Data, FSDP, tensor and FSDP x tensor parallelism over torch.distributed.

Port of scrabblegan_tpu/parallel/: `mesh.py` (the DeviceMesh, collectives,
the global batch reductions), `fsdp.py` (the FSDP rule and the layout of a
sharded state), `tp.py` (the TP rule and the split layers), `fsdp_tp.py`
(the composed rule) and `selftest.py` (parity against one process).
"""

from __future__ import annotations


def prepare_state(cfg, mesh, state):
    """Lay a whole train state out for `cfg`'s mode on `mesh`, in place:
    each rank keeps its pieces (nothing is cut under plain DP)."""
    from scrabblegan_torch.parallel.fsdp import shard_state, state_layout

    return shard_state(state, state_layout(cfg, mesh, state.models))

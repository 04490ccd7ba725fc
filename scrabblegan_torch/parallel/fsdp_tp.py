"""FSDP x TP: the two layouts composed on the 2-D ('data', 'model') mesh.

Port of scrabblegan_tpu/parallel/fsdp_tp.py. The rule (`leaf_fsdp_tp_spec`)
is JAX's, on each leaf's flax shape: the TP rule first (the output axis on
'model', parallel/tp.py), then the FSDP rule on the largest still-free
divisible axis ('data', parallel/fsdp.py); when no free axis divides, the
output axis is co-sharded by ('model', 'data') if it divides by both sizes'
product. The step runs both mechanisms at once: a layer whose output axis
is on 'model' computes its channels (parallel/tp.py), and every parameter
is gathered at use over the axes it is split on, its gradient
reduce-scattered back (parallel/fsdp.py `gathered_params`); Adam's moments
and G's EMA follow their parameter's layout.
"""

from __future__ import annotations


def leaf_fsdp_tp_spec(mesh_shape, shape, tp_min_size: int = 4096,
                      fsdp_min_size: int = 65536) -> tuple:
    """JAX's `leaf_fsdp_tp_sharding` as a spec tuple (() when replicated)."""
    mp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1)
    size = 1
    for d in shape:
        size *= d
    spec = [None] * len(shape)
    tp_applied = mp > 1 and size >= tp_min_size and len(shape) >= 2 and shape[-1] % mp == 0
    if tp_applied:
        spec[-1] = "model"
    if dp > 1 and size >= fsdp_min_size and shape:
        best_dim, best = None, 0
        for i, d in enumerate(shape):
            if spec[i] is None and d % dp == 0 and d > best:
                best_dim, best = i, d
        if best_dim is not None:
            spec[best_dim] = "data"
        elif tp_applied and shape[-1] % (mp * dp) == 0:
            spec[-1] = ("model", "data")
    if all(s is None for s in spec):
        return ()
    return tuple(spec)

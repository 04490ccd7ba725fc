"""scrabblegan_torch — the PyTorch and CUDA port of scrabblegan_tpu.

The JAX package `scrabblegan_tpu` is the reference: every module here names
its JAX counterpart, loads the same weights (converted from the flax variable
trees by `scrabblegan_torch.convert`) and is held to the JAX output by the
`tests/test_torch_*.py` parity tests. This package imports `torch` and never
JAX, flax, optax or orbax; it reuses only the JAX package's framework-free host
modules (`config`, `data.loaders.encode_word`, `utils.viz`).

Layout is NCHW throughout. The attention core's forward and backward, the
TPU kernels on the serving path and the train step, run as hand-written CUDA
kernels for sm_90a (`csrc/attention_fwd.cu`, `csrc/attention_bwd.cu`, bound
in `kernels/attention.py`).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch.device for `device`; raises when CUDA is asked for and absent.

    There is no fallback: a request for "cuda" on a machine without a usable
    card is an error, never a silent switch to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            "is False")
    return dev

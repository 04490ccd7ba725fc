"""scrabblegan_torch — the PyTorch and CUDA port of scrabblegan_tpu.

The JAX package `scrabblegan_tpu` is the reference: every module here names
its JAX counterpart, loads the same weights (converted from the flax variable
trees by `scrabblegan_torch.convert`) and is held to the JAX output by the
`tests/test_torch_*.py` parity tests. This package imports `torch` and
nothing of JAX, flax, optax, orbax or the JAX package itself, nor cv2,
PIL, matplotlib or imageio: what it needs of the JAX package's
framework-free host modules it holds as its own copies (`config`, `data`,
`train.metrics`, `eval`, `utils`), with PNG IO and resizing on numpy and
zlib (`data.images`).

Layout is NCHW throughout. The three TPU kernels run as hand-written CUDA
kernels for sm_90a: the attention core's forward and backward
(`csrc/attention_fwd.cu`, `csrc/attention_bwd.cu`, bound in
`kernels/attention.py`) and the whole non-local block of the 'fused'
attention dataflow (`csrc/fused_block_fwd.cu`, `kernels/fused_block.py`).
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

"""Dropout whose masks come from a key on the device.

Port of flax `nn.Dropout` as the BiLSTM recognizer uses it: in train mode a
call keeps each element with probability 1 - rate and scales the kept ones
by 1 / (1 - rate), `where(keep, x / keep_prob, 0)`; in eval mode it is the
identity. JAX draws the masks from the step's `rng_drop`, one key for both
R passes of a step (scrabblegan_tpu/train/step.py).

The keep mask here is a counter-based hash of three integers, computed on
the device with int64 tensor arithmetic: the stream's key (a 0-d int64
tensor), the call's number in the stream and the element's flat index. So:
- a stream is opened for a block with `dropout_stream(key)`; the dropout
  calls inside are numbered 0, 1, 2, ... Opening it again with the same key
  restarts it: both R passes of a step read one stream, as JAX's single
  `rng_drop` does (same shapes give the same masks; other shapes draw from
  the same start);
- the step's key mixes the train state's dropout seed with its device step
  counter (`step_key`), so every step draws new masks, a CUDA graph replay
  draws what the same eager step draws (nothing is read on the host, nothing
  is kept between calls), and a run resumed from a checkpoint, which holds
  the seed and the step, continues the same stream;
- the masks are the same on the CPU and on a card, bit for bit.
A call in train mode with no stream open raises, as flax asks for a
'dropout' rng. The hash does not give `jax.random`'s bits: a test compares
the two frameworks with dropout replaced by the identity on both sides.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Iterator

import torch

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B  # the multiplier of a well-mixing 32-bit integer hash (< 2^27: no int64 overflow)
_ODD = 0x2545F491
_STREAM: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "scrabblegan_torch_dropout_stream", default=None)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of x in [0, 2^32), elementwise, in int64."""
    for _ in range(2):
        x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def step_key(seed: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """The key of one step's stream from a seed and a step counter (0-d int64
    tensors on one device)."""
    return _mix(_mix(seed & _M32) ^ (step & _M32))


@contextlib.contextmanager
def dropout_stream(key: torch.Tensor, shard: int = 0) -> Iterator[None]:
    """Number the dropout calls inside the block 0, 1, 2, ... under `key`.
    `shard` is the data rank of a parallel step: its masks are its slice of
    the global batch's."""
    token = _STREAM.set([key, 0, shard])
    try:
        yield
    finally:
        _STREAM.reset(token)


def keep_mask(key: torch.Tensor, call: int, shape: tuple[int, ...],
              keep_prob: float, shard: int = 0) -> torch.Tensor:
    """The boolean keep mask of call number `call` of the stream `key`; of a
    batch-major tensor that is data rank `shard`'s slice of a global batch,
    the global mask's rows (flat indices offset by shard * its size)."""
    n = 1
    for d in shape:
        n *= d
    if (shard + 1) * n >= 2 ** 32:
        raise ValueError(f"dropout over {(shard + 1) * n} elements: the hash indexes 2^32")
    k = _mix((key + call * _ODD) & _M32)
    idx = torch.arange(shard * n, (shard + 1) * n, dtype=torch.int64, device=key.device)
    bits = _mix(_mix((idx * _ODD + k) & _M32) ^ k)
    return ((bits >> 8) < int(keep_prob * 2 ** 24)).reshape(shape)


def dropout(x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    """flax `nn.Dropout(rate)(x, deterministic)` on the open stream."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    stream = _STREAM.get()
    if stream is None:
        raise RuntimeError("dropout in train mode needs a stream: call the network inside "
                           "`dropout_stream(key)`")
    key, call, shard = stream
    stream[1] += 1
    keep_prob = 1.0 - rate
    mask = keep_mask(key, call, tuple(x.shape), keep_prob, shard)
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))

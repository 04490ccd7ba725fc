"""Analytic work counts: the FLOPs of a G forward and of a train step, and the
attention core's FLOPs and bytes.

The FLOPs are those of the plain reference (perfbench/reference), counted by
`torch.utils.flop_counter.FlopCounterMode` while it runs on the meta device at
the cell's shapes: a step's count is its forward and backward. They depend on
the architecture and the shapes alone, never on how the program computes
them, so a kernel that fuses or replaces operations cannot move its own
yardstick. The attention core's count comes from its shapes: 2 Q K (Ca + Cv)
FLOPs (scores and the value product) and each operand and the output read or
written once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import nets
from perfbench.reference.step import Trainer


def _meta(leaves: list[tuple[str, tuple[int, ...]]]) -> dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, device="meta") for name, shape in leaves}


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def generator_flops(leaves: list[tuple[str, tuple[int, ...]]], batch: int, length: int,
                    style: bool = False, width: int = 160) -> int:
    """FLOPs of one eval-mode G forward over (batch, length) labels; with
    `style`, z is encoded from (batch, 1, 32, width) style images."""
    t = _meta(leaves)
    labels = torch.zeros(batch, length, dtype=torch.long, device="meta")
    if style:
        imgs = torch.zeros(batch, 1, 32, width, device="meta")
        return _count(lambda: nets.generator(nets.Net(t), labels, style_imgs=imgs,
                                             style_net=nets.Net(t)))
    z = torch.zeros(batch, 128, device="meta")
    return _count(lambda: nets.generator(nets.Net(t), labels, z))


def train_step_flops(cfg_file: dict, leaves: dict[str, list[tuple[str, tuple[int, ...]]]],
                     batch: int, length: int, style_width: int = 160) -> int:
    """FLOPs of one train step's forwards and its backward at batch `batch`,
    word length `length` (the padded canvas's in padded mode)."""
    trainer = Trainer(cfg_file, {net: _meta(v) for net, v in leaves.items()}, 0, device="meta")
    m = "meta"
    data = {"real_imgs": torch.zeros(batch, 32, 16 * length, 1, dtype=torch.uint8, device=m),
            "style_imgs": torch.zeros(batch, 32, style_width, 1, dtype=torch.uint8, device=m),
            "real_labels": torch.zeros(batch, length, dtype=torch.long, device=m),
            "fake_labels": torch.zeros(batch, length, dtype=torch.long, device=m),
            "real_lengths": torch.full((batch,), length, dtype=torch.long, device=m),
            "fake_lengths": torch.full((batch,), length, dtype=torch.long, device=m)}

    def step():
        total, _ = trainer.losses(data, {net: {} for net in "gdrw"})
        total.backward()
    return _count(step)


def attention_core(batch: int, queries: int, keys: int, ca: int = 8, cv: int = 32,
                   itemsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of the attention core: theta (B, Ca, Q), phi (B, Ca, K),
    g (B, Cv, K) read once, out (B, Cv, Q) written once."""
    flops = 2 * batch * queries * keys * (ca + cv)
    nbytes = batch * (ca * queries + ca * keys + cv * keys + cv * queries) * itemsize
    return flops, nbytes

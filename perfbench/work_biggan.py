"""Analytic work counts of the BigGAN cell: the FLOPs of a train step, and
the attention kernels' least time.

The step's FLOPs are those of the plain reference (perfbench/reference/
biggan.py), counted by `torch.utils.flop_counter.FlopCounterMode` while it
runs on the meta device at the cell's shapes: G's pass, D's three passes and
the backward of their losses. They depend on the architecture and the shapes
alone, never on how the program computes them (a recomputation included).

The attention core at (Ca, Cv) over a batch of B, Q queries and K keys:
- forward: 2 Q K (Ca + Cv) FLOPs an image and theta, phi, g read and the
  output written once (perfbench/work.py `attention_core`);
- backward: 2 Q K (3 Ca + 2 Cv) FLOPs an image (the scores again, dtheta
  and dphi; dA and dg), each operand (theta, phi, g, dout) read and each
  gradient written once.
Its least time is max(FLOPs / the bf16 peak, bytes / HBM bandwidth), each
launch on its own.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import peaks, work
from perfbench.reference.biggan import Trainer


def _meta(leaves: list[tuple[str, tuple[int, ...]]]) -> dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, device="meta") for name, shape in leaves}


def train_step_flops(cfg_file: dict, leaves: dict[str, list[tuple[str, tuple[int, ...]]]],
                     batch: int) -> int:
    """FLOPs of one train step's forwards and its backward at batch `batch`."""
    trainer = Trainer(cfg_file, {net: _meta(v) for net, v in leaves.items()}, device="meta")
    r = cfg_file["biggan"]["resolution"]
    m = "meta"
    data = {"real_imgs": torch.zeros(batch, r, r, 3, dtype=torch.uint8, device=m),
            "real_labels": torch.zeros(batch, dtype=torch.long, device=m),
            "fake_labels": torch.zeros(batch, dtype=torch.long, device=m),
            "z": torch.zeros(batch, cfg_file["biggan"]["dim_z"], device=m)}
    counter = FlopCounterMode(display=False)
    with counter:
        total, _ = trainer.losses(data, {"g": {}, "d": {}})
        total.backward()
    return int(counter.get_total_flops())


def attention_bwd(batch: int, queries: int, keys: int, ca: int, cv: int,
                  itemsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of the attention core's backward (see the text)."""
    flops = 2 * batch * queries * keys * (3 * ca + 2 * cv)
    nbytes = batch * 2 * (ca * queries + ca * keys + cv * keys) * itemsize
    nbytes += batch * cv * queries * itemsize  # dout, read
    return flops, nbytes


def attention_shapes(cfg_file: dict, batch: int) -> dict[str, tuple[int, int, int, int, int]]:
    """{'<Ca>x<Cv>': (B, Q, K, Ca, Cv)} of G's and D's non-local blocks: G's
    after the up-block whose output is `g_attention` wide, D's after the
    down-block whose output is `d_attention` wide; C/8 and C/2 of its
    channels, Q its pixels, K a quarter of them (the pooled keys)."""
    spec = cfg_file["biggan"]
    g_mult, d_mult, res = spec["g_mult"], spec["d_mult"], spec["resolution"]
    bottom = res >> (len(g_mult) - 1)
    g_c = next(g_mult[i + 1] for i in range(len(g_mult) - 1)
               if bottom << (i + 1) == spec["g_attention"]) * spec["ch"]
    d_c = next(d_mult[i] for i in range(len(d_mult) - 1)
               if res >> (i + 1) == spec["d_attention"]) * spec["ch"]
    out = {}
    for width, c in ((spec["g_attention"], g_c), (spec["d_attention"], d_c)):
        q = width * width
        out[f"{c // 8}x{c // 2}"] = (batch, q, q // 4, c // 8, c // 2)
    return out


def attention_roof_s(cfg_file: dict, batch: int, launches: dict[str, float]) -> dict:
    """The least seconds a step of the forward and the backward kernels,
    over `launches` ({'attention.launches.<Ca>x<Cv>' or
    'attention.bwd_launches.<Ca>x<Cv>': launches a step}); {} without
    counts."""
    if not launches:
        return {}
    fwd = bwd = 0.0
    for width, (b, q, k, ca, cv) in attention_shapes(cfg_file, batch).items():
        for kind, (flops, nbytes) in (("launches", work.attention_core(b, q, k, ca, cv)),
                                      ("bwd_launches", attention_bwd(b, q, k, ca, cv))):
            roof = max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
            n = launches.get(f"attention.{kind}.{width}", 0.0)
            if kind == "launches":
                fwd += n * roof
            else:
                bwd += n * roof
    return {"attn_fwd_roof_s_per_unit": fwd, "attn_bwd_roof_s_per_unit": bwd}

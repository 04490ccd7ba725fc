"""The serving bundle: G's forward as a `torch.export` program.

Port of scrabblegan_tpu/train/export.py, which serialises the jitted
generator forward to StableHLO with its parameters baked in. Here the
eval-mode generator is traced by `torch.export` at a fixed (batch, length)
and z source, its parameters and statistics held in the program:

- the bundle is <out>/generator.pt2 (`torch.export.save`) and meta.json
  with JAX's keys (batch_size, length, z_source, latent_dim, img_hw) and
  the device, attention dataflow and compute dtype it was exported for;
- the program takes JAX's contract: int32 labels (B, L) and float32 noise z
  (B, latent_dim) or style images (B, H, W, C), and returns float32 images
  (B, H, 16 L, C) in [-1, 1], NHWC as JAX's generator;
- the attention runs through the registered ops (kernels/attention.py,
  kernels/fused_block.py), so a bundle exported for a card launches the
  hand-written kernel when it runs: the core under 'nhwc1', 'nhwc' and
  'packed', the fused block under 'fused'; the style encoder's down-block
  pools run through kernels/pool.py's op likewise. A CPU bundle holds the
  same ops, which run their plain versions there.

`load_exported_generator` needs no model code: it imports torch and the
modules that register the ops, and nothing of `scrabblegan_torch.models` or
`scrabblegan_torch.ops`.
"""

from __future__ import annotations

import json
import os

import torch

PROGRAM_FILE = "generator.pt2"
META_FILE = "meta.json"


class _Served(torch.nn.Module):
    """G behind JAX's serving contract."""

    def __init__(self, generator: torch.nn.Module, z_source: str):
        super().__init__()
        self.generator = generator
        self.z_source = z_source

    def forward(self, labels: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        labels = labels.long()
        if self.z_source == "style":
            images = self.generator(labels, style_imgs=latent.permute(0, 3, 1, 2))
        else:
            images = self.generator(labels, latent)
        return images.float().permute(0, 2, 3, 1)


def export_generator(out_dir: str, generator: torch.nn.Module, batch_size: int, length: int,
                     z_source: str, latent_dim: int = 128, img_hw=(32, 160),
                     dataflow: str = "") -> str:
    """Trace `generator` (its weights as they are; put in eval mode) at
    (batch_size, length) on its own device, under attention `dataflow`
    ('' for $SCRABBLEGAN_ATTN_DATAFLOW or 'nhwc1'), and write the bundle to
    `out_dir`; returns `out_dir`."""
    from scrabblegan_torch.ops.attention import NonLocalBlock, resolve_dataflow

    dataflow = resolve_dataflow(dataflow)
    device = next(generator.parameters()).device
    channels = generator.to_image.weight.shape[0]
    labels = torch.zeros((batch_size, length), dtype=torch.int32, device=device)
    latent = (torch.zeros((batch_size, *img_hw, channels), device=device) if z_source == "style"
              else torch.zeros((batch_size, latent_dim), device=device))
    blocks = [m for m in generator.modules() if isinstance(m, NonLocalBlock)]
    saved = [b.dataflow for b in blocks]
    generator.eval()
    try:
        for block in blocks:
            block.dataflow = dataflow
        with torch.no_grad():
            program = torch.export.export(_Served(generator, z_source), (labels, latent))
    finally:
        for block, flow in zip(blocks, saved):
            block.dataflow = flow
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM_FILE))
    meta = {"batch_size": batch_size, "length": length, "z_source": z_source,
            "latent_dim": latent_dim, "img_hw": list(img_hw), "device": device.type,
            "dataflow": dataflow, "dtype": str(generator.dtype).removeprefix("torch.")}
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_exported_generator(bundle_dir: str):
    """Returns (callable(labels, latent) -> images, meta dict). The callable
    takes numpy arrays or tensors in the bundle's contract and returns a
    float32 tensor on the bundle's device; it needs no model code."""
    import scrabblegan_torch.kernels.attention  # noqa: F401  (registers the ops)
    import scrabblegan_torch.kernels.fused_block  # noqa: F401
    import scrabblegan_torch.kernels.pool  # noqa: F401

    with open(os.path.join(bundle_dir, META_FILE)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(bundle_dir, PROGRAM_FILE)).module()
    device = torch.device(meta["device"])

    def call(labels, latent) -> torch.Tensor:
        labels = torch.as_tensor(labels).to(device, torch.int32)
        latent = torch.as_tensor(latent).to(device, torch.float32)
        with torch.no_grad():
            return program(labels, latent)

    return call, meta

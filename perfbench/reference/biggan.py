"""BigGAN at 128 x 128 in plain PyTorch: the reference of the BigGAN cell.

G, D, the hinge losses and one train step as functions of a dict of tensors
keyed by the program's `state_dict` names, so that the same seeded tensors
feed both sides. It imports nothing but torch and the ScrabbleGAN
reference's plain helpers (perfbench/reference/nets.py: spectral norm with
one power iteration a call, batch norm, the precisions); the attention is a
plain softmax over float32 scores. The mathematics is the authors' code
(BigGAN-PyTorch `BigGAN.py`, `layers.py`) at the widths of the
configuration file's "biggan" section:

- G: e = embed(y) (plain); z split into len(g_mult) chunks; h =
  SNLinear(z_0) viewed (g_mult[0] ch, 4, 4); per block, with c = [e, z_i]:
  h' = conv3x3(up2(relu(cbn1(h, c)))), h' = conv3x3(relu(cbn2(h', c))),
  out = h' + conv1x1(up2(h)), CBN(x, c) = BN(x) (1 + SNLinear(c)) +
  SNLinear(c); the non-local block after the block `g_attention` wide; BN,
  relu, conv3x3 to RGB, tanh.
- D: per block h = conv3x3(relu(conv3x3(act(x)))), avg-pooled; act the
  identity in the first block; the skip conv1x1 after the pool in the first
  block, before it elsewhere, the identity in the last (no pool); the
  non-local block after the block `d_attention` wide; relu, sum over the
  pixels, SNLinear(h) + <SNEmbed(y), h> in float32.
- The step: G on (fake labels, z) (its statistics kept); D on real (kept),
  on G's images detached and, frozen, on G's images; one backward of
  mean(relu(1 - D(x, y))) + mean(relu(1 + D(G(z), y_f))) - mean(D(G(z),
  y_f)); lean Adam (beta_1 = 0) on G and D at their rates; G's EMA.

`checkpoint=True` recomputes each block in the backward
(`torch.utils.checkpoint`, the same arithmetic), so that a step at batch
256 in float32 fits on one card beside nothing else; a block's statistics
are proposed by its first pass only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from perfbench.reference import nets
from perfbench.reference.step import is_buffer, to_images

REFERENCE_PREC = {"g": "float32", "d": "float32"}


class _Net(nets.Net):
    """nets.Net with BigGAN's pieces; `recompute` keeps the statistics of a
    checkpointed block's recomputation out of the record."""

    recompute = False

    def _propose(self, name: str, value: torch.Tensor) -> None:
        if not self.recompute:
            super()._propose(name, value)

    def cbn(self, pre: str, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.batch_norm(pre, x, affine=False)
        gain = 1.0 + self.dense(pre + ".gamma", cond)[:, :, None, None]
        return h * gain + self.dense(pre + ".beta", cond)[:, :, None, None]

    def up_block(self, pre: str, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.cbn(pre + ".cbn1", x, cond))
        h = self.conv(pre + ".upconv", F.interpolate(h, scale_factor=2, mode="nearest"))
        h = self.conv(pre + ".conv", torch.relu(self.cbn(pre + ".cbn2", h, cond)))
        return h + self.conv(pre + ".skip", F.interpolate(x, scale_factor=2, mode="nearest"))

    def down_block(self, pre: str, x: torch.Tensor, first: bool, last: bool) -> torch.Tensor:
        h = self.conv(pre + ".conv1", x if first else torch.relu(x))
        h = self.conv(pre + ".conv2", torch.relu(h))
        if last:
            return h + x.to(h.dtype)
        if first:
            return F.avg_pool2d(h, 2) + self.conv(pre + ".skip", F.avg_pool2d(x, 2))
        return F.avg_pool2d(h, 2) + F.avg_pool2d(self.conv(pre + ".skip", x), 2)

    def head_dense(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        w = self.weight(pre)
        return F.linear(x, w, self.t.get(pre + ".bias"))


def _run(net: _Net, ckpt: bool, fn, *args):
    """fn(*args), recomputed in the backward when `ckpt`; the recomputation
    proposes no statistics."""
    if not ckpt:
        return fn(*args)

    return _checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                       context_fn=lambda: (_Recomputing(net, False), _Recomputing(net, True)))


class _Recomputing:
    """Sets `net.recompute` for the block, then restores it."""

    def __init__(self, net: _Net, value: bool):
        self.net, self.value = net, value

    def __enter__(self):
        self.before, self.net.recompute = self.net.recompute, self.value

    def __exit__(self, *exc):
        self.net.recompute = self.before


def generator(net: _Net, spec: dict, y: torch.Tensor, z: torch.Tensor,
              ckpt: bool = False) -> torch.Tensor:
    """(y (B,), z (B, dim_z)) -> images (B, 3, R, R) in [-1, 1], the net's
    compute dtype."""
    mult = spec["g_mult"]
    chunk = spec["dim_z"] // len(mult)
    bottom = spec["resolution"] >> (len(mult) - 1)
    zs = z.float().split(chunk, dim=1)
    e = net.t["shared.weight"][y]
    h = net.dense("linear", zs[0]).view(z.shape[0], -1, bottom, bottom)
    for i in range(len(mult) - 1):
        cond = torch.cat([e, zs[i + 1]], dim=1)
        h = _run(net, ckpt, lambda h, c, i=i: net.up_block(f"blocks.{i}", h, c), h, cond)
        if bottom << (i + 1) == spec["g_attention"]:
            h = _run(net, ckpt, lambda h: net.attention("attn", h), h)
    h = torch.relu(net.batch_norm("out_bn", h))
    return torch.tanh(net.conv("out_conv", h))


def discriminator(net: _Net, spec: dict, x: torch.Tensor, y: torch.Tensor,
                  ckpt: bool = False) -> torch.Tensor:
    """(x (B, 3, R, R), y (B,)) -> logits (B,) float32."""
    n = len(spec["d_mult"])
    h = x.to(net.dt)
    for i in range(n):
        h = _run(net, ckpt, lambda h, i=i: net.down_block(f"blocks.{i}", h, i == 0, i == n - 1),
                 h)
        if i < n - 1 and spec["resolution"] >> (i + 1) == spec["d_attention"]:
            h = _run(net, ckpt, lambda h: net.attention("attn", h), h)
    h = torch.relu(h).float().sum(dim=(2, 3))
    proj = (net.weight("embed")[y] * h).sum(dim=1)
    return net.head_dense("linear", h)[:, 0] + proj


class Trainer:
    """G and D and their optimizers, stepped in place; as the ScrabbleGAN
    reference's Trainer (perfbench/reference/step.py) takes its arguments:
    `weights` {'g', 'd': {name: tensor}}, `cfg` the configuration file,
    `prec` {'g', 'd': precision}, `start` {'nu', 'ema', 'step'}. `rows`
    keeps the first rows of each batch (a fault of the controls)."""

    def __init__(self, cfg: dict, weights: dict, prec: dict | None = None, device=None,
                 start: dict | None = None, checkpoint: bool = False):
        o, s = cfg["optimizer"], cfg["shared"]
        for key, want in (("loss_fn", "hinge"), ("disc_iters", 1), ("beta_1", 0.0),
                          ("lr_schedule", "constant")):
            if o[key] != want:
                raise ValueError(f"the BigGAN reference covers optimizer.{key}={want!r} only")
        if s["use_recognizer"] or s["use_style_promoter"]:
            raise ValueError("the BigGAN reference trains G and D alone")
        self.spec = cfg["biggan"]
        self.momentum = self.spec["bn_momentum"]
        self.lr = {"g": o["g_lr"], "d": o["d_lr"]}
        self.b2, self.ema_decay = o["beta_2"], o["g_ema_decay"]
        self.prec = dict(REFERENCE_PREC if prec is None else prec)
        self.device, self.ckpt = device, checkpoint
        self.t, self.params = {}, {}
        for net in "gd":
            self.t[net] = {k: v.detach().clone().float() for k, v in weights[net].items()}
            self.params[net] = [k for k in self.t[net] if not is_buffer(k, self.t[net])]
            for k in self.params[net]:
                self.t[net][k].requires_grad_(True)
        start = start or {}
        nu = start.get("nu")
        self.nu = {net: {k: (torch.zeros_like(self.t[net][k]) if nu is None
                             else nu[net][k].detach().clone().float().to(self.t[net][k].device))
                         for k in self.params[net]} for net in "gd"}
        ema = start.get("ema") or self.t["g"]
        self.ema = ({k: ema[k].detach().clone().float().to(self.t["g"][k].device)
                     for k in self.params["g"]} if self.ema_decay > 0 else None)
        self.step_count = int(start.get("step", 0))
        self.grad1 = None
        self.first = None  # the first step's G images and D logits (real, fake)

    def _net(self, net: str, tensors: dict, record: dict | None) -> _Net:
        return _Net(tensors, self.prec[net], True, record, self.momentum)

    def losses(self, batch: dict, records: dict) -> tuple[torch.Tensor, dict]:
        dev = self.device
        real = to_images(batch["real_imgs"], dev)
        y_real = torch.as_tensor(batch["real_labels"]).to(dev).long()
        y_fake = torch.as_tensor(batch["fake_labels"]).to(dev).long()
        z = torch.as_tensor(batch["z"]).to(dev).float()
        spec, ck = self.spec, self.ckpt
        gen = generator(self._net("g", self.t["g"], records["g"]), spec, y_fake, z, ck).float()
        d_real = discriminator(self._net("d", self.t["d"], records["d"]), spec, real, y_real, ck)
        d_fake = discriminator(self._net("d", self.t["d"], None), spec, gen.detach(), y_fake, ck)
        frozen = {k: v.detach() for k, v in self.t["d"].items()}
        d_for_g = discriminator(self._net("d", frozen, None), spec, gen, y_fake, ck)
        d_loss = torch.relu(1.0 - d_real) + torch.relu(1.0 + d_fake)
        g_loss = -d_for_g
        means = {"d_loss": d_loss.mean(), "g_loss": g_loss.mean()}
        self.last = {"gen": gen.detach(), "d_real": d_real.detach(), "d_fake": d_fake.detach()}
        return means["d_loss"] + means["g_loss"], means

    def step(self, batch: dict) -> dict:
        records = {"g": {}, "d": {}}
        total, means = self.losses(batch, records)
        total.backward()
        with torch.no_grad():
            for net, record in records.items():
                for name, value in record.items():
                    self.t[net][name].copy_(value)
            if self.grad1 is None:
                self.grad1 = {net: {k: (torch.zeros_like(t[k]) if t[k].grad is None
                                        else t[k].grad.detach().clone())
                                    for k in self.params[net]} for net, t in self.t.items()}
                self.first = self.last
            correction = 1.0 - self.b2 ** (self.step_count + 1)
            for net in "gd":
                for k in self.params[net]:
                    p = self.t[net][k]
                    g = torch.zeros_like(p) if p.grad is None else p.grad
                    nu = self.nu[net][k]
                    nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
                    p.add_(g / (torch.sqrt(nu / correction) + 1e-8), alpha=-self.lr[net])
                    p.grad = None
            if self.ema is not None:
                for k, e in self.ema.items():
                    e.mul_(self.ema_decay).add_(self.t["g"][k], alpha=1.0 - self.ema_decay)
        self.step_count += 1
        return {k: float(v.detach()) for k, v in means.items()}


def run_steps(cfg: dict, weights: dict, batches: list, prec: dict | None = None, device=None,
              start: dict | None = None, checkpoint: bool = False) -> dict:
    """The reference's readings over `batches`, as perfbench/reference/step.py
    `run_steps` gives them: 'losses', 'grad1', 'params', 'ema'; and 'first',
    the first step's G images and D logits on real and fake images."""
    trainer = Trainer(cfg, weights, prec, device, start, checkpoint)
    losses = [trainer.step(batch) for batch in batches]
    params = {net: {k: trainer.t[net][k].detach() for k in trainer.params[net]}
              for net in trainer.t}
    return {"losses": losses, "grad1": trainer.grad1, "params": params, "ema": trainer.ema,
            "first": trainer.first}


def logit_grads(cfg: dict, weights_d: dict, images: torch.Tensor, labels: torch.Tensor
                ) -> list[dict]:
    """For each image (B, 3, R, R) in [-1, 1] and its label: the gradient of
    D's logit alone with respect to D's parameters, in float32, D's weights
    and statistics as given (a pass of one image: D has no batch
    statistics, so a sample's hinge term in a batch has this gradient)."""
    t = {k: v.detach().clone().float() for k, v in weights_d.items()}
    params = [k for k in t if not is_buffer(k, t)]
    for k in params:
        t[k].requires_grad_(True)
    out = []
    for x, y in zip(images, labels):
        logit = discriminator(_Net(t, "float32", True, None), cfg["biggan"], x[None].float(),
                              y[None])
        grads = torch.autograd.grad(logit.sum(), [t[k] for k in params], allow_unused=True)
        out.append({k: (torch.zeros_like(t[k]) if g is None else g.detach())
                    for k, g in zip(params, grads)})
    return out

"""The four-network train step in plain PyTorch: the reference of the train cells.

One step, as the configuration trains it (ScrabbleGAN, hinge losses, the
'adversarial' style mode, no gradient balancing, one G update a step):

1. images from uint8 to [-1, 1];
2. G on the fake labels with z from the style images (its statistics kept);
   D on real images (kept), on G's images detached, and frozen on G's images
   for G's loss; W on the style images (kept), on G's images detached, and
   frozen on G's images; R frozen on G's images (the CTC steers G) and on
   real images (kept); the BiLSTM R's two passes read one dropout stream;
3. one backward of d + s + r_real + (g_adv + r_fake), the means over the
   batch; the kept statistics committed; lean Adam (beta_1 = 0: u = g /
   (sqrt(nu_hat) + 1e-8)) on each network at its rate; G's EMA.

`run_steps` takes the weights (and, to follow a run from a later step, the
second moments, G's EMA and the step number) and the batches from the caller
and returns what the benchmark compares: each step's losses, the first
step's gradients and the parameters and EMA after the last step.
"""

from __future__ import annotations

import torch

from perfbench.reference import nets
from perfbench.reference.ctc import ctc_loss

REFERENCE_PREC = {"g": "float32", "style": "float32", "d": "float32", "w": "float32",
                  "r": "float32", "lstm": "float32"}
LOSS_NAMES = ("d_loss", "s_loss", "r_loss_real", "r_loss_fake", "g_loss", "g_loss_final")


def is_buffer(name: str, tensors: dict) -> bool:
    """Statistics, not parameters: BN's running moments, spectral norm's u and
    sigma (a sigma whose layer has a u)."""
    if name.endswith((".running_mean", ".running_var", ".u")):
        return True
    return name.endswith(".sigma") and name[: -len(".sigma")] + ".u" in tensors


def to_images(x: torch.Tensor, device) -> torch.Tensor:
    """(B, H, W, 1) uint8 -> (B, 1, H, W) float32 in [-1, 1]."""
    x = torch.as_tensor(x).to(device).permute(0, 3, 1, 2)
    return ((x.float() - 127.5) / 127.5).contiguous()


class Trainer:
    """The state of the four networks and their optimizers, stepped in place.

    `weights` maps 'g', 'd', 'r', 'w' to {name: float32 tensor}; they are
    copied. `cfg` is the configuration file's sections (plain dicts).
    `start` ({'nu': {net: {name: tensor}}, 'ema': {name: tensor} or None,
    'step': int}) continues a run from a later step; by default the moments
    are zero, the EMA is G's parameters and the step is 0."""

    def __init__(self, cfg: dict, weights: dict, dropout_seed: int,
                 prec: dict | None = None, device=None, start: dict | None = None):
        o, s, p = cfg["optimizer"], cfg["shared"], cfg["parallel"]
        for key, want in (("loss_fn", "hinge"), ("style_loss_mode", "adversarial"),
                          ("apply_gradient_balance", False), ("disc_iters", 1),
                          ("beta_1", 0.0), ("lr_schedule", "constant"), ("rmsprop", False)):
            if o[key] != want:
                raise ValueError(f"the reference step covers optimizer.{key}={want!r} only")
        if s["z_source"] != "style":
            raise ValueError("the reference step covers shared.z_source='style' only")
        self.padded = p["shape_mode"] == "padded"
        self.my_disc, self.my_rec = bool(s["my_disc"]), bool(s["my_rec"])
        self.lr = {"g": o["g_lr"], "d": o["d_lr"], "r": o["r_lr"], "w": o["w_lr"]}
        self.b2 = o["beta_2"]
        self.ema_decay = o["g_ema_decay"]
        self.prec = dict(REFERENCE_PREC if prec is None else prec)
        self.dropout_seed = dropout_seed
        self.device = device
        self.t = {}
        self.params = {}
        for net, tensors in weights.items():
            self.t[net] = {k: v.detach().clone().float() for k, v in tensors.items()}
            self.params[net] = [k for k in self.t[net] if not is_buffer(k, self.t[net])]
            for k in self.params[net]:
                self.t[net][k].requires_grad_(True)
        start = start or {}
        nu = start.get("nu")
        self.nu = {net: {k: (torch.zeros_like(self.t[net][k]) if nu is None
                             else nu[net][k].detach().clone().float().to(self.t[net][k].device))
                         for k in self.params[net]} for net in self.t}
        ema = start.get("ema") or self.t["g"]
        self.ema = ({k: ema[k].detach().clone().float().to(self.t["g"][k].device)
                     for k in self.params["g"]} if self.ema_decay > 0 else None)
        self.step_count = int(start.get("step", 0))
        self.grad1 = None  # the first step's gradients, {net: {name: tensor}}

    def _frozen(self, net: str) -> dict:
        return {k: v.detach() for k, v in self.t[net].items()}

    def _d(self, tensors, record, x, mask):
        net = nets.Net(tensors, self.prec["d"], True, record)
        if self.my_disc:
            return nets.dcgan_discriminator(net, x, mask)
        return nets.adversary(net, x, mask)

    def _w(self, tensors, record, x, mask=None):
        return nets.adversary(nets.Net(tensors, self.prec["w"], True, record), x, mask)

    def _r(self, tensors, record, x, key):
        net = nets.Net(tensors, self.prec["r"], True, record)
        if self.my_rec:
            return nets.bilstm_recognizer(net, x, nets.DropoutStream(key), self.prec["lstm"])
        return nets.conv_recognizer(net, x)

    def losses(self, batch: dict, records: dict) -> tuple[torch.Tensor, dict]:
        dev = self.device
        real = to_images(batch["real_imgs"], dev)
        style = to_images(batch["style_imgs"], dev)
        real_labels = torch.as_tensor(batch["real_labels"]).to(dev).long()
        fake_labels = torch.as_tensor(batch["fake_labels"]).to(dev).long()
        bsz = fake_labels.shape[0]
        if self.padded:
            real_len = torch.as_tensor(batch["real_lengths"]).to(dev).long()
            fake_len = torch.as_tensor(batch["fake_lengths"]).to(dev).long()
            cols = torch.arange(real.shape[3] // 8, device=dev)[None, :]
            mask_real = (cols < 2 * real_len[:, None]).float()
            mask_fake = (cols < 2 * fake_len[:, None]).float()
        else:
            real_len = torch.full((bsz,), real_labels.shape[1], device=dev)
            fake_len = torch.full((bsz,), fake_labels.shape[1], device=dev)
            mask_real = mask_fake = None
        g_net = nets.Net(self.t["g"], self.prec["g"], True, records["g"])
        style_net = nets.Net(self.t["g"], self.prec["style"], True, records["g"])
        gen = nets.generator(g_net, fake_labels, lengths=fake_len if self.padded else None,
                             style_imgs=style, style_net=style_net).float()
        gen_sg = gen.detach()
        d_real = self._d(self.t["d"], records["d"], real, mask_real)
        d_fake_for_d = self._d(self.t["d"], None, gen_sg, mask_fake)
        d_fake_for_g = self._d(self._frozen("d"), None, gen, mask_fake)
        s_style = self._w(self.t["w"], records["w"], style)
        s_gen_for_w = self._w(self.t["w"], None, gen_sg, mask_fake)
        s_fake_for_g = self._w(self._frozen("w"), None, gen, mask_fake)
        key = nets.dropout_key(self.dropout_seed, self.step_count, dev) if self.my_rec else None
        r_fake = ctc_loss(self._r(self._frozen("r"), None, gen, key), fake_labels,
                          4 * fake_len - 1, fake_len)
        r_real = ctc_loss(self._r(self.t["r"], records["r"], real, key), real_labels,
                          4 * real_len - 1, real_len)
        d_loss = torch.relu(1.0 - d_real) + torch.relu(1.0 + d_fake_for_d)
        s_loss = torch.relu(1.0 - s_style) + torch.relu(1.0 + s_gen_for_w)
        g_loss = -d_fake_for_g - s_fake_for_g
        g_final = g_loss + r_fake
        means = {"d_loss": d_loss.mean(), "s_loss": s_loss.mean(), "r_loss_real": r_real.mean(),
                 "r_loss_fake": r_fake.mean(), "g_loss": g_loss.mean(),
                 "g_loss_final": g_final.mean()}
        total = means["d_loss"] + means["s_loss"] + means["r_loss_real"] + means["g_loss_final"]
        return total, means

    def step(self, batch: dict) -> dict:
        """One train step in place; returns the losses (floats)."""
        records = {net: {} for net in "gdrw"}
        total, means = self.losses(batch, records)
        total.backward()
        with torch.no_grad():
            for net, record in records.items():
                for name, value in record.items():
                    self.t[net][name].copy_(value)
            count = self.step_count + 1
            if self.grad1 is None:
                self.grad1 = {net: {k: (torch.zeros_like(t[k]) if t[k].grad is None
                                        else t[k].grad.detach().clone())
                                    for k in self.params[net]} for net, t in self.t.items()}
            for net in self.t:
                correction = 1.0 - self.b2 ** count
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


def run_steps(cfg: dict, weights: dict, batches: list, dropout_seed: int,
              prec: dict | None = None, device=None, start: dict | None = None) -> dict:
    """The reference's readings over `batches` (one step each): 'losses'
    [{name: float}] a step, 'grad1' {net: {name: tensor}} the first step's
    gradients, 'params' {net: {name: tensor}} and 'ema' {name: tensor} after
    the last. `start` as `Trainer` takes it."""
    trainer = Trainer(cfg, weights, dropout_seed, prec, device, start)
    losses = [trainer.step(batch) for batch in batches]
    params = {net: {k: trainer.t[net][k].detach() for k in trainer.params[net]}
              for net in trainer.t}
    return {"losses": losses, "grad1": trainer.grad1, "params": params, "ema": trainer.ema}

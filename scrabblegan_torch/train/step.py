"""The single-backward four-network train step.

Port of scrabblegan_tpu/train/step.py (`make_train_step`). One step:

1. normalises uint8 images on the device, (x - 127.5) / 127.5;
2. runs the forward passes with JAX's gradient routing:
   - D, W and R train on images that carry no gradient to G (`detach()`
     where JAX puts `stop_gradient`);
   - G's gradient flows through D, W and R frozen: their passes run through
     `torch.func.functional_call` with detached parameters;
   - R trains on real images only; the CTC on fake images steers G alone;
3. takes one `backward()` of the summed loss, then the four updates, G's on
   the `disc_iters` cadence with its EMA on the same cadence.

Statistics (BN running stats, spectral norm's u and sigma): every pass reads
them as they stood at the start of the step, as every JAX `apply` reads
`state.*_stats`, and the new ones are written once, after the backward, from
the passes JAX keeps: G's own pass, D on real, W on style images and R on
real (ops/layers.py `record_stats`). R's frozen pass on fake images
normalises by its own batch statistics and discards them.

XLA removes the W pass on IAM images in 'adversarial' mode, where it feeds
nothing; here it is skipped, and likewise the W passes the other two style
modes do not read. Noise z, for z_source='noise', is an argument of the
step; the default style path draws no random numbers (the conv R has no
dropout).

`shared.remat` runs G's own pass under the non-reentrant
`torch.utils.checkpoint`: its activations are recomputed in the backward,
where no statistics record is open, so the recompute proposes nothing and
the statistics are G's first pass's (the power iteration recomputes from
the same stored u).

One body serves every path (`make_step_body`): its inputs are device
tensors, it reads and writes nothing on the host, and it updates the state
in place, the optimizers' counts and moments included (train/optim.py). The
`disc_iters` cadence is a mask on the device: G's parameters, moments, count
and EMA take `torch.where(take_g, new, old)`, bitwise what a skip gives
(JAX's `lax.cond`); at `disc_iters` 1 there is no mask. `make_train_step`
runs the body eagerly, one step a call; `make_chunked_train_step` runs K
steps a call, as CUDA graphs on the card (train/graphs.py) and eagerly on
the CPU. Not ported, raising NotImplementedError: the parallel modes.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from scrabblegan_torch.config import Config
from scrabblegan_torch.models.build import ModelBundle
from scrabblegan_torch.ops.balance import balanced_fanout, gradient_balance
from scrabblegan_torch.ops.ctc import ctc_loss
from scrabblegan_torch.ops.layers import commit_stats, record_stats
from scrabblegan_torch.ops.losses import DISC_LOSS_REGISTRY, GEN_LOSS_REGISTRY
from scrabblegan_torch.train.optim import apply_updates, make_optimizers, update_ema
from scrabblegan_torch.train.state import NETWORKS, TrainState

# The 16 per-step statistics, in the JAX step's order.
METRIC_NAMES = (
    "d_loss", "d_loss_real", "d_loss_fake",
    "r_loss_real", "r_loss_fake", "r_loss_balanced",
    "g_loss", "g_loss_added", "g_loss_balanced", "g_loss_final",
    "alpha", "r_loss_fake_std", "g_loss_std",
    "s_loss", "s_loss_real", "s_loss_fake",
)
STYLE_LOSS_MODES = ("adversarial", "style_vs_iam", "bug_compatible")


def normalize_images(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """(B, H, W, C) uint8 or float32 in [-1, 1] -> (B, C, H, W) float32 on
    `device`; uint8 is normalised there by the host formula."""
    x = torch.as_tensor(x).to(device, non_blocking=True).permute(0, 3, 1, 2)
    if not x.is_floating_point():
        x = (x.float() - 127.5) / 127.5
    return x.float().contiguous()


def _frozen(module: torch.nn.Module) -> Callable:
    """`module` called with its parameters detached: gradients reach its
    inputs and not its parameters. The buffers are the module's own."""
    def call(*args):
        params = {name: p.detach() for name, p in module.named_parameters()}
        return functional_call(module, params, args)
    return call


def stage_batch(batch: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    """A batch's leaves as tensors on `device`, dtypes kept."""
    return {key: torch.as_tensor(value).to(device, non_blocking=True)
            for key, value in batch.items()}


def _check_supported(cfg: Config) -> None:
    if cfg.parallel.fsdp or cfg.parallel.model_parallel > 1:
        raise NotImplementedError("the parallel modes (fsdp, model_parallel) are not "
                                  "ported yet")


def make_step_body(cfg: Config, models: ModelBundle):
    """Returns body(state, inputs, z) -> (16,) float32 metrics on the device.

    `inputs` holds the batch's leaves as device tensors (`stage_batch`), z
    (B, latent_dim) for z_source='noise' likewise. The body takes one step:
    the forwards, one backward, the statistics, the four updates and the EMA,
    all in place, and advances `state.step_t`; it leaves `state.step` to its
    caller."""
    _check_supported(cfg)
    o = cfg.optimizer
    disc_loss_fn = DISC_LOSS_REGISTRY[o.loss_fn]
    gen_loss_fn = GEN_LOSS_REGISTRY[o.loss_fn]
    mode = "bug_compatible" if o.bug_compatible_style_loss else o.style_loss_mode
    if mode not in STYLE_LOSS_MODES:
        raise ValueError(f"unknown style_loss_mode {o.style_loss_mode!r}")
    if o.balance_mode not in ("loss_rescale", "grad_norm"):
        raise ValueError(f"unknown balance_mode {o.balance_mode!r}")
    use_r = cfg.shared.use_recognizer
    use_w = cfg.shared.use_style_promoter
    grad_norm_balance = use_r and o.apply_gradient_balance and o.balance_mode == "grad_norm"
    padded = cfg.parallel.shape_mode == "padded"
    style_z = cfg.shared.z_source == "style"
    remat = cfg.shared.remat
    opts = make_optimizers(cfg)
    G, D, R, W = models.generator, models.discriminator, models.recognizer, models.style_promoter
    device = next(G.parameters()).device

    def g_forward(labels, z, lengths, style_imgs):
        return G(labels, z, lengths, style_imgs=style_imgs).float()

    def metric(v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.detach().float().mean()
        return torch.full((), v, dtype=torch.float32, device=device)  # no host copy

    def forward_losses(inputs: Mapping[str, torch.Tensor], z: torch.Tensor | None):
        real_imgs = normalize_images(inputs["real_imgs"], device)
        style_imgs = normalize_images(inputs["style_imgs"], device)
        real_labels = inputs["real_labels"].long()
        fake_labels = inputs["fake_labels"].long()
        bsz = fake_labels.shape[0]
        if padded:
            real_lengths = inputs["real_lengths"].long()
            fake_lengths = inputs["fake_lengths"].long()
            cols = torch.arange(real_imgs.shape[3] // 8, device=device)[None, :]
            mask_real = (cols < 2 * real_lengths[:, None]).float()
            mask_fake = (cols < 2 * fake_lengths[:, None]).float()
        else:
            real_lengths = torch.full((bsz,), real_labels.shape[1], device=device)
            fake_lengths = torch.full((bsz,), fake_labels.shape[1], device=device)
            mask_real = mask_fake = None

        # G's own pass: its statistics are kept
        if not style_z and z is None:
            raise ValueError("z_source='noise' needs z")
        g_args = (fake_labels, None if style_z else z, fake_lengths if padded else None,
                  style_imgs if style_z else None)
        with record_stats() as g_stats:
            if remat:  # the backward recomputes G's activations, outside any record
                gen_imgs = checkpoint(g_forward, *g_args, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                gen_imgs = g_forward(*g_args)
        if grad_norm_balance:
            gen_for_adv, gen_for_ctc = balanced_fanout(gen_imgs, o.balance_alpha)
        else:
            gen_for_adv = gen_for_ctc = gen_imgs
        gen_sg = gen_imgs.detach()

        # D: on real (statistics kept), on fake for D, on fake for G (frozen)
        with record_stats() as d_stats:
            d_real = D(real_imgs, mask_real)
        d_fake_for_d = D(gen_sg, mask_fake)
        d_fake_for_g = _frozen(D)(gen_for_adv, mask_fake)

        # W: on style images (statistics kept), then the passes the mode reads
        zeros = torch.zeros(bsz, device=device)
        w_stats = {}
        s_style = s_iam = s_gen_for_w = s_fake_for_g = zeros
        if use_w:
            with record_stats() as w_stats:
                s_style = W(style_imgs)
            if mode == "style_vs_iam":
                s_iam = W(real_imgs, mask_real)
                s_fake_for_g = _frozen(W)(gen_for_adv, mask_fake)
            else:
                s_gen_for_w = W(gen_sg, mask_fake)
                if mode == "adversarial":
                    s_fake_for_g = _frozen(W)(gen_for_adv, mask_fake)
                else:  # bug_compatible: G's style term reads W on IAM, a constant
                    with torch.no_grad():
                        s_iam = W(real_imgs, mask_real)

        # R: CTC on fake through frozen R, on real (statistics kept)
        r_stats = {}
        r_fake = r_real = zeros
        if use_r:
            r_fake = ctc_loss(_frozen(R)(gen_for_ctc), fake_labels, 4 * fake_lengths - 1,
                              fake_lengths)
            with record_stats() as r_stats:
                r_logits_real = R(real_imgs)
            r_real = ctc_loss(r_logits_real, real_labels, 4 * real_lengths - 1, real_lengths)

        if mode == "bug_compatible":
            s_neg, s_for_g = s_gen_for_w, s_iam.detach()
        elif mode == "style_vs_iam":
            s_neg, s_for_g = s_iam, s_fake_for_g
        else:
            s_neg, s_for_g = s_gen_for_w, s_fake_for_g

        d_loss, d_loss_real, d_loss_fake = disc_loss_fn(d_real, d_fake_for_d)
        g_loss = gen_loss_fn(d_fake_for_g)
        if use_w:
            s_loss, s_loss_pos, s_loss_neg = disc_loss_fn(s_style, s_neg)
            g_loss = g_loss + gen_loss_fn(s_for_g)
        else:
            s_loss = s_loss_pos = s_loss_neg = zeros

        if grad_norm_balance:  # the balancing lives in balanced_fanout's backward
            g_added = g_balanced = g_final = g_loss + r_fake
            r_balanced = r_fake
            alpha = o.balance_alpha
            r_fake_std = torch.std(r_fake, correction=0)
            g_loss_std = torch.std(g_loss, correction=0)
        elif use_r:
            g_balanced, r_balanced, alpha, r_fake_std, g_loss_std = gradient_balance(
                r_fake, g_loss, alpha=o.balance_alpha)
            g_added = g_loss + r_fake
            g_final = g_balanced if o.apply_gradient_balance else g_added
        else:
            g_balanced = r_balanced = zeros
            alpha, r_fake_std, g_loss_std = 0.0, zeros[0], zeros[0]
            g_added = g_final = g_loss

        total = d_loss.mean() + s_loss.mean() + r_real.mean() + g_final.mean()
        values = (d_loss, d_loss_real, d_loss_fake, r_real, r_fake, r_balanced,
                  g_loss, g_added, g_balanced, g_final, alpha, r_fake_std, g_loss_std,
                  s_loss, s_loss_pos, s_loss_neg)
        metrics = torch.stack([metric(v) for v in values])
        return total, metrics, (g_stats, d_stats, r_stats, w_stats)

    def body(state: TrainState, inputs: Mapping[str, torch.Tensor],
             z: torch.Tensor | None = None) -> torch.Tensor:
        total, metrics, records = forward_losses(inputs, z)
        total.backward()
        for record in records:
            commit_stats(record)
        # JAX's lax.cond on the cadence; its static fast path at disc_iters == 1
        take_g = None if o.disc_iters == 1 else (state.step_t + 1) % o.disc_iters == 0
        for net in NETWORKS:
            params = state.params(net)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            take = take_g if net == "g" else None
            updates, _ = opts[net].update(grads, state.opt_states[net], take)
            apply_updates(params, updates, take)
            for p in params:
                p.grad = None
        if state.g_ema is not None:
            update_ema(state.g_ema, state.params("g"), o.g_ema_decay, take_g)
        state.step_t.add_(1)
        return metrics

    return body


def make_train_step(cfg: Config, models: ModelBundle):
    """Returns step(state, batch, z=None) -> {metric name: 0-d float32 tensor}.

    batch holds numpy arrays or tensors in the JAX package's layout:
      real_imgs    (B, 32, 16 Lr, C) uint8, or float32 in [-1, 1]
      real_labels  (B, Lr) int
      style_imgs   (B, 32, 160, C) uint8 or float32
      fake_labels  (B, Lf) int
    and in 'padded' shape mode real_lengths and fake_lengths (B,), the true
    word lengths. z (B, latent_dim) is required with z_source='noise'. The
    step runs the body eagerly and updates `state` in place: parameters,
    statistics, optimizer states, EMA and step counters."""
    body = make_step_body(cfg, models)
    device = next(models.generator.parameters()).device

    def step(state: TrainState, batch: Mapping, z: torch.Tensor | None = None
             ) -> dict[str, torch.Tensor]:
        state.step_t.fill_(state.step)
        metrics = body(state, stage_batch(batch, device),
                       None if z is None else torch.as_tensor(z).to(device))
        state.step += 1
        return dict(zip(METRIC_NAMES, metrics.unbind()))

    return step


def make_chunked_train_step(cfg: Config, models: ModelBundle):
    """K = the batches' leading size train steps a call: the port of JAX's
    `make_chunked_train_step` (lax.scan over a stacked batch), the same as K
    sequential steps, the cadence on the step counter.

    Returns chunk(state, batches, z=None) -> (16, K) float32 metrics on the
    device, a fresh tensor each call. batches: `make_train_step`'s leaves,
    each stacked with a leading K (numpy, host tensors, pinned for an
    asynchronous copy, or device tensors); z: (K, B, latent_dim) for
    z_source='noise'. On a CUDA device the body runs as CUDA graphs, one a
    batch-shape signature: its first steps run eagerly as the capture's
    warm-up, the next is captured, and every later one replays
    (train/graphs.py); a capture that fails raises. On the CPU it runs
    eagerly. `chunk.graphs` is the `StepGraphs` (None on the CPU)."""
    body = make_step_body(cfg, models)
    device = next(models.generator.parameters()).device
    graphs = None
    if device.type == "cuda":
        from scrabblegan_torch.train.graphs import StepGraphs

        graphs = StepGraphs(body, device)

    def chunk(state: TrainState, batches: Mapping, z=None) -> torch.Tensor:
        batches = {key: torch.as_tensor(value) for key, value in batches.items()}
        z = None if z is None else torch.as_tensor(z)
        k = next(iter(batches.values())).shape[0]
        state.step_t.fill_(state.step)
        if graphs is not None:
            out = graphs(state, batches, z)
        else:
            out = torch.stack([
                body(state, stage_batch({key: v[i] for key, v in batches.items()}, device),
                     None if z is None else z[i].to(device))
                for i in range(k)], dim=1)
        state.step += k
        return out

    chunk.graphs = graphs
    return chunk

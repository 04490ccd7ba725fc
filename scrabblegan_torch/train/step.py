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
step. The BiLSTM R (`shared.my_rec`) has dropout: both of its passes read
one stream, keyed by the state's dropout seed and the device step counter
(ops/dropout.py), as both JAX passes read the step's one `rng_drop`; the
conv R draws no random numbers.

`shared.remat` runs G's own pass under the non-reentrant
`torch.utils.checkpoint`: its activations are recomputed in the backward,
where no statistics record is open, so the recompute proposes nothing and
the statistics are G's first pass's (the power iteration recomputes from
the same stored u).

BigGAN (a `models.biggan.ClassBundle`: G and D alone) takes the same body
with class labels: the batch holds real_labels and fake_labels (B,) and its
z (B, dim_z), which the feed draws; G runs on (fake_labels, z), D on
(images, labels) for real, for fake detached and frozen for G's loss; the
loss is the hinge pair and G and D update as above (`shared.remat`
included). The phases are g.fwd, d.fwd, losses and the same backward,
stats, update and ema; it has no parallel mode.

One body serves every path (`make_step_body`): its inputs are device
tensors, it reads and writes nothing on the host, and it updates the state
in place, the optimizers' counts and moments included (train/optim.py). The
`disc_iters` cadence is a mask on the device: G's parameters, moments, count
and EMA take `torch.where(take_g, new, old)`, bitwise what a skip gives
(JAX's `lax.cond`); at `disc_iters` 1 there is no mask. `make_train_step`
runs the body eagerly, one step a call; `make_chunked_train_step` runs K
steps a call, as CUDA graphs on the card (train/graphs.py) and eagerly on
the CPU.

The body marks its phases (utils/profiling.py `mark`): step.inputs, g.fwd,
d.fwd, w.fwd, r.fwd, ctc, r.fwd, ctc, losses, backward.drw, backward.g
(the gradient's arrival at G's output, a hook on `gen_imgs` set while
marks are recorded), stats, update, ema, step.end. A captured graph keeps
them as timing events that every replay records, so each phase's device
time is read from its mark to the next; eagerly they record only their
order, and only while tracing is on.

With a mesh (`mesh=`, parallel/mesh.py; the state laid out by
`parallel.prepare_state`) the body is one rank's part of the parallel step,
JAX's DP, FSDP (parallel.fsdp), TP (parallel.model_parallel > 1) and
FSDP x TP: each call takes the global batch and z and keeps this rank's
data-axis rows; the networks run on parameters gathered at use
(parallel/fsdp.py) and, for a layer split over the model axis, on this
rank's output channels (parallel/tp.py); every batch reduction is the
global batch's (the BN moments, the loss and metric means, the balance's
stds, parallel/mesh.py) and the BiLSTM's dropout masks are the global
batch's rows; the loss is seeded with 1/D, D the data axis's size, and
the gradients of the parameters not split over the data axis are summed
over it, so that every rank updates its pieces with the single process's
gradient. A parallel chunk runs its K steps eagerly (gloo's collectives
cannot be captured).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from scrabblegan_torch.config import Config
from scrabblegan_torch.models.biggan import ClassBundle
from scrabblegan_torch.models.build import ModelBundle
from scrabblegan_torch.ops.balance import balanced_fanout, gradient_balance
from scrabblegan_torch.ops.ctc import ctc_loss
from scrabblegan_torch.ops.dropout import dropout_stream, step_key
from scrabblegan_torch.ops.layers import commit_stats, record_stats
from scrabblegan_torch.ops.losses import DISC_LOSS_REGISTRY, GEN_LOSS_REGISTRY
from scrabblegan_torch.parallel.fsdp import gathered_params
from scrabblegan_torch.parallel.mesh import (StepContext, all_reduce, current, global_pstd,
                                             local_rows, sum_local_means, use_step)
from scrabblegan_torch.parallel.tp import split_modules
from scrabblegan_torch.train.optim import apply_updates, make_optimizers, update_ema
from scrabblegan_torch.train.state import NETWORKS, TrainState
from scrabblegan_torch.utils.profiling import mark, marking

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


class _Nets:
    """The four networks as a step calls them: `live(net)` trains the
    parameters, `frozen(net)` passes gradients to the inputs only. In one
    process these are the modules themselves; in a parallel step they run
    on the parameters gathered once a step (parallel/fsdp.py)."""

    def __init__(self, models: ModelBundle, gathered: dict | None = None):
        self.modules = dict(zip(NETWORKS, (m for _, m in models.items())))
        self.gathered = gathered or {}

    def live(self, net: str) -> Callable:
        module, params = self.modules[net], self.gathered.get(net)
        if params is None:
            return module
        return lambda *args, **kwargs: functional_call(module, params, args, kwargs)

    def frozen(self, net: str) -> Callable:
        module, params = self.modules[net], self.gathered.get(net)
        if params is None:
            return _frozen(module)
        detached = {name: p.detach() for name, p in params.items()}
        return lambda *args: functional_call(module, detached, args)


def _sum_grads_over_data(state: TrainState, layout) -> None:
    """Sum over the data axis the gradient of every parameter not split
    over it, one all-reduce a network (a split one's arrives summed)."""
    group = layout.mesh.group("data")
    for net in NETWORKS:
        params = [p for p, places in zip(state.params(net), layout.places[net])
                  if not any(name == "data" for _, name in places)]
        if not params:
            continue
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = all_reduce(_flatten_dense_tensors(grads), group)
        for p, g in zip(params, _unflatten_dense_tensors(flat, grads)):
            p.grad = g


def make_step_body(cfg: Config, models: ModelBundle, mesh=None):
    """Returns body(state, inputs, z) -> (16,) float32 metrics on the device.

    `inputs` holds the batch's leaves as device tensors (`stage_batch`), z
    (B, latent_dim) for z_source='noise' likewise; with a `mesh`, this
    rank's rows of them (`local_rows`) and a state laid out by
    `parallel.prepare_state`. The body takes one step: the forwards, one
    backward, the statistics, the four updates and the EMA, all in place,
    and advances `state.step_t`; it leaves `state.step` to its caller."""
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
    my_rec = cfg.shared.my_rec
    grad_norm_balance = use_r and o.apply_gradient_balance and o.balance_mode == "grad_norm"
    padded = cfg.parallel.shape_mode == "padded"
    style_z = cfg.shared.z_source == "style"
    remat = cfg.shared.remat
    opts = make_optimizers(cfg)
    device = next(models.generator.parameters()).device
    class_cond = isinstance(models, ClassBundle)
    if class_cond and mesh is not None:
        raise NotImplementedError("BigGAN's step runs in one process: no parallel mode")

    def g_forward(G, labels, z, lengths=None, style_imgs=None):
        if class_cond:
            return G(labels, z).float()
        return G(labels, z, lengths, style_imgs=style_imgs).float()

    def g_pass(G, *g_args):
        """G's own pass, recomputed in the backward under `shared.remat`."""
        if not remat:
            return g_forward(G, *g_args)
        step_ctx = current()  # re-entered for the recompute, on the backward's thread
        return checkpoint(
            g_forward, G, *g_args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(), use_step(step_ctx)))

    data_rank = 0 if mesh is None else mesh.rank("data")

    def metric(v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.detach().float().mean()
        return torch.full((), v, dtype=torch.float32, device=device)  # no host copy

    def forward_losses(inputs: Mapping[str, torch.Tensor], z: torch.Tensor | None,
                       drop_key: torch.Tensor | None, nets: _Nets):
        G, D, R, W = (nets.live(net) for net in NETWORKS)
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
        mark("g.fwd")
        with record_stats() as g_stats:  # a remat recompute runs outside any record
            gen_imgs = g_pass(G, *g_args)
        if grad_norm_balance:
            gen_for_adv, gen_for_ctc = balanced_fanout(gen_imgs, o.balance_alpha)
        else:
            gen_for_adv = gen_for_ctc = gen_imgs
        gen_sg = gen_imgs.detach()
        if marking():  # the gradient's arrival at G's output splits the backward
            gen_imgs.register_hook(lambda grad: mark("backward.g"))

        # D: on real (statistics kept), on fake for D, on fake for G (frozen)
        mark("d.fwd")
        with record_stats() as d_stats:
            d_real = D(real_imgs, mask_real)
        d_fake_for_d = D(gen_sg, mask_fake)
        d_fake_for_g = nets.frozen("d")(gen_for_adv, mask_fake)

        # W: on style images (statistics kept), then the passes the mode reads
        zeros = torch.zeros(bsz, device=device)
        w_stats = {}
        s_style = s_iam = s_gen_for_w = s_fake_for_g = zeros
        if use_w:
            mark("w.fwd")
            with record_stats() as w_stats:
                s_style = W(style_imgs)
            if mode == "style_vs_iam":
                s_iam = W(real_imgs, mask_real)
                s_fake_for_g = nets.frozen("w")(gen_for_adv, mask_fake)
            else:
                s_gen_for_w = W(gen_sg, mask_fake)
                if mode == "adversarial":
                    s_fake_for_g = nets.frozen("w")(gen_for_adv, mask_fake)
                else:  # bug_compatible: G's style term reads W on IAM, a constant
                    with torch.no_grad():
                        s_iam = W(real_imgs, mask_real)

        # R: CTC on fake through frozen R, on real (statistics kept)
        r_stats = {}
        r_fake = r_real = zeros
        if use_r:
            # the BiLSTM R's passes each restart the step's dropout stream
            stream = ((lambda: dropout_stream(drop_key, data_rank)) if my_rec
                      else contextlib.nullcontext)
            mark("r.fwd")
            with stream():
                r_logits_fake = nets.frozen("r")(gen_for_ctc)
            mark("ctc")
            r_fake = ctc_loss(r_logits_fake, fake_labels, 4 * fake_lengths - 1, fake_lengths)
            mark("r.fwd")
            with record_stats() as r_stats, stream():
                r_logits_real = R(real_imgs)
            mark("ctc")
            r_real = ctc_loss(r_logits_real, real_labels, 4 * real_lengths - 1, real_lengths)

        mark("losses")

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
            r_fake_std = global_pstd(r_fake)
            g_loss_std = global_pstd(g_loss)
        elif use_r:
            g_balanced, r_balanced, alpha, r_fake_std, g_loss_std = gradient_balance(
                r_fake, g_loss, alpha=o.balance_alpha)
            g_added = g_loss + r_fake
            g_final = g_balanced if o.apply_gradient_balance else g_added
        else:
            g_balanced = r_balanced = zeros
            alpha, r_fake_std, g_loss_std = 0.0, zeros[0], zeros[0]
            g_added = g_final = g_loss

        means = [d_loss.mean(), s_loss.mean(), r_real.mean(), g_final.mean()]
        values = (d_loss, d_loss_real, d_loss_fake, r_real, r_fake, r_balanced,
                  g_loss, g_added, g_balanced, g_final, alpha, r_fake_std, g_loss_std,
                  s_loss, s_loss_pos, s_loss_neg)
        metrics = torch.stack([metric(v) for v in values])
        if mesh is not None:  # the global batch's means (the stds are global already)
            means = list(sum_local_means(torch.stack(means)).unbind())
            metrics = sum_local_means(metrics)
        total = means[0] + means[1] + means[2] + means[3]
        return total, metrics, (g_stats, d_stats, r_stats, w_stats)

    def class_forward_losses(inputs: Mapping[str, torch.Tensor], nets: _Nets):
        """BigGAN's G + D forwards and losses (see the module's text)."""
        G, D = nets.live("g"), nets.live("d")
        real_imgs = normalize_images(inputs["real_imgs"], device)
        real_labels = inputs["real_labels"].long()
        fake_labels = inputs["fake_labels"].long()
        mark("g.fwd")
        with record_stats() as g_stats:
            gen_imgs = g_pass(G, fake_labels, inputs["z"].float())
        gen_sg = gen_imgs.detach()
        if marking():
            gen_imgs.register_hook(lambda grad: mark("backward.g"))
        mark("d.fwd")
        with record_stats() as d_stats:
            d_real = D(real_imgs, real_labels)
        d_fake_for_d = D(gen_sg, fake_labels)
        d_fake_for_g = nets.frozen("d")(gen_imgs, fake_labels)
        mark("losses")
        d_loss, d_loss_real, d_loss_fake = disc_loss_fn(d_real, d_fake_for_d)
        g_loss = gen_loss_fn(d_fake_for_g)
        zero = torch.zeros((), device=device)
        values = (d_loss, d_loss_real, d_loss_fake, zero, zero, zero, g_loss, g_loss, zero,
                  g_loss, 0.0, zero, zero, zero, zero, zero)
        metrics = torch.stack([metric(v) for v in values])
        return d_loss.mean() + g_loss.mean(), metrics, (g_stats, d_stats)

    def parallel_forward_backward(state: TrainState, inputs, z, drop_key) -> tuple:
        layout = state.layout
        if layout is None or layout.mesh is not mesh:
            raise ValueError("a parallel step needs the state laid out on its mesh "
                             "(parallel.prepare_state)")
        split = split_modules(models, layout)
        with use_step(StepContext(mesh, split)):
            nets = _Nets(models, {net: gathered_params(state, net, split)
                                  for net in NETWORKS})
            total, metrics, records = forward_losses(inputs, z, drop_key, nets)
            if mesh.size("data") > 1:  # every data rank seeds the one loss
                total = total / mesh.size("data")
            mark("backward.drw")
            total.backward()
        _sum_grads_over_data(state, layout)
        return metrics, records

    def body(state: TrainState, inputs: Mapping[str, torch.Tensor],
             z: torch.Tensor | None = None) -> torch.Tensor:
        mark("step.inputs")
        drop_key = step_key(state.dropout_seed, state.step_t) if my_rec else None
        if class_cond:
            total, metrics, records = class_forward_losses(inputs, _Nets(models))
            mark("backward.drw")
            total.backward()
        elif mesh is None:
            total, metrics, records = forward_losses(inputs, z, drop_key, _Nets(models))
            mark("backward.drw")
            total.backward()
        else:
            metrics, records = parallel_forward_backward(state, inputs, z, drop_key)
        mark("stats")
        for record in records:
            commit_stats(record)
        # JAX's lax.cond on the cadence; its static fast path at disc_iters == 1
        take_g = None if o.disc_iters == 1 else (state.step_t + 1) % o.disc_iters == 0
        mark("update")
        for net in state.nets:
            params = state.params(net)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            take = take_g if net == "g" else None
            updates, _ = opts[net].update(grads, state.opt_states[net], take)
            apply_updates(params, updates, take)
            for p in params:
                p.grad = None
        if state.g_ema is not None:
            mark("ema")
            update_ema(state.g_ema, state.params("g"), o.g_ema_decay, take_g)
        state.step_t.add_(1)
        mark("step.end")
        return metrics

    return body


def _local(batch: Mapping[str, torch.Tensor], mesh, dim: int) -> dict[str, torch.Tensor]:
    return {key: local_rows(value, mesh, dim) for key, value in batch.items()}


def make_train_step(cfg: Config, models: ModelBundle, mesh=None):
    """Returns step(state, batch, z=None) -> {metric name: 0-d float32 tensor}.

    batch holds numpy arrays or tensors in the JAX package's layout:
      real_imgs    (B, 32, 16 Lr, C) uint8, or float32 in [-1, 1]
      real_labels  (B, Lr) int
      style_imgs   (B, 32, 160, C) uint8 or float32
      fake_labels  (B, Lf) int
    and in 'padded' shape mode real_lengths and fake_lengths (B,), the true
    word lengths. z (B, latent_dim) is required with z_source='noise'. The
    step runs the body eagerly and updates `state` in place: parameters,
    statistics, optimizer states, EMA and step counters. With a `mesh`,
    batch and z are the global batch's; the rank keeps its rows."""
    body = make_step_body(cfg, models, mesh)
    device = next(models.generator.parameters()).device

    def step(state: TrainState, batch: Mapping, z: torch.Tensor | None = None
             ) -> dict[str, torch.Tensor]:
        state.step_t.fill_(state.step)
        metrics = body(state, _local(stage_batch(batch, device), mesh, 0),
                       None if z is None else local_rows(torch.as_tensor(z).to(device), mesh))
        state.step += 1
        return dict(zip(METRIC_NAMES, metrics.unbind()))

    return step


def make_chunked_train_step(cfg: Config, models: ModelBundle, mesh=None):
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
    eagerly, and so does a parallel step (`mesh`: each rank keeps its rows
    of the global batches and z, `make_train_step`). `chunk.graphs` is the
    `StepGraphs` (None on the CPU and in a parallel step)."""
    body = make_step_body(cfg, models, mesh)
    device = next(models.generator.parameters()).device
    graphs = None
    if device.type == "cuda" and mesh is None:
        from scrabblegan_torch.train.graphs import StepGraphs

        graphs = StepGraphs(body, device)

    def chunk(state: TrainState, batches: Mapping, z=None) -> torch.Tensor:
        batches = _local({key: torch.as_tensor(value) for key, value in batches.items()},
                         mesh, 1)
        z = None if z is None else local_rows(torch.as_tensor(z), mesh, 1)
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

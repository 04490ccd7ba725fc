"""Optimizers and learning-rate schedules as plain functions over parameter lists.

Port of scrabblegan_tpu/train/optim.py (lean Adam) and of the optax
transforms that scrabblegan_tpu/train/state.py `make_optimizers` builds:

- lean Adam: the first moment elided at beta_1 = 0 (m = g), the second moment
  optionally stored in bfloat16 (the math in the gradient's float32);
- Adam in optax's layout (`optax.adam`): both moments kept, float32;
- `optax.rmsprop`'s defaults: decay 0.9, eps 1e-8 inside the square root, no
  momentum (torch's RMSprop uses alpha 0.99 and eps outside the root);
- the constant, cosine and warmup-cosine schedules of optax.

Each update is u = m_hat / (sqrt(v_hat) + eps), eps 1e-8 outside the root,
scaled by -lr(count) where count is the number of updates before this one, as
optax's `scale_by_learning_rate` counts. An `Optimizer` is a pair of
functions like an optax GradientTransformation: `init(params) -> state` and
`update(grads, state) -> (updates, state)`; `apply_updates` adds updates to
the parameters in place. The step count is a host integer, so an update
issues no device synchronisation. The elementwise chains run as
`torch._foreach_*` ops over the whole list.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

Schedule = Callable[[int], float]
Params = list[torch.Tensor]


@dataclasses.dataclass
class OptState:
    count: int                       # updates taken
    nu: Params                       # second moment (RMSprop's mean square)
    mu: Params | None = None         # first moment; None when elided


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState], tuple[Params, OptState]]


def constant_schedule(lr: float) -> Schedule:
    return lambda count: lr


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    warmup_steps, then cosine to end_value at decay_steps (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        return cosine(count - warmup_steps)
    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax and the lean Adam compute it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def adam(lr: Schedule, b1: float, b2: float, eps: float = 1e-8,
         moment_dtype: str | None = None, elide_mu: bool = False) -> Optimizer:
    """Adam. `elide_mu` (lean Adam, only at b1 == 0) keeps no first moment;
    `moment_dtype='bfloat16'` stores the moments in bfloat16."""
    if elide_mu and b1 != 0.0:
        raise ValueError("the first moment can be elided only at beta_1 == 0")
    store = {None: None, "float32": None, "bfloat16": torch.bfloat16}[moment_dtype]

    def zeros(params: Params) -> Params:
        return [torch.zeros_like(p, dtype=store or p.dtype) for p in params]

    def init(params: Params) -> OptState:
        return OptState(0, zeros(params), None if elide_mu else zeros(params))

    def update(grads: Params, state: OptState) -> tuple[Params, OptState]:
        count = state.count + 1
        nu = torch._foreach_mul([v.to(g.dtype) for v, g in zip(state.nu, grads)], b2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1.0 - b2)
        if elide_mu:
            mu, mu_hat = None, grads  # b1 == 0: m = g and 1 - b1**t = 1
        else:
            mu = torch._foreach_mul([m.to(g.dtype) for m, g in zip(state.mu, grads)], b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias_correction(b2, count)))
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -lr(state.count))
        keep = (lambda xs: [x.to(store) for x in xs]) if store else (lambda xs: xs)
        return updates, OptState(count, keep(nu), None if mu is None else keep(mu))

    return Optimizer(init, update)


def rmsprop(lr: Schedule, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """optax.rmsprop with its defaults: u = g / sqrt(nu + eps)."""

    def init(params: Params) -> OptState:
        return OptState(0, [torch.zeros_like(p) for p in params])

    def update(grads: Params, state: OptState) -> tuple[Params, OptState]:
        nu = torch._foreach_mul(state.nu, decay)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1.0 - decay)
        updates = torch._foreach_mul(grads, torch._foreach_rsqrt(torch._foreach_add(nu, eps)))
        torch._foreach_mul_(updates, -lr(state.count))
        return updates, OptState(state.count + 1, nu)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    torch._foreach_add_(params, updates)


def make_optimizers(cfg) -> dict[str, Optimizer]:
    """The four optimizers of scrabblegan_tpu/train/state.py `make_optimizers`:
    Adam for G, D and W, and Adam or RMSprop for R, at the configured rates
    and schedule."""
    o = cfg.optimizer

    def schedule(lr: float) -> Schedule:
        if o.lr_schedule == "constant":
            return constant_schedule(lr)
        if o.lr_schedule == "cosine":
            return cosine_decay_schedule(lr, o.decay_steps)
        if o.lr_schedule == "warmup_cosine":
            return warmup_cosine_decay_schedule(0.0, lr, o.warmup_steps, o.decay_steps)
        raise ValueError(f"unknown lr_schedule: {o.lr_schedule}")

    if o.adam_impl == "lean":
        def make_adam(lr):
            return adam(schedule(lr), o.beta_1, o.beta_2, moment_dtype=o.moment_dtype,
                        elide_mu=o.beta_1 == 0.0)
    elif o.adam_impl == "optax":
        def make_adam(lr):
            return adam(schedule(lr), o.beta_1, o.beta_2)
    else:
        raise ValueError(f"unknown adam_impl {o.adam_impl!r}")
    return {"g": make_adam(o.g_lr), "d": make_adam(o.d_lr),
            "r": rmsprop(schedule(o.r_lr)) if o.rmsprop else make_adam(o.r_lr),
            "w": make_adam(o.w_lr)}

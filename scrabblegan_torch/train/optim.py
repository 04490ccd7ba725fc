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
`update(grads, state, take=None) -> updates`; `apply_updates` adds updates
to the parameters in place.

Everything an update reads or writes lives on the parameters' device, so a
CUDA graph can capture it and replay it: the count is a 0-d int32 tensor,
the schedules and bias corrections are evaluated from it in float32 as optax
evaluates them from its int32 count, and the moments and the count are
updated in place (bfloat16 moment storage included). `take`, a 0-d bool
tensor, gates a whole update on the device: where it is False the moments
and the count keep their values bitwise, and so do the parameters and the
EMA under `apply_updates` and `update_ema` with the same `take`. The
elementwise chains run as `torch._foreach_*` ops over the whole list.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]  # int32 count -> float32 rate, 0-d
Params = list[torch.Tensor]


@dataclasses.dataclass
class OptState:
    count: torch.Tensor              # updates taken: 0-d int32 on the parameters' device
    nu: Params                       # second moment (RMSprop's mean square)
    mu: Params | None = None         # first moment; None when elided


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    # (grads, state, take=None) -> (updates, state): the state is updated in place
    update: Callable[..., tuple[Params, OptState]]


def constant_schedule(lr: float) -> Schedule:
    return lambda count: torch.full((), lr, dtype=torch.float32, device=count.device)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = math.pi * torch.clamp(count, max=decay_steps).float() / decay_steps
        return init_value * ((1 - alpha) * (0.5 * (1 + torch.cos(frac))) + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: optax's linear schedule from init
    to peak over warmup_steps, joined to a cosine to end_value at
    decay_steps (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1 - torch.clamp(count, 0, warmup_steps).float() / warmup_steps
        linear = (init_value - peak_value) * frac + peak_value
        return torch.where(count < warmup_steps, linear, cosine(count - warmup_steps))
    return schedule


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in float32, as optax and the lean Adam compute it."""
    return 1.0 - torch.pow(decay, count.float())


def _commit(olds: Params, news: Params, take: torch.Tensor | None) -> None:
    """olds <- news in place, cast to the olds' dtype; where `take` is
    False the olds keep their values."""
    if take is not None:
        news = [torch.where(take, n, o.to(n.dtype)) for o, n in zip(olds, news)]
    torch._foreach_copy_(olds, news)


def _count_up(state: OptState, take: torch.Tensor | None) -> None:
    state.count.add_(1 if take is None else take.to(state.count.dtype))


def _zero_count(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device if params else None)


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
        return OptState(_zero_count(params), zeros(params), None if elide_mu else zeros(params))

    def update(grads: Params, state: OptState, take: torch.Tensor | None = None
               ) -> tuple[Params, OptState]:
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
        _commit(state.nu, nu, take)
        if mu is not None:
            _commit(state.mu, mu, take)
        _count_up(state, take)
        return updates, state

    return Optimizer(init, update)


def rmsprop(lr: Schedule, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """optax.rmsprop with its defaults: u = g / sqrt(nu + eps)."""

    def init(params: Params) -> OptState:
        return OptState(_zero_count(params), [torch.zeros_like(p) for p in params])

    def update(grads: Params, state: OptState, take: torch.Tensor | None = None
               ) -> tuple[Params, OptState]:
        nu = torch._foreach_mul(state.nu, decay)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1.0 - decay)
        updates = torch._foreach_mul(grads, torch._foreach_rsqrt(torch._foreach_add(nu, eps)))
        torch._foreach_mul_(updates, -lr(state.count))
        _commit(state.nu, nu, take)
        _count_up(state, take)
        return updates, state

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params, take: torch.Tensor | None = None) -> None:
    """params += updates in place; where `take` is False they keep their values."""
    if take is None:
        torch._foreach_add_(params, updates)
    else:
        _commit(params, torch._foreach_add(params, updates), take)


@torch.no_grad()
def update_ema(ema: Params, params: Params, decay: float,
               take: torch.Tensor | None = None) -> None:
    """ema <- decay * ema + (1 - decay) * params in place, gated like
    `apply_updates`."""
    new = torch._foreach_mul(ema, decay)
    torch._foreach_add_(new, params, alpha=1.0 - decay)
    _commit(ema, new, take)


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

"""Train state of the port: the four networks, their optimizer states, the
step counter and the EMA of G's parameters.

Port of scrabblegan_tpu/train/state.py (`TrainState`,
`create_train_state`). The networks hold their parameters and statistics
(BN running stats, spectral norm's u and sigma) as torch parameters and
buffers; the state holds everything else. `create_train_state` draws every
leaf with flax's initialisers, in flax's layout, and loads the tree through
`scrabblegan_torch.convert`:

- orthogonal kernels for every SN conv, transposed conv and dense layer,
  orthogonal over the (-1, out) matrix;
- glorot-uniform for the filter bank;
- flax's defaults for the recognizer's plain convs and dense layer
  (lecun-normal kernels, zero biases);
- flax's defaults for the BiLSTM recognizer's convs, dense layer and LSTM
  cells (lecun-normal kernels and input kernels, orthogonal recurrent
  kernels, zero biases);
- spectral norm's u ~ N(0, 1) and sigma 1, then one committed power
  iteration on every SN layer, as flax's `init` runs one
  (`ops/layers.py` `init_power_iteration`): u is the normalised first
  iterate and sigma its estimate; BN scale 1, bias 0, mean 0, var 1; the
  attention sigma 0.

The random numbers come from a `torch.Generator` seeded with `seed`, so a
seed gives other weights than `jax.random` gives the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from scrabblegan_torch.config import Config
from scrabblegan_torch import resolve_device
from scrabblegan_torch.convert import flax_leaves, flax_shapes, load_flax, unflatten
from scrabblegan_torch.models.build import ModelBundle, build_models
from scrabblegan_torch.ops.layers import init_power_iteration
from scrabblegan_torch.train.optim import OptState, make_optimizers

NETWORKS = "gdrw"  # the ModelBundle's order: generator, discriminator, recognizer, style promoter


@dataclasses.dataclass
class TrainState:
    models: ModelBundle
    opt_states: dict[str, OptState]  # keyed by NETWORKS
    step: int = 0  # steps taken, on the host: logs, epochs and checkpoint names
    g_ema: list[torch.Tensor] | None = None  # G's parameters' EMA, in G.parameters() order
    # the step counter on the device, 0-d int64: a step call sets it from
    # `step` and the step body advances it (the disc_iters cadence reads it)
    step_t: torch.Tensor | None = None
    # the dropout stream's seed on the device, 0-d int64: a step's masks are a
    # function of it and `step_t` (ops/dropout.py `step_key`)
    dropout_seed: torch.Tensor | None = None
    # where each parameter, moment and EMA piece lives in a parallel run
    # (parallel/fsdp.py `Layout`, set by `parallel.prepare_state`); None in one process
    layout: object = None

    def __post_init__(self):
        device = next(self.models.generator.parameters()).device
        if self.step_t is None:
            self.step_t = torch.full((), self.step, dtype=torch.int64, device=device)
        if self.dropout_seed is None:
            self.dropout_seed = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def nets(self) -> str:
        """The networks the state holds: NETWORKS, or 'gd' for BigGAN."""
        return NETWORKS[:len(self.models.items())]

    def params(self, net: str) -> list[torch.Tensor]:
        return list(self.modules()[net].parameters())

    def modules(self) -> dict[str, torch.nn.Module]:
        return {net: module for net, (_, module) in zip(NETWORKS, self.models.items())}


def new_train_state(cfg: Config, models: ModelBundle) -> TrainState:
    """A step-0 state around loaded networks: empty optimizer states and, when
    `optimizer.g_ema_decay` > 0, the EMA at G's parameters."""
    opts = make_optimizers(cfg)
    state = TrainState(models, {})
    state.opt_states = {net: opts[net].init([p.detach() for p in state.params(net)])
                        for net in state.nets}
    if cfg.optimizer.g_ema_decay > 0:
        state.g_ema = [p.detach().clone() for p in state.params("g")]
    return state


def _orthogonal(shape: tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    """jax.nn.initializers.orthogonal(column_axis=-1): orthonormal columns
    (or rows, if fewer) of the (-1, out) matrix, from the QR of a float32
    normal draw, as jax draws and factors it in the parameters' float32."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = torch.randn(max(n_rows, n_cols), min(n_rows, n_cols), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape)


def _fans(shape: tuple[int, ...]) -> tuple[int, int]:
    """flax variance_scaling's fans: in axis -2, out axis -1."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def init_fill(leaves: dict[tuple[str, ...], tuple[tuple[int, ...], str]],
              seed: int = 0) -> dict:
    """A flax tree for {path: (shape, initialiser name)}, drawn in sorted path
    order from a torch.Generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for path in sorted(leaves):
        shape, init = leaves[path]
        if init == "orthogonal":
            arr = _orthogonal(shape, gen)
        elif init == "lecun_normal":  # truncated normal at +-2 std, variance 1 / fan_in
            std = math.sqrt(1.0 / _fans(shape)[0]) / 0.87962566103423978
            arr = torch.nn.init.trunc_normal_(torch.empty(shape, dtype=torch.float64),
                                              std=std, a=-2 * std, b=2 * std, generator=gen)
        elif init == "glorot_uniform":
            fan_in, fan_out = _fans(shape)
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            arr = (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1) * limit
        elif init == "normal":
            arr = torch.randn(shape, generator=gen, dtype=torch.float64)
        elif init in ("zeros", "ones"):
            arr = torch.full(shape, 1.0 if init == "ones" else 0.0, dtype=torch.float64)
        else:
            raise ValueError(f"unknown initialiser {init!r} at {'/'.join(path)}")
        out[path] = arr.numpy().astype(np.float32)
    return unflatten(out)


def init_variables(module: torch.nn.Module, seed: int) -> dict:
    """The flax tree that flax's `init` would give `module`'s counterpart,
    drawn by `init_fill`."""
    shapes = flax_shapes(module)
    return init_fill({path: (shapes[path], leaf.init)
                      for path, _, leaf in flax_leaves(module)}, seed)


def create_train_state(cfg: Config, seed: int = 0, device: str | torch.device = "cpu",
                       biggan=None) -> TrainState:
    """A fresh train state for `cfg`, every network initialised as flax
    initialises it (see the module docstring), one seed per network; the
    dropout stream seeded with `seed`. With `biggan` (config.BigGANConfig)
    BigGAN's G and D, initialised as BigGAN initialises them
    (models/biggan.py `init_biggan`)."""
    models = build_models(cfg, resolve_device(device), biggan)
    for idx, (_, module) in enumerate(models.items()):
        if biggan is not None:
            from scrabblegan_torch.models.biggan import init_biggan

            init_biggan(module, seed * len(NETWORKS) + idx)
            continue
        load_flax(module, init_variables(module, seed * len(NETWORKS) + idx))
        init_power_iteration(module)
    state = new_train_state(cfg, models)
    state.dropout_seed.fill_(seed)
    return state

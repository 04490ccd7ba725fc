"""Shared machinery of the whole-step parity tests (tests/test_torch_step_*.py):
one train step of the JAX package and of the PyTorch port from the same
converted state and uint8 batch, on the CPU.

JAX variables come from `jax.eval_shape(create_train_state)` filled by
`scrabblegan_torch.convert.fake_fill` (random SN u, BN statistics, attention
sigma != 0), never from `init`, which takes a minute here. The JAX step is
jitted once per configuration.

How the two steps are compared:
- the 16 metrics;
- every statistic the step writes (BN running stats, SN u and sigma), network
  by network, in flax layout;
- the G EMA;
- the gradients, through lean Adam's second moment: at the first update
  nu = (1 - b2) g^2, so sqrt(nu / (1 - b2)) = |g|, compared leaf by leaf in
  the Frobenius norm; and the sign of every update where |g| is not small.
  Adam's first update is +-lr whatever the gradient's size, so the new
  parameters alone would hide a wrong one. G's gradients are ill-conditioned
  at batch 2 (batch norm's fast variance over activations whose mean dwarfs
  their spread): JAX's own float32 gradient of G differs from its float64
  one by up to 1.5% of a leaf's largest entry at this state, the port's
  float32 from its float64 by under 0.1% (measured with the same weights), so
  the gradients are held in the norm, at the tolerance each test states.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from scrabblegan_tpu.config import load_config
from scrabblegan_tpu.train.state import build_models as jax_build_models
from scrabblegan_tpu.train.state import create_train_state as jax_create_train_state
from scrabblegan_tpu.train.state import make_optimizers as jax_make_optimizers
from scrabblegan_tpu.train.step import METRIC_NAMES as JAX_METRIC_NAMES
from scrabblegan_tpu.train.step import make_train_step as jax_make_train_step
from scrabblegan_torch.convert import (fake_fill, fake_flax_variables, flatten,
                                       state_from_flax, to_flax)
from scrabblegan_torch.train import compare
from scrabblegan_torch.train.step import METRIC_NAMES, make_train_step

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

B = 2
NETS = {"g": "generator", "d": "discriminator", "r": "recognizer", "w": "style_promoter"}


def config(padded: bool, **overrides):
    base = {"shared.batch_size": B, "parallel.num_devices": 1,
            "parallel.shape_mode": "padded" if padded else "bucketed",
            "io.bucket_size": 2, "optimizer.g_ema_decay": 0.999}
    return load_config(None, {**base, **overrides})


def make_batch(cfg, length: int, seed: int = 0) -> dict:
    """A uint8 batch as bench.py makes one; in padded mode the second word of
    each side is one character shorter and carries the PAD id."""
    rng = np.random.default_rng(seed)
    batch = {
        "real_imgs": rng.integers(0, 256, (B, 32, 16 * length, 1)).astype(np.uint8),
        "real_labels": rng.integers(0, 52, (B, length)).astype(np.int32),
        "style_imgs": rng.integers(0, 256, (B, 32, 160, 1)).astype(np.uint8),
        "fake_labels": rng.integers(0, 52, (B, length)).astype(np.int32),
    }
    if cfg.parallel.shape_mode == "padded":
        lengths = np.array([length, length - 1], np.int32)
        for side in ("real", "fake"):
            batch[f"{side}_labels"][1, length - 1] = 52
            batch[f"{side}_lengths"] = lengths
    return batch


@functools.cache
def _jax_shapes(cfg):
    models = jax_build_models(cfg)
    shapes = jax.eval_shape(lambda: jax_create_train_state(cfg, jax.random.PRNGKey(0), models))
    return models, shapes


def jax_start_state(cfg, seed: int = 0):
    """The JAX TrainState at step 0 with fake_fill values, and the same
    networks' flax trees {"g": (params, batch_stats), ...}."""
    models, shapes = _jax_shapes(cfg)
    trees = {}
    for idx, net in enumerate(NETS):
        flat = {("params", *p): s.shape for p, s in flatten(getattr(shapes, f"{net}_params")).items()}
        flat.update({("batch_stats", *p): s.shape
                     for p, s in flatten(getattr(shapes, f"{net}_stats")).items()})
        tree = fake_fill(flat, seed * 4 + idx)
        trees[net] = (tree["params"], tree.get("batch_stats", {}))
    opts = jax_make_optimizers(cfg)
    fields = {"step": jnp.zeros((), jnp.int32)}
    for net, (params, stats) in trees.items():
        params = jax.tree.map(jnp.asarray, params)
        fields[f"{net}_params"] = params
        fields[f"{net}_stats"] = jax.tree.map(jnp.asarray, stats)
        fields[f"{net}_opt"] = opts[net].init(params)
    fields["g_ema"] = (jax.tree.map(jnp.array, fields["g_params"])
                       if cfg.optimizer.g_ema_decay > 0 else None)
    return models, shapes.replace(**fields), trees


@dataclasses.dataclass
class StepPair:
    cfg: object
    jax_before: object
    jax_after: object
    jax_metrics: dict
    port_state: object
    port_metrics: dict
    port_before: dict  # {net: flax tree of the port's networks before the step}


def run_both(cfg, length: int, seed: int = 0, jax_step=None) -> StepPair:
    models, jstate, trees = jax_start_state(cfg, seed)
    batch = make_batch(cfg, length, seed)
    step = jax_step or jax.jit(jax_make_train_step(cfg, models))
    jax_after, jax_metrics = step(jstate, batch, jax.random.PRNGKey(1))
    jax_metrics = {k: float(v) for k, v in jax_metrics.items()}

    port_state = state_from_flax(cfg, {n: t[0] for n, t in trees.items()},
                                 {n: t[1] for n, t in trees.items()})
    port_before = {n: to_flax(m) for n, m in port_state.modules().items()}
    port_metrics = make_train_step(cfg, port_state.models)(port_state, batch)
    port_metrics = {k: float(v) for k, v in port_metrics.items()}
    return StepPair(cfg, jstate, jax_after, jax_metrics, port_state, port_metrics, port_before)


def assert_close(got, want, rtol, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def check_metrics(pair: StepPair, rtol: float, atol: float):
    assert tuple(METRIC_NAMES) == tuple(JAX_METRIC_NAMES)
    for name in METRIC_NAMES:
        assert np.isfinite(pair.port_metrics[name]), name
        assert_close(pair.port_metrics[name], pair.jax_metrics[name], rtol, atol, name)


def check_stats(pair: StepPair, rtol: float, atol: float) -> int:
    """Every statistic of every network after the step; returns how many
    leaves changed in the step (JAX side), so a test can see they moved."""
    moved = 0
    for net, module in pair.port_state.modules().items():
        port = flatten(to_flax(module).get("batch_stats", {}))
        want = flatten(getattr(pair.jax_after, f"{net}_stats"))
        before = flatten(getattr(pair.jax_before, f"{net}_stats"))
        assert sorted(port) == sorted(want), net
        for path, arr in want.items():
            moved += not np.array_equal(np.asarray(arr), np.asarray(before[path]))
            assert_close(port[path], arr, rtol, atol, f"{net} stats {'/'.join(path)}")
    return moved


def _port_tree(module, tensors) -> dict:
    """The flax params tree of `module` with its parameters replaced, in
    module.parameters() order, by `tensors`."""
    names = [name for name, _ in module.named_parameters()]
    return flatten(to_flax(module, dict(zip(names, tensors)))["params"])


def check_ema(pair: StepPair, rtol: float, atol: float):
    G = pair.port_state.models.generator
    port = _port_tree(G, pair.port_state.g_ema)
    for path, arr in flatten(pair.jax_after.g_ema).items():
        assert_close(port[path], arr, rtol, atol, f"g_ema {'/'.join(path)}")


def fake_tree(cfg, net: str, seed: int = 0) -> dict:
    """A fake_fill flax tree of one network ('g', 'd', 'r' or 'w') for the
    port alone, made without JAX."""
    return fake_flax_variables(cfg, seed, NETS[net])


def check_gradients_of(pair: StepPair, net: str, rtol: float) -> float:
    """|g| from lean Adam's nu on both sides for network `net`, held by the
    rule of `scrabblegan_torch.train.compare`: each leaf's error within rtol
    of its scale, and the update's sign where no such error can flip it.
    Returns the largest leaf norm, so a test can check that the network
    received a gradient."""
    b2 = pair.cfg.optimizer.beta_2
    module = pair.port_state.modules()[net]
    port_nu = _port_tree(module, pair.port_state.opt_states[net].nu)
    jax_nu = flatten(getattr(pair.jax_after, f"{net}_opt")[0].nu)
    port_new = flatten(to_flax(module)["params"])
    before = flatten(pair.port_before[net]["params"])
    jax_new = flatten(getattr(pair.jax_after, f"{net}_params"))
    paths = list(jax_nu)
    g_jax = compare.abs_grads([jax_nu[p] for p in paths], b2)
    g_port = compare.abs_grads([port_nu[p] for p in paths], b2)
    errors, scales = compare.gradient_errors(g_port, g_jax)
    for path, gp, g, err, scale in zip(paths, g_port, g_jax, errors, scales):
        assert gp.shape == g.shape, path
        assert err <= rtol, f"{net} |grad| {'/'.join(path)}: error {err} x {scale} > {rtol}"
        live = compare.sign_mask(g, rtol * scale)
        d_port = np.sign(port_new[path] - before[path])[live]
        d_jax = np.sign(np.asarray(jax_new[path]) - before[path])[live]
        np.testing.assert_array_equal(d_port, d_jax, err_msg=f"{net} update sign {path}")
    return max(float(np.linalg.norm(g)) for g in g_jax)

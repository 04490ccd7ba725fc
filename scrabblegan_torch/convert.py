"""Flax variable trees <-> the port's modules.

The counterpart of the flax trees that scrabblegan_tpu/train/checkpoint.py
`load_generator` restores: a nested {"params", "batch_stats"} dict. Each port
module names the flax leaves it holds (`flax_leaves`) under a scope that
mirrors its flax scope, so the map from one tree to the other is mechanical:
- conv kernels HWIO -> OIHW;
- transposed-conv kernels HWIO -> (I, O, kh, kw), flipped in both spatial axes
  (see ops/layers.py SNConvTranspose);
- dense kernels (in, out) -> (out, in);
- biases, BN scale/mean/var, the filter bank, spectral norm's u and sigma
  and the attention's sigma as they are.

`load_flax` and `to_flax` map one module both ways; `state_from_flax` loads
the four networks of a JAX TrainState (`g_params`/`g_stats`, ...) into the
port's train state. On disk a tree is a flat .npz whose keys are the flax
paths joined by '.' (flax names hold no '.'; spectral norm's leaf names hold
'/').
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import numpy as np
import torch
from torch import nn

from scrabblegan_torch.config import Config
from scrabblegan_torch.models.build import build_generator, build_models
from scrabblegan_torch.models.generator import Generator
from scrabblegan_torch.ops.layers import FlaxLeaf

Path = tuple[str, ...]

_TO_TORCH = {
    "same": lambda a: a,
    "conv": lambda a: a.transpose(3, 2, 0, 1),
    "conv_transpose": lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
    "dense": lambda a: a.T,
}
_TO_FLAX = {
    "same": lambda a: a,
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "conv_transpose": lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
    "dense": lambda a: a.T,
}


def flatten(tree: Mapping, prefix: Path = ()) -> dict[Path, object]:
    out: dict[Path, object] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def unflatten(flat: Mapping[Path, object]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def flax_leaves(module: nn.Module) -> Iterator[tuple[Path, str, FlaxLeaf]]:
    """(flax path, torch state_dict key, leaf) of every leaf."""
    for name, mod in module.named_modules():
        if not hasattr(mod, "flax_leaves"):
            continue
        scope = tuple(name.split(".")) if name else ()
        for leaf in mod.flax_leaves():
            yield (leaf.collection, *scope, *leaf.path), ".".join(scope + (leaf.attr,)), leaf


def load_flax(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax {"params", "batch_stats"} tree of arrays into `module`.

    Raises on a missing, unexpected or misshapen leaf."""
    flat = flatten(variables)
    state, seen = {}, set()
    for path, key, leaf in flax_leaves(module):
        if path not in flat:
            raise KeyError(f"the flax variables lack {'/'.join(path)}")
        seen.add(path)
        arr = _TO_TORCH[leaf.layout](np.asarray(flat[path], np.float32))
        state[key] = torch.from_numpy(arr.copy(order="C"))  # fresh strides
    extra = sorted("/".join(p) for p in set(flat) - seen)
    if extra:
        raise KeyError(f"unexpected flax leaves: {extra[:5]} ({len(extra)} in all)")
    module.load_state_dict(state, strict=True)
    return module


def to_flax(module: nn.Module, state: Mapping[str, torch.Tensor] | None = None) -> dict:
    """The flax {"params", "batch_stats"} tree of float32 numpy arrays that
    `load_flax` would load into `module`: its inverse. `state` overrides
    entries of the module's state_dict (e.g. its parameters' EMA)."""
    state = {**module.state_dict(), **(state or {})}
    return unflatten({path: np.array(
        _TO_FLAX[leaf.layout](state[key].detach().float().cpu().numpy()), order="C")
        for path, key, leaf in flax_leaves(module)})


def state_from_flax(cfg: Config, params: Mapping[str, Mapping],
                    batch_stats: Mapping[str, Mapping], device: str | torch.device = "cpu"):
    """The port's TrainState for `cfg` holding a JAX TrainState's networks:
    params["g"] and batch_stats["g"] are its `g_params` and `g_stats`, and so
    for "d", "r" and "w". The optimizer states start empty, the step at 0 and
    the G EMA (when `optimizer.g_ema_decay` > 0) at G's parameters."""
    # train.state builds on this module, so it is imported here
    from scrabblegan_torch.train.state import new_train_state

    models = build_models(cfg, device)
    for net, (_, module) in zip("gdrw", models.items()):
        load_flax(module, {"params": params[net], "batch_stats": batch_stats.get(net, {})})
    return new_train_state(cfg, models)


def generator_from_flax(variables: Mapping, cfg: Config,
                        device: str | torch.device = "cpu") -> Generator:
    """The port's generator for `cfg`, holding a flax generator's variables.

    With z_source='style' the style encoder is loaded with the rest. With
    'noise' a style-trained export's style encoder is skipped: the noise z
    source never runs it, as JAX's `infer.py --z-source noise` leaves it
    unused."""
    if cfg.shared.z_source != "style":
        variables = {c: {k: v for k, v in sub.items() if k != "style_encoder"}
                     for c, sub in variables.items()}
    return load_flax(build_generator(cfg, device), variables)


def fake_fill(shapes: Mapping[Path, tuple[int, ...]], seed: int = 0) -> dict:
    """A flax tree of seeded float32 values for flat {path: shape}.

    Path-aware like scrabblegan_tpu/utils/fakeparams.py, but BN mean/var, SN u
    and the attention sigma are drawn from the seed rather than constant, so
    that a wrong mapping shows in a parity test: kernels, biases and the bank
    N(0, 0.02); BN scale 1 + N(0, 0.1), mean N(0, 0.1), var U(0.5, 1.5); SN u
    N(0, 1); the attention sigma U(0.5, 1); SN's stored sigma 1. Paths are
    drawn in sorted order, so equal trees get equal values."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shape, last = tuple(shapes[path]), path[-1]
        if last.endswith("/sigma"):
            arr = np.ones(shape)
        elif last.endswith("/u"):
            arr = rng.standard_normal(shape)
        elif last == "sigma":
            arr = rng.uniform(0.5, 1.0, shape)
        elif last == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif last == "mean":
            arr = 0.1 * rng.standard_normal(shape)
        elif last == "var":
            arr = rng.uniform(0.5, 1.5, shape)
        else:
            arr = 0.02 * rng.standard_normal(shape)
        out[path] = arr.astype(np.float32)
    return unflatten(out)


def flax_shapes(module: nn.Module) -> dict[Path, tuple[int, ...]]:
    """{flax path: shape} of the tree `module` loads (build it on 'meta')."""
    state = module.state_dict()
    shapes = {}
    for path, key, leaf in flax_leaves(module):
        view = np.broadcast_to(np.float32(0), tuple(state[key].shape))
        shapes[path] = _TO_FLAX[leaf.layout](view).shape
    return shapes


def fake_flax_variables(cfg: Config, seed: int = 0, network: str = "generator") -> dict:
    """The flax-layout tree that JAX `<network>.init` builds for `cfg`, filled
    by `fake_fill`, made with numpy alone. `network` is a `ModelBundle` field:
    'generator', 'discriminator', 'recognizer' or 'style_promoter'."""
    module = (build_generator(cfg, "meta") if network == "generator"
              else getattr(build_models(cfg, "meta"), network))
    return fake_fill(flax_shapes(module), seed)


def save_flax_npz(path: str, variables: Mapping) -> None:
    np.savez(path, **{".".join(p): np.asarray(a) for p, a in flatten(variables).items()})


def load_flax_npz(path: str) -> dict:
    with np.load(path) as data:
        return unflatten({tuple(k.split(".")): data[k] for k in data.files})

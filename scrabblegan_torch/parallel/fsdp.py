"""FSDP/ZeRO-3 sharding of the train state over the data axis, and the
layout machinery every parallel mode shares.

Port of scrabblegan_tpu/parallel/fsdp.py. The rule (`leaf_spec`) is JAX's,
evaluated on the flax shape of each leaf: a leaf of at least `min_size`
elements is split on its largest axis divisible by the data axis's size,
ties to the earliest; everything else (BN scales, SN power vectors,
biases, scalars) stays whole. A spec is JAX's PartitionSpec as a tuple: ()
for replicated, else one entry a flax axis, None or a mesh axis name (or
('model', 'data'), parallel/fsdp_tp.py).

The port holds its kernels in torch layouts (OIHW, (I, O, kh, kw) flipped,
(out, in)), so the rule reads the flax shape from each leaf's
`FlaxLeaf.layout` and maps the chosen flax axis to the torch axis
(`placement`). Within a spatially flipped transposed-conv axis rank r holds
the r-th torch piece, the mirror of flax's (no divisor the meshes meet
divides a 3x3 kernel's 3).

At rest (`shard_state`) each rank holds its piece of every sharded
parameter, of its Adam moments and of its EMA, the parameters as the
networks' own (smaller) `nn.Parameter`s, so the optimizer and the EMA run
on the pieces unchanged. The statistics buffers (BN mean and var, SN u and
sigma; at most 1,024 elements, below every default min size) stay whole on
every rank: JAX would split one only under an `fsdp_min_size` below that.
At use (`gathered_params`) the step gathers each network's parameters
once: an autograd Function whose forward all-gathers and whose backward
reduce-scatters over the data axis (each rank's samples are its own
consumers), and, over the model axis, sums for a layer that splits its
output channels (parallel/tp.py) and takes this rank's piece for one that
runs whole on every model rank. `unsharded(state)` gathers the whole state
for a checkpoint or the epoch's artifacts and puts the pieces back after.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Iterator

import torch
from torch import nn

from scrabblegan_torch.parallel import mesh as pmesh

Spec = tuple  # () replicated, else one entry a flax axis

# torch axis of each flax axis, by FlaxLeaf.layout (scrabblegan_torch/convert.py)
FLAX_TO_TORCH = {
    "conv": (2, 3, 1, 0),            # HWIO -> OIHW
    "conv_transpose": (2, 3, 0, 1),  # HWIO -> (I, O, kh, kw), spatial axes flipped
    "dense": (1, 0),                 # (in, out) -> (out, in)
}


def leaf_spec(mesh_shape, shape, min_size: int = 65536, axis: str = "data") -> Spec:
    """JAX's `leaf_sharding`: the largest axis divisible by the mesh axis's
    size, ties to the earliest, for a leaf of at least `min_size` elements."""
    n = mesh_shape.get(axis, 1)
    size = 1
    for d in shape:
        size *= d
    if n > 1 and size >= min_size and shape:
        best_dim, best = None, 0
        for i, d in enumerate(shape):
            if d % n == 0 and d > best:
                best_dim, best = i, d
        if best_dim is not None:
            spec = [None] * len(shape)
            spec[best_dim] = axis
            return tuple(spec)
    return ()


def flax_axis_to_torch(layout: str, axis: int) -> int:
    return FLAX_TO_TORCH[layout][axis] if layout in FLAX_TO_TORCH else axis


def flax_shape(tensor_shape, layout: str) -> tuple[int, ...]:
    """The flax shape of a leaf held in torch layout `layout`."""
    return tuple(int(tensor_shape[flax_axis_to_torch(layout, a)])
                 for a in range(len(tensor_shape)))


def placement(spec: Spec, layout: str) -> tuple[tuple[int, str], ...]:
    """(torch axis, mesh axis) pairs in gather order: of a co-shard
    ('model', 'data') the data piece is minor, gathered first."""
    out = []
    for a, entry in enumerate(spec):
        if entry is None:
            continue
        names = ("data", "model") if isinstance(entry, tuple) else (entry,)
        if isinstance(entry, tuple) and tuple(entry) != ("model", "data"):
            raise ValueError(f"unsupported co-shard {entry!r}")
        out += [(flax_axis_to_torch(layout, a), name) for name in names]
    return tuple(out)


def local_piece(full: torch.Tensor, places, mesh) -> torch.Tensor:
    """This rank's piece of a whole tensor under `places`."""
    out = full
    for axis, name in reversed(places):  # the inverse of the gathers
        out = out.chunk(mesh.size(name), axis)[mesh.rank(name)]
    return out.contiguous()


def gather_whole(t: torch.Tensor, places, mesh) -> torch.Tensor:
    """The whole tensor from every rank's piece (no autograd)."""
    for axis, name in places:
        t = pmesh.all_gather(t, axis, mesh.group(name))
    return t


class _Unshard(torch.autograd.Function):
    """The whole parameter from the pieces; the backward reduce-scatters
    over the data axis and over a split layer's model axis, and takes this
    rank's piece over the model axis of a layer that runs whole."""

    @staticmethod
    def forward(ctx, piece_, places, mesh, split):
        ctx.places, ctx.mesh, ctx.split = places, mesh, split
        return gather_whole(piece_, places, mesh)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        for axis, name in reversed(ctx.places):
            if name == "data" or ctx.split:
                grad = pmesh.reduce_scatter(grad, axis, ctx.mesh.group(name))
            else:
                grad = pmesh.piece(grad, axis, ctx.mesh.group(name))
        return grad, None, None, None


@dataclasses.dataclass
class Layout:
    """Where each tensor of a sharded train state lives: per network, the
    parameters' placements in `module.parameters()` order (the moments and
    G's EMA follow their parameter's)."""

    mesh: object  # parallel.mesh.Mesh
    places: dict[str, list[tuple]]  # net -> per parameter
    names: dict[str, list[str]]     # net -> parameter names

    def sharded(self) -> bool:
        return any(p for places in self.places.values() for p in places)


def param_leaves(module: nn.Module) -> list[tuple[str, object]]:
    """(parameter name, FlaxLeaf) in `module.parameters()` order."""
    from scrabblegan_torch.convert import flax_leaves

    by_key = {key: leaf for _, key, leaf in flax_leaves(module)}
    out = []
    for name, _ in module.named_parameters():
        if name not in by_key:
            raise KeyError(f"parameter {name} has no flax leaf")
        out.append((name, by_key[name]))
    return out


def state_layout(cfg, mesh, models) -> Layout:
    """The layout of `cfg`'s parallel mode (parallel.mesh `state_spec_for`)
    on whole networks."""
    from scrabblegan_torch.train.state import NETWORKS

    rule = pmesh.state_spec_for(cfg, mesh.shape)
    places, names = {}, {}
    for net, (_, module) in zip(NETWORKS, models.items()):
        places[net], names[net] = [], []
        params = dict(module.named_parameters())
        for name, leaf in param_leaves(module):
            p = params[name]
            spec = rule(flax_shape(p.shape, leaf.layout))
            places[net].append(placement(spec, leaf.layout))
            names[net].append(name)
    return Layout(mesh, places, names)


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    owner_name, _, attr = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    setattr(owner, attr, nn.Parameter(value, requires_grad=True))


def _map_state(state, fn) -> None:
    """Replace every parameter, moment and EMA tensor t of net `net`, index
    i, by fn(net, i, t)."""
    from scrabblegan_torch.train.state import NETWORKS

    mods = state.modules()
    for net in NETWORKS:
        names = state.layout.names[net]
        params = state.params(net)
        for i, (name, p) in enumerate(zip(names, params)):
            _set_param(mods[net], name, fn(net, i, p.detach()))
        opt = state.opt_states[net]
        for moments in (opt.nu, opt.mu):
            if moments is not None:
                for i, m in enumerate(moments):
                    moments[i] = fn(net, i, m)
    if state.g_ema is not None:
        state.g_ema[:] = [fn("g", i, e) for i, e in enumerate(state.g_ema)]


def shard_state(state, layout: Layout):
    """Keep only this rank's pieces of a whole state, in place."""
    state.layout = layout
    _map_state(state, lambda net, i, t: local_piece(t, layout.places[net][i], layout.mesh))
    return state


@contextlib.contextmanager
@torch.no_grad()
def unsharded(state) -> Iterator[None]:
    """The whole state on every rank inside the block (a collective: every
    rank enters it), its pieces again after."""
    layout = state.layout
    if layout is None or not layout.sharded():
        yield
        return
    _map_state(state, lambda net, i, t: gather_whole(t, layout.places[net][i], layout.mesh))
    try:
        yield
    finally:
        _map_state(state, lambda net, i, t: local_piece(t, layout.places[net][i],
                                                        layout.mesh))


def gathered_params(state, net: str, split_modules: set) -> dict[str, torch.Tensor] | None:
    """{name: whole parameter} of network `net` for `functional_call`, each
    sharded one through `_Unshard`; None when nothing of it is sharded."""
    layout = state.layout
    places = layout.places[net]
    if not any(places):
        return None
    module = state.modules()[net]
    owners = {name: name.rpartition(".")[0] for name in layout.names[net]}
    out = {}
    for name, p, pl in zip(layout.names[net], module.parameters(), places):
        if pl:
            owner = module.get_submodule(owners[name]) if owners[name] else module
            out[name] = _Unshard.apply(p, pl, layout.mesh, owner in split_modules)
        else:
            out[name] = p
    return out

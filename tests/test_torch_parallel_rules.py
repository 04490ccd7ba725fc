"""The port's three sharding rules against the JAX package's, leaf for leaf.

scrabblegan_torch/parallel/{fsdp,tp,fsdp_tp}.py evaluate JAX's rules on the
flax shape of each leaf and map the chosen flax axis to the torch axis.
Here, on conftest's 8 virtual devices (meshes 8, (4, 2) and (1, 2)):
- over the whole JAX train state (`jax.eval_shape` of `create_train_state`,
  with G's EMA and optax Adam's two moments: nothing is compiled), every
  leaf's spec under the port's rule equals JAX's `state_shardings`,
  `tp_state_shardings` and `fsdp_tp_state_shardings`;
- every parameter and statistic of the port's networks, read through its
  flax layout, gets the spec of its JAX leaf, and the port's piece of it
  on each mesh coordinate, converted back to flax's layout, is exactly the
  block JAX's sharding gives that device;
- the JAX tests' edge cases: small, indivisible, and the co-shard fallback.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from scrabblegan_tpu.config import load_config as jax_load_config
from scrabblegan_tpu.parallel.fsdp import leaf_sharding, state_shardings
from scrabblegan_tpu.parallel.fsdp_tp import fsdp_tp_state_shardings, leaf_fsdp_tp_sharding
from scrabblegan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from scrabblegan_tpu.parallel.tp import leaf_tp_sharding, tp_state_shardings
from scrabblegan_tpu.train.state import build_models as jax_build_models
from scrabblegan_tpu.train.state import create_train_state as jax_create_train_state

from scrabblegan_torch.config import load_config
from scrabblegan_torch.convert import _TO_FLAX, _TO_TORCH, flax_leaves
from scrabblegan_torch.models.build import build_models
from scrabblegan_torch.parallel.fsdp import flax_shape, leaf_spec, local_piece, placement
from scrabblegan_torch.parallel.fsdp_tp import leaf_fsdp_tp_spec
from scrabblegan_torch.parallel.tp import leaf_tp_spec

OVERRIDES = {"optimizer.g_ema_decay": 0.999, "optimizer.adam_impl": "optax"}
MIN_SIZE = 65536  # parallel.fsdp_min_size's default

PORT_RULES = {
    "fsdp": lambda shape_of_mesh, shape: leaf_spec(shape_of_mesh, shape, MIN_SIZE),
    "tp": lambda shape_of_mesh, shape: leaf_tp_spec(shape_of_mesh, shape),
    "fsdp_tp": lambda shape_of_mesh, shape: leaf_fsdp_tp_spec(
        shape_of_mesh, shape, fsdp_min_size=MIN_SIZE),
}
JAX_RULES = {
    "fsdp": lambda mesh, shapes: state_shardings(mesh, shapes, min_size=MIN_SIZE),
    "tp": lambda mesh, shapes: tp_state_shardings(mesh, shapes),
    "fsdp_tp": lambda mesh, shapes: fsdp_tp_state_shardings(mesh, shapes,
                                                            fsdp_min_size=MIN_SIZE),
}
CASES = [("8", "fsdp"), ("4x2", "fsdp"), ("4x2", "tp"), ("4x2", "fsdp_tp"),
         ("1x2", "tp"), ("1x2", "fsdp_tp")]


def _mesh(name: str):
    if name == "8":
        return jax_make_mesh(8)
    data, model = map(int, name.split("x"))
    return jax_make_mesh(data * model, model)


@functools.lru_cache(maxsize=1)
def _jax_shapes():
    cfg = jax_load_config(None, OVERRIDES)
    return jax.eval_shape(lambda: jax_create_train_state(cfg, jax.random.PRNGKey(0),
                                                         jax_build_models(cfg)))


def _spec(sharding) -> tuple:
    return tuple(sharding.spec)


@pytest.mark.parametrize("mesh_name,rule", CASES)
def test_every_leaf_of_the_state_gets_jax_spec(mesh_name, rule):
    mesh = _mesh(mesh_name)
    shapes = _jax_shapes()
    shardings = JAX_RULES[rule](mesh, shapes)
    leaves = jax.tree_util.tree_leaves(shapes)
    jax_specs = [_spec(s) for s in jax.tree_util.tree_leaves(shardings)]
    assert len(leaves) == len(jax_specs) > 400
    got = [PORT_RULES[rule](dict(mesh.shape), tuple(leaf.shape)) for leaf in leaves]
    assert got == jax_specs
    assert sum(bool(s) for s in got) > 10  # the rule splits something


def _jax_leaf_specs(mesh, rule) -> dict:
    """{(net, collection, *flax path): (spec, shape, sharding)} of the JAX
    state's networks."""
    shapes = _jax_shapes()
    shardings = JAX_RULES[rule](mesh, shapes)
    out = {}
    for net in "gdrw":
        for field, collection in ((f"{net}_params", "params"), (f"{net}_stats", "batch_stats")):
            tree_shapes = getattr(shapes, field)
            tree_sh = getattr(shardings, field)
            flat = jax.tree_util.tree_flatten_with_path(tree_shapes)[0]
            flat_sh = jax.tree_util.tree_leaves(tree_sh)
            for (path, leaf), sh in zip(flat, flat_sh):
                key = (net, collection, *(p.key for p in path))
                out[key] = (_spec(sh), tuple(leaf.shape), sh)
    return out


@pytest.mark.parametrize("mesh_name,rule", CASES)
def test_port_tensors_hold_jax_pieces(mesh_name, rule):
    mesh = _mesh(mesh_name)
    jax_leaves = _jax_leaf_specs(mesh, rule)
    cfg = load_config(None, OVERRIDES)
    models = build_models(cfg)
    mesh_shape = dict(mesh.shape)
    seen, checked = 0, {}
    for net, (_, module) in zip("gdrw", models.items()):
        state = module.state_dict()
        for path, key, leaf in flax_leaves(module):
            spec, jshape, sharding = jax_leaves[(net, *path)]
            t = state[key]
            fshape = flax_shape(t.shape, leaf.layout)
            assert fshape == jshape, (net, path)
            got = PORT_RULES[rule](mesh_shape, fshape)
            assert got == spec, (net, path, got, spec)
            seen += 1
            # the piece on every device, converted back, is JAX's block
            combo = (leaf.layout, fshape, spec)
            if spec and combo not in checked:
                checked[combo] = True
                arr = np.arange(int(np.prod(fshape)), dtype=np.float64).reshape(fshape)
                whole = _TO_TORCH[leaf.layout](arr)
                whole_t = torch.from_numpy(whole.copy(order="C"))
                places = placement(spec, leaf.layout)
                index_map = sharding.devices_indices_map(fshape)
                coords = {d: c for c, d in np.ndenumerate(mesh.devices)}
                for device, index in index_map.items():
                    piece = local_piece(whole_t, places, _CoordMesh(mesh, coords[device]))
                    back = _TO_FLAX[leaf.layout](piece.numpy())
                    np.testing.assert_array_equal(back, arr[index])
    assert seen == len(jax_leaves)
    assert checked


class _CoordMesh:
    """The port's mesh interface (size, rank) at one device's coordinate."""

    def __init__(self, mesh, coord):
        self.shape = dict(mesh.shape)
        self.coord = dict(zip(mesh.axis_names, coord))

    def size(self, axis):
        return self.shape.get(axis, 1)

    def rank(self, axis):
        return self.coord.get(axis, 0)


EDGE_CASES = [
    ("fsdp", (8,), (52, 32, 8192), {"min_size": 4096}),
    ("fsdp", (8,), (64,), {"min_size": 4096}),
    ("fsdp", (8,), (53, 129), {"min_size": 1}),
    ("fsdp", (8,), (3, 3, 1024, 1024), {}),
    ("tp", (4, 2), (3, 3, 128, 64), {}),
    ("tp", (4, 2), (52, 32, 8192), {}),
    ("tp", (4, 2), (64,), {}),
    ("tp", (4, 2), (3, 3, 64, 1), {}),
    ("tp", (4, 2), (32, 256), {}),
    ("tp", (4, 2), (16, 16), {}),
    ("fsdp_tp", (4, 2), (3, 3, 512, 1024), {}),
    ("fsdp_tp", (4, 2), (52, 32, 8192), {}),
    ("fsdp_tp", (4, 2), (13, 16384), {"fsdp_min_size": 1024}),
    ("fsdp_tp", (4, 2), (64,), {}),
    ("fsdp_tp", (4, 2), (32, 256), {}),
    ("fsdp_tp", (4, 2), (3, 3, 3, 6), {"tp_min_size": 1, "fsdp_min_size": 1}),
]


@pytest.mark.parametrize("rule,grid,shape,kwargs", EDGE_CASES)
def test_edge_cases_match_jax(rule, grid, shape, kwargs):
    mesh = jax_make_mesh(int(np.prod(grid)), grid[1] if len(grid) == 2 else 1)
    mesh_shape = dict(mesh.shape)
    if rule == "fsdp":
        want = leaf_sharding(mesh, shape, **kwargs).spec
        got = leaf_spec(mesh_shape, shape, **kwargs)
    elif rule == "tp":
        want = leaf_tp_sharding(mesh, shape, **kwargs).spec
        got = leaf_tp_spec(mesh_shape, shape, **kwargs)
    else:
        want = leaf_fsdp_tp_sharding(mesh, shape, **kwargs).spec
        got = leaf_fsdp_tp_spec(mesh_shape, shape, **kwargs)
    assert got == tuple(want)


def test_co_shard_places_data_minor():
    """('model', 'data') on one axis: the data piece is gathered first, so
    device (d, m) holds piece m * D + d, as JAX lays the axis out."""
    mesh = jax_make_mesh(8, 2)
    shape = (13, 16384)
    sharding = leaf_fsdp_tp_sharding(mesh, shape, fsdp_min_size=1024)
    assert tuple(sharding.spec) == (None, ("model", "data"))
    arr = np.arange(13 * 16384, dtype=np.float64).reshape(shape)
    places = placement(tuple(sharding.spec), "same")
    assert places == ((1, "data"), (1, "model"))
    coords = {d: c for c, d in np.ndenumerate(mesh.devices)}
    for device, index in sharding.devices_indices_map(shape).items():
        piece = local_piece(torch.from_numpy(arr), places, _CoordMesh(mesh, coords[device]))
        np.testing.assert_array_equal(piece.numpy(), arr[index])

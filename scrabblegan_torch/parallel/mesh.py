"""The device mesh, the collectives and the batch reductions of a parallel step.

Port of scrabblegan_tpu/parallel/mesh.py. JAX runs one program over a
`Mesh(('data',))` or `Mesh(('data', 'model'))` and lets GSPMD partition the
single-device step; here one process runs each rank (launched by
`torchrun`, or spawned by `parallel/selftest.py`), and the step itself says
where the ranks meet:

- `make_mesh(num_devices, model_parallel)` is a `DeviceMesh` over the world:
  1-D ('data',), or 2-D ('data', 'model') with the model axis minor, as JAX
  lays it out. `num_devices=-1` means `WORLD_SIZE`;
- every rank builds the same global batch and takes its data-axis slice
  (`local_rows`), so the data order is the single process's;
- every reduction over the batch is a reduction over the global batch
  (`global_mean`, `global_pstd`, `global_moments`): the local mean scaled
  by 1/D and all-reduced over the data group, D the data axis's size. The
  all-reduce's backward sums the ranks' gradients (each rank's consumers
  are its own samples); the one replicated consumer, the loss every rank
  computes whole, is seeded with 1/D in `train/step.py`, so that the
  parameter gradients summed over the data group are the single process's.
  With no step context, or a data axis of 1, each is today's plain
  reduction, so one process stays bitwise what it was.

The step opens `use_step(StepContext(...))` around its forward and
backward; the layers and reductions read it (`current()`) during the
forward, and every autograd Function here keeps its group in `ctx`, since
a card's backward runs on another thread.

Collectives: NCCL on a card, gloo on the CPU or on a card (several ranks on
one card). gloo has no CUDA path for `all_gather` and `reduce_scatter`:
those stage through pinned host buffers on every call (`_staged`), by the
backend's name, not on an error.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from collections.abc import Iterator

import torch
import torch.distributed as dist

def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    return global_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (itself in one process)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def init_distributed(backend: str, device: torch.device, init_method: str = "env://",
                     rank: int | None = None, world: int | None = None) -> torch.device:
    """Join the process group (`torchrun`'s environment, or the given rank,
    world and init method) and return this rank's device.

    `backend` is 'nccl' (a card) or 'gloo' (the CPU, or ranks sharing a
    card); there is no switch from one to the other. Under NCCL each rank
    needs a card of its own: NCCL refuses two ranks on one device."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--dist-backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda; use gloo on the CPU")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and local >= count:
            raise RuntimeError(f"local rank {local} under nccl needs {local + 1} cards, "
                               f"this machine has {count}: NCCL refuses two ranks on one "
                               "card (use --dist-backend gloo)")
        device = torch.device("cuda", local % count)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A DeviceMesh with JAX's axis names, and this rank's place in it."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.device_mesh.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        if axis not in self.names:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def backend(self) -> str:
        return dist.get_backend()


def make_mesh(num_devices: int = -1, model_parallel: int = 1,
              device_type: str = "cpu") -> Mesh:
    """The mesh over every rank: 1-D ('data',), or with model_parallel > 1
    the 2-D ('data', 'model') grid of shape (world / mp, mp), the model axis
    minor (adjacent ranks), as scrabblegan_tpu/parallel/mesh.py `make_mesh`.
    Needs the process group; `num_devices` is -1 or the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if num_devices not in (-1, world):
        raise ValueError(f"parallel.num_devices={num_devices} but {world} ranks run "
                         "(-1 means every rank)")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by model_parallel={model_parallel}")
    if model_parallel > 1:
        shape, names = (world // model_parallel, model_parallel), ("data", "model")
    else:
        shape, names = (world,), ("data",)
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=names), names)


def mesh_for(cfg, device: torch.device) -> Mesh | None:
    """The config's mesh when a process group is up, else None (one process:
    the step takes today's path, CUDA graphs included). Raises when the data
    axis does not divide `shared.batch_size`."""
    if not dist.is_initialized():
        return None
    mesh = make_mesh(cfg.parallel.num_devices, cfg.parallel.model_parallel, device.type)
    if cfg.shared.batch_size % mesh.size("data"):
        raise ValueError(f"shared.batch_size={cfg.shared.batch_size} does not split over "
                         f"the data axis of {mesh.size('data')} ranks")
    return mesh


def state_spec_for(cfg, mesh_shape):
    """The spec rule of `cfg`'s mode, shape -> spec, as scrabblegan_tpu's
    `state_sharding_for`: replicated, FSDP (parallel.fsdp and a data axis
    > 1), TP (parallel.model_parallel > 1 on a mesh with a model axis), or
    both composed (parallel/fsdp_tp.py)."""
    tp = cfg.parallel.model_parallel > 1 and "model" in mesh_shape
    fsdp = cfg.parallel.fsdp and mesh_shape.get("data", 1) > 1
    if tp and fsdp:
        from scrabblegan_torch.parallel.fsdp_tp import leaf_fsdp_tp_spec

        return lambda shape: leaf_fsdp_tp_spec(mesh_shape, shape,
                                               fsdp_min_size=cfg.parallel.fsdp_min_size)
    if tp:
        from scrabblegan_torch.parallel.tp import leaf_tp_spec

        return lambda shape: leaf_tp_spec(mesh_shape, shape)
    if fsdp:
        from scrabblegan_torch.parallel.fsdp import leaf_spec

        return lambda shape: leaf_spec(mesh_shape, shape, min_size=cfg.parallel.fsdp_min_size)
    return lambda shape: ()


# ---- collectives -------------------------------------------------------------

def _staged(t: torch.Tensor) -> bool:
    """gloo has no CUDA path for all_gather and reduce_scatter: stage."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _gather_fn():
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _scatter_fn():
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of `t` over the group, in place; returns `t`."""
    dist.all_reduce(t, group=group)
    return t


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a card tensor (the caching host allocator's)."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x)


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces of `t` concatenated along `dim`, in rank order."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    staged = _staged(x)
    src = _host(x) if staged else x
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=src.device,
                      pin_memory=staged)
    _gather_fn()(out, src, group=group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece along `dim` of the sum of `t` over the group."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    staged = _staged(x)
    src = _host(x) if staged else x
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=src.device,
                      pin_memory=staged)
    _scatter_fn()(out, src, group=group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    return out.movedim(0, dim).contiguous()


def piece(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece of `t` along `dim`, the inverse of `all_gather`."""
    n = dist.get_world_size(group)
    return t.chunk(n, dim)[dist.get_rank(group)].contiguous()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


# ---- the step context and the batch reductions -------------------------------

@dataclasses.dataclass
class StepContext:
    """What a parallel step's layers read: the mesh and the layers whose
    output channels are split over the model axis (parallel/tp.py)."""

    mesh: Mesh
    split: dict = dataclasses.field(default_factory=dict)  # module -> tp.Split

    @property
    def data_size(self) -> int:
        return self.mesh.size("data")


_STEP: contextvars.ContextVar[StepContext | None] = contextvars.ContextVar(
    "scrabblegan_torch_parallel_step", default=None)


@contextlib.contextmanager
def use_step(ctx: StepContext | None) -> Iterator[StepContext | None]:
    token = _STEP.set(ctx)
    try:
        yield ctx
    finally:
        _STEP.reset(token)


def current() -> StepContext | None:
    return _STEP.get()


def _data_group():
    """The data group when the open step spans more than one data rank."""
    ctx = current()
    if ctx is None or ctx.data_size == 1:
        return None, 1
    return ctx.mesh.group("data"), ctx.data_size


def sum_local_means(means: torch.Tensor) -> torch.Tensor:
    """Global means from local means over equal local batches: all-reduce of
    means / D over the data group in float32 (differentiable), in `means`'
    dtype; `means` itself when no group spans the data axis."""
    group, n = _data_group()
    if group is None:
        return means
    return _AllReduceSum.apply(means.float() / n, group).to(means.dtype)


def global_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The mean of `x` over the global batch, `dim` as `torch.mean`'s
    (every reduced set of dims includes the batch's dim 0)."""
    return sum_local_means(x.mean() if dim is None else x.mean(dim=dim))


def global_pstd(x: torch.Tensor) -> torch.Tensor:
    """The population std of `x` over the global batch (jnp.std), in float32
    as torch.std computes a bf16 one, in `x`'s dtype."""
    if _data_group()[0] is None:
        return torch.std(x, correction=0)
    xf = x.float()
    mean = global_mean(xf)
    return torch.sqrt(global_mean((xf - mean).square())).to(x.dtype)


def global_moments(x: torch.Tensor, dim) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) over the global batch, one all-reduce for both."""
    if _data_group()[0] is None:
        return x.mean(dim=dim), x.square().mean(dim=dim)
    both = sum_local_means(torch.stack([x.mean(dim=dim), x.square().mean(dim=dim)]))
    return both[0], both[1]


def local_rows(x: torch.Tensor, mesh: Mesh | None, dim: int = 0) -> torch.Tensor:
    """This rank's data-axis slice of a global batch along `dim`; ranks on
    one model axis take the same slice."""
    if mesh is None or mesh.size("data") == 1:
        return x
    n = x.shape[dim]
    d = mesh.size("data")
    if n % d:
        raise ValueError(f"a batch of {n} does not split over {d} data ranks")
    return x.narrow(dim, mesh.rank("data") * (n // d), n // d)

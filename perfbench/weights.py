"""Seeded weights for the networks, made on the device by the benchmark.

The benchmark reads the names and shapes of the program's tensors (its
modules' `state_dict`), draws every leaf from one normal draw of a
`torch.Generator` on the device seeded with the run's seed, and hands the
same tensors to the program (`load`) and to the reference: a driver keeps a
host copy of what it loaded, for the reference after the window.

Scales: kernels N(0, 1 / fan_in); biases N(0, 0.05^2); BN scales 1 + N(0,
0.1^2), BN shifts N(0, 0.1^2), running moments 0 and 1; the non-local blocks'
sigma 0.5 + N(0, 0.1^2), so that attention shapes the output; the filter bank
N(0, 1/32); LSTM biases N(0, 0.05^2). Each spectrally normalised layer's u is
drawn and then iterated `POWER_ITERATIONS` times, as a trained network's u has
converged, and its sigma set from the last iterate.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import nets

POWER_ITERATIONS = 8
SN_EPS = 1e-12


def specs(module: torch.nn.Module) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every floating tensor of `module`'s state_dict."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if v.is_floating_point()]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def _out_axis(name: str) -> int:
    """The output-channel axis of a kernel: 1 for the up-blocks' transposed
    convs (I, O, kh, kw), 0 otherwise."""
    parts = name.split(".")
    return 1 if parts[0].startswith("up_B") and parts[1] in ("upconv", "skip") else 0


def seed_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


@torch.no_grad()
def make(leaves: dict[str, list[tuple[str, tuple[int, ...]]]], seed: int,
         device) -> dict[str, dict[str, torch.Tensor]]:
    """{net: [(name, shape)]} -> {net: {name: float32 tensor on device}}."""
    order = [(net, name, shape) for net in sorted(leaves) for name, shape in leaves[net]]
    total = sum(math.prod(shape) for _, _, shape in order)
    noise = torch.randn(total, generator=seed_generator(seed, device), device=device)
    out: dict[str, dict[str, torch.Tensor]] = {net: {} for net in leaves}
    offset = 0
    for net, name, shape in order:
        n = math.prod(shape)
        x = noise[offset: offset + n].reshape(shape)
        offset += n
        names = dict(leaves[net])
        stem, _, leaf = name.rpartition(".")
        bn = stem + ".running_mean" in names
        if leaf == "running_mean":
            t = torch.zeros(shape, device=device)
        elif leaf == "running_var":
            t = torch.ones(shape, device=device)
        elif leaf == "sigma" and stem + ".u" in names:
            t = torch.ones(shape, device=device)  # set below from u
        elif leaf == "sigma":  # a non-local block's residual weight
            t = 0.5 + 0.1 * x
        elif leaf == "u":
            t = x.clone()
        elif bn and leaf == "weight":
            t = 1.0 + 0.1 * x
        elif bn and leaf == "bias":
            t = 0.1 * x
        elif name == "filter_bank.bank":
            t = x / math.sqrt(shape[1])
        elif leaf.startswith("h") and leaf.endswith("_bias") or leaf == "bias":
            t = 0.05 * x
        elif len(shape) >= 2:
            t = x * math.sqrt(shape[0] / n)  # N(0, 1 / fan_in)
        else:
            raise ValueError(f"no rule for the tensor {net}/{name} {shape}")
        out[net][name] = t.float().contiguous()
    for net, tensors in out.items():
        for name in list(tensors):
            if not name.endswith(".u"):
                continue
            stem = name[: -len(".u")]
            w = tensors[stem + ".weight"]
            axis = _out_axis(stem)
            mat = w.movedim(axis, -1).reshape(-1, w.shape[axis])
            u = _l2n(tensors[name])
            for _ in range(POWER_ITERATIONS):
                v = _l2n(u @ mat.T)
                u = _l2n(v @ mat)
            tensors[name] = u.contiguous()
            tensors[stem + ".sigma"] = ((v @ mat) @ u.T)[0, 0].reshape(
                tensors[stem + ".sigma"].shape).contiguous()
    return out


@torch.no_grad()
def load(module: torch.nn.Module, tensors: dict[str, torch.Tensor]) -> None:
    """Copy `tensors` into `module`'s parameters and buffers by name."""
    state = module.state_dict()
    missing = [k for k, v in state.items() if v.is_floating_point() and k not in tensors]
    if missing:
        raise KeyError(f"no seeded tensor for {missing[:5]}")
    for name, value in tensors.items():
        state[name].copy_(value)


@torch.no_grad()
def calibrate_generator(tensors: dict[str, torch.Tensor], labels: torch.Tensor,
                        z: torch.Tensor | None = None,
                        style_imgs: torch.Tensor | None = None) -> None:
    """Set G's running BN statistics, in place, to the batch statistics of one
    train-mode pass of the reference on a calibration batch (standing
    statistics, as an export of a trained G carries): the serving cells' G
    then normalises its activations as a trained one does."""
    record: dict[str, torch.Tensor] = {}
    net = nets.Net(tensors, train=True, record=record, momentum=0.0)
    style_net = nets.Net(tensors)  # the encoder has no batch norm
    nets.generator(net, labels, z, style_imgs=style_imgs, style_net=style_net)
    for name, value in record.items():
        if name.endswith((".running_mean", ".running_var")):
            tensors[name].copy_(value)

"""Analytic matmul and convolution FLOP count of any function of the port.

Port of scrabblegan_tpu/utils/flops.py, which walks a jaxpr and counts
`dot_general` as 2 prod(out) prod(contracting dims) and
`conv_general_dilated` as 2 prod(out) K_spatial C_in / groups: the
denominator of a share of the card's peak. Here the function runs once
under a `TorchDispatchMode` that sees every aten op below autograd (the
backward of a train step included) and counts by JAX's conventions, so the
count of a network's forward equals JAX's for the same function:

- mm, addmm, bmm, baddbmm, mv, dot: 2 prod(out) contract;
- convolution: 2 prod(out) K_spatial C_in / groups. A transposed conv is
  counted as JAX counts its lhs-dilated conv: over the 'SAME' output, the
  input's size times the stride, which the port's transposed convs crop to
  (ops/layers.py SNConvTranspose runs `conv_transpose2d` unpadded, whose
  aten output is larger), zeros of the dilation included;
- convolution_backward: its weight gradient as the forward, its input
  gradient as 2 prod(input) K_spatial C_out / groups (JAX's transpose
  rules: a conv whose output is the input's shape);
- the registered attention ops: scrabblegan::attention_fwd its two products
  2 B Q K (Ca + Cg), attention_bwd the four of JAX's plain backward (twice
  that), fused_block_fwd its theta and out projections besides;
- the LSTM (cuDNN's _cudnn_rnn on a card, oneDNN's mkldnn_rnn_layer on the
  CPU): 2 T B 4H (in + H) a direction, as JAX's scan of `OptimizedLSTMCell`
  counts its two products a step; its backward the input-side products,
  and the weight-side ones where the weights carry a gradient.

Elementwise ops and reductions are not counted, as in JAX. Unlike JAX's
trace, this runs the function: count on the device and at the shapes the
caller means, or on the CPU at small ones.
"""

from __future__ import annotations

import hashlib
import json
import math
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _prod(xs) -> int:
    return int(math.prod(int(x) for x in xs))


def _mm(a, b) -> int:
    return 2 * _prod(a.shape[:-1]) * int(b.shape[-1]) * int(a.shape[-1])


def _conv_forward(x, weight, stride, transposed: bool, groups: int, out_shape) -> int:
    k = _prod(weight.shape[2:])
    if transposed:  # weight (C_in, C_out / groups, kh, kw); JAX's 'SAME' output
        out = (x.shape[0], weight.shape[1] * groups,
               *(int(n) * int(s) for n, s in zip(x.shape[2:], stride)))
        return 2 * _prod(out) * k * (weight.shape[0] // groups)
    return 2 * _prod(out_shape) * k * weight.shape[1]  # weight (C_out, C_in / groups, kh, kw)


def _conv(args, out) -> int:
    x, weight, _, stride, _, _, transposed, _, groups = args[:9]
    return _conv_forward(x, weight, stride, transposed, groups, out.shape)


def _conv_backward(args, out) -> int:
    grad_out, x, weight = args[:3]
    stride, transposed, groups, mask = args[4], args[7], args[9], args[10]
    total = 0
    if mask[0]:
        c_out = weight.shape[1] if transposed else weight.shape[0] // groups
        total += 2 * _prod(x.shape) * _prod(weight.shape[2:]) * c_out
    if mask[1]:
        total += _conv_forward(x, weight, stride, transposed, groups, grad_out.shape)
    return total


def _attention(thetaT, gT) -> int:
    b, ca, q = thetaT.shape
    cg, k = gT.shape[1], gT.shape[2]
    return 2 * b * q * k * (ca + cg)


def _fused_block(args, out) -> int:
    x, w_theta, _, gT, _ = args[:5]
    b, c, n = x.shape
    ca, cg, k = w_theta.shape[1], gT.shape[1], gT.shape[2]
    return 2 * b * n * (c * ca + k * (ca + cg) + cg * c)


def _rnn(x, weights: list, per_cell: int) -> int:
    """2 T B (|W_ih| + |W_hh|) summed over the cells (layer, direction):
    x is (T, B, in) or (B, T, in); each cell's weights start with W_ih,
    W_hh, then its biases, `per_cell` tensors in all."""
    mats = sum(_prod(weights[i].shape) + _prod(weights[i + 1].shape)
               for i in range(0, len(weights), per_cell))
    return 2 * int(x.shape[0]) * int(x.shape[1]) * mats


def _cudnn_rnn(args, out) -> int:
    return _rnn(args[0], args[1], args[2])


def _cudnn_rnn_backward(args, out) -> int:
    mask = args[21]  # (input, hx, cx, weight)
    return _rnn(args[0], args[1], args[2]) * (int(any(mask[:3])) + int(mask[3]))


def _mkldnn_rnn_layer(args, out) -> int:
    return _rnn(args[0], args[1:3], 2)


def _mkldnn_rnn_layer_backward(args, out) -> int:
    """oneDNN's backward computes the weight gradients whether or not they are
    wanted; counted, as JAX counts, only where the weights carry a gradient."""
    weights = args[1:3]
    return _rnn(args[0], weights, 2) * (1 + int(any(w.requires_grad for w in weights)))


def _formulas() -> dict:
    table = {
        aten.mm: lambda a, o: _mm(a[0], a[1]),
        aten.addmm: lambda a, o: _mm(a[1], a[2]),
        aten.bmm: lambda a, o: _mm(a[0], a[1]),
        aten.baddbmm: lambda a, o: _mm(a[1], a[2]),
        aten.mv: lambda a, o: 2 * _prod(a[0].shape),
        aten.dot: lambda a, o: 2 * _prod(a[0].shape),
        aten.convolution: _conv,
        aten.convolution_backward: _conv_backward,
        aten._cudnn_rnn: _cudnn_rnn,
        aten._cudnn_rnn_backward: _cudnn_rnn_backward,
        aten.mkldnn_rnn_layer: _mkldnn_rnn_layer,
        aten.mkldnn_rnn_layer_backward: _mkldnn_rnn_layer_backward,
    }
    ops = torch.ops.scrabblegan  # registered by kernels/attention.py and kernels/fused_block.py
    table[ops.attention_fwd] = lambda a, o: _attention(a[0], a[2])
    table[ops.attention_bwd] = lambda a, o: 2 * _attention(a[0], a[2])
    table[ops.fused_block_fwd] = _fused_block
    return table


class FlopCounter(TorchDispatchMode):
    """Counts the matmul and conv FLOPs of the ops run inside it in `total`."""

    def __init__(self):
        super().__init__()
        import scrabblegan_torch.kernels.fused_block  # noqa: F401  (registers the ops)

        self.formulas = _formulas()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        formula = self.formulas.get(func.overloadpacket)
        if formula is not None:
            self.total += int(formula(args, out))
        return out


def matmul_flops(fn, *args, **kwargs) -> int:
    """Exact matmul and conv FLOPs of one call of `fn` on these args (see the
    module docstring), the backward included where `fn` runs one. Raises
    under `torch.inference_mode`, whose aten ops bypass a dispatch mode (use
    `torch.no_grad`)."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("matmul_flops under torch.inference_mode would miss the aten ops: "
                           "count under torch.no_grad")
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total


def _signature(x):
    if isinstance(x, dict):
        return {str(k): _signature(v) for k, v in sorted(x.items(), key=lambda kv: str(kv[0]))}
    if isinstance(x, (list, tuple)):
        return [_signature(v) for v in x]
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return [list(map(int, x.shape)), str(x.dtype)]
    return type(x).__name__


def _args_signature(args) -> str:
    return json.dumps(_signature(list(args)), sort_keys=True, default=str)


def matmul_flops_cached(fn, *args, salt: str = "", cache_path: str | None = None,
                        **kwargs) -> int:
    """`matmul_flops` with a persistent JSON cache, as JAX's: the key hashes
    `salt` (the caller passes the full config), the args' structure, shapes
    and dtypes, and the torch version. A model-code edit that keeps every
    shape and the config would alias: delete the file (or set
    SCRABBLEGAN_FLOPS_NO_CACHE=1) after one. No `cache_path`: no cache."""
    if not cache_path or os.environ.get("SCRABBLEGAN_FLOPS_NO_CACHE"):
        return matmul_flops(fn, *args, **kwargs)
    key = hashlib.sha256((salt + "|" + _args_signature(args) + "|" + torch.__version__)
                         .encode()).hexdigest()[:32]
    cache = {}
    if os.path.isfile(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
    if key in cache:
        return int(cache[key]["flops"])
    flops = matmul_flops(fn, *args, **kwargs)
    cache[key] = {"flops": int(flops), "note": salt[:120]}
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    with open(cache_path, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
        f.write("\n")
    return flops

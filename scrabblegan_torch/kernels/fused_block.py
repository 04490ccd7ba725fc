"""The whole non-local block around its pooled K side: the plain PyTorch
version and the CUDA kernel.

Port of `fused_nonlocal_block` in scrabblegan_tpu/kernels/attention.py: the
Pallas TPU kernel `_fused_block_kernel` (through `_fused_block_forward`)
becomes the sm_90a CUDA kernel in `scrabblegan_torch/csrc/fused_block_fwd.cu`,
and the autograd Function `FusedBlock` takes the place of the custom VJP
`_fused_block_op`: its backward is the gradient of the composition, whose
attention core runs the forward and backward CUDA kernels of
`kernels/attention.py`. It computes

    out = x + (sigma W_out)^T softmax((x W_theta) phiT) gT

per batch and query, unscaled, float32 or bfloat16 in and out.

Layout: x is (B, C, N), the port's NCHW activation viewed flat, whose query
order h*W + w is JAX's NHWC flatten order, so no transpose is needed; JAX's
x_flat is (B, N, C), and the tests swap those two axes at the boundary.
w_theta is (C, Ca) and w_out (Cg, C), JAX's (in, out) matrices; phiT
(B, Ca, K) and gT (B, Cg, K) are the pooled operands of the attention core.

Dispatch has no fallback: a CPU tensor takes the plain composition; a CUDA
tensor launches the kernel through `FusedBlock` (fuse=True, JAX's 'fused')
or runs the composition on the attention core's kernels (fuse=False, JAX's
'packed'), or raises. `launches` counts kernel launches; under CUDA graph
replay `train/graphs.py` keeps it exact, as for `kernels/attention.py`.
"""

from __future__ import annotations

import torch

from scrabblegan_torch.kernels.attention import (LOG2E, _DTYPE_CODE, _check_kernel_operands,
                                                 attention_reference,
                                                 nonlocal_attention_packed,
                                                 online_softmax_emulation)
from scrabblegan_torch.kernels.build import load_library

KERNEL_C, KERNEL_CA, KERNEL_CG = 64, 8, 32  # the widths csrc/fused_block_fwd.cu is written for

launches = 0  # fused-block kernel launches since the last reset; the caller resets it


def fused_block_reference(x: torch.Tensor, w_theta: torch.Tensor, phiT: torch.Tensor,
                          gT: torch.Tensor, w_out_s: torch.Tensor,
                          core=attention_reference) -> torch.Tensor:
    """The plain version; mirrors the JAX `_fused_block_reference`: the theta
    projection accumulated in float32 and cast to the working dtype, the
    attention core (`core`: the plain one by default, `nonlocal_attention_packed`
    for the kernel path on a card), the out projection accumulated in float32
    and cast back, then the residual in the working dtype."""
    dt = x.dtype
    thetaT = torch.matmul(w_theta.float().t(), x.float()).to(dt)          # (B, Ca, N)
    attn = core(thetaT, phiT, gT)                                        # (B, Cg, N)
    out = torch.matmul(w_out_s.float().t(), attn.float()).to(dt)         # (B, C, N)
    return out + x


def fused_block_emulation(x: torch.Tensor, w_theta: torch.Tensor, phiT: torch.Tensor,
                          gT: torch.Tensor, w_out_s: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's algorithm in plain torch, for testing it on the CPU.

    As the kernel does: log2(e) folded into w_theta in float32 and rounded to
    the working dtype (JAX `_fused_block_forward`); theta accumulated in
    float32 and rounded to the working dtype; the K walk shared with the
    attention forward kernel (`online_softmax_emulation`, the scores already
    in log2 units); the attention output rounded
    to the working dtype; the out projection in float32, rounded; the
    residual added in float32 and rounded."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    wt = rnd(w_theta.float() * LOG2E)
    theta = rnd(torch.matmul(x.float().transpose(1, 2), wt))             # (B, N, Ca)
    attn = rnd(online_softmax_emulation(theta, phiT, gT, log2_scores=True))  # (B, N, Cg)
    out = rnd(torch.matmul(attn, w_out_s.float()))                       # (B, N, C)
    return (out.transpose(1, 2) + x.float()).to(dt)


def _check_operands(x, w_theta, phiT, gT, w_out) -> None:
    if x.dim() != 3 or phiT.dim() != 3 or gT.dim() != 3:
        raise ValueError("x, phiT and gT must be 3-D: (B, C, N), (B, Ca, K), (B, Cg, K)")
    b, c, n = x.shape
    ca, cg, k = phiT.shape[1], gT.shape[1], phiT.shape[2]
    if (w_theta.shape != (c, ca) or w_out.shape != (cg, c) or phiT.shape[0] != b
            or gT.shape[0] != b or gT.shape[2] != k):
        raise ValueError(f"mismatched operands: x {tuple(x.shape)}, w_theta "
                         f"{tuple(w_theta.shape)}, phiT {tuple(phiT.shape)}, gT "
                         f"{tuple(gT.shape)}, w_out {tuple(w_out.shape)}")
    if 0 in (b, n, k):
        raise ValueError("empty block operands")
    ops = (x, w_theta, phiT, gT, w_out)
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in ops):
        raise TypeError("operands must all be float32 or all bfloat16, got "
                        f"{[str(t.dtype) for t in ops]}")
    if any(t.device != x.device for t in ops):
        raise ValueError("operands lie on different devices")


def _launch_fused(x: torch.Tensor, w_theta: torch.Tensor, phiT: torch.Tensor,
                  gT: torch.Tensor, w_out_s: torch.Tensor) -> torch.Tensor:
    global launches
    b, c, n = x.shape
    ca, cg, k = phiT.shape[1], gT.shape[1], phiT.shape[2]
    if (c, ca, cg) != (KERNEL_C, KERNEL_CA, KERNEL_CG):
        raise ValueError(f"the CUDA kernel takes C={KERNEL_C}, Ca={KERNEL_CA}, "
                         f"Cg={KERNEL_CG}; got C={c}, Ca={ca}, Cg={cg}")
    _check_kernel_operands(("x", x), ("phiT", phiT), ("gT", gT))
    wt_log2 = (w_theta.float() * LOG2E).to(x.dtype).contiguous()
    w_out_s = w_out_s.contiguous()
    lib = load_library()
    out = torch.empty((b, c, n), dtype=x.dtype, device=x.device)
    err = lib.fused_block_fwd(
        x.data_ptr(), wt_log2.data_ptr(), phiT.data_ptr(), gT.data_ptr(), w_out_s.data_ptr(),
        out.data_ptr(), b, n, k, x.stride(0), phiT.stride(0), gT.stride(0),
        _DTYPE_CODE[x.dtype], x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_fwd launch failed with CUDA error {err}")
    launches += 1
    return out


class FusedBlock(torch.autograd.Function):
    """The kernel path with its gradient: the forward kernel, and as the
    backward the gradient of the composition on the saved inputs, as the
    JAX custom VJP takes `jax.vjp(_fused_block_reference)`. On a card the
    composition's core is `AttentionCore`, so the backward recomputes the
    attention with the forward kernel and differentiates it with the backward
    kernel. Only the inputs that need a gradient get one (a frozen network's
    weights arrive detached). The launcher is looked up when called, so a
    test can put the CPU emulation in its place."""

    @staticmethod
    def forward(ctx, x, w_theta, phiT, gT, w_out_s):
        ctx.save_for_backward(x, w_theta, phiT, gT, w_out_s)
        return _launch_fused(x, w_theta, phiT, gT, w_out_s)

    @staticmethod
    def backward(ctx, d_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = fused_block_reference(*inputs, core=nonlocal_attention_packed)
            grads = iter(torch.autograd.grad(out, wanted, d_out))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_nonlocal_block(x: torch.Tensor, w_theta: torch.Tensor, phiT: torch.Tensor,
                         gT: torch.Tensor, w_out: torch.Tensor, sigma: torch.Tensor,
                         fuse: bool = True) -> torch.Tensor:
    """x (B, C, N) + sigma * Proj_out(Attend(x w_theta, phiT, gT)) -> (B, C, N).

    sigma folds into w_out in float32 and is cast to the working dtype, as
    JAX does. On CUDA with fuse=True the kernel (C=64, Ca=8, Cg=32; each
    operand's per-batch block dense); on CUDA with fuse=False the composition
    around the attention core's kernels; on the CPU the plain composition,
    whichever `fuse`. Every path carries gradients in all six arguments."""
    _check_operands(x, w_theta, phiT, gT, w_out)
    w_out_s = (w_out.float() * sigma.float()).to(w_out.dtype)
    if x.device.type == "cuda" and fuse:
        return FusedBlock.apply(x, w_theta, phiT, gT, w_out_s)
    if x.device.type in ("cuda", "cpu"):
        return fused_block_reference(x, w_theta, phiT, gT, w_out_s,
                                     core=nonlocal_attention_packed)
    raise ValueError(f"no fused block for device {x.device}")

"""Non-local attention core: the plain PyTorch version and the CUDA kernel.

Port of the forward core of scrabblegan_tpu/kernels/attention.py: the Pallas
TPU kernel `_attention_kernel` (through `_pallas_forward`) becomes the sm_90a
CUDA kernel in `scrabblegan_torch/csrc/attention_fwd.cu`. The operands are
channel-packed as there: thetaT (B, Ca, Q), phiT (B, Ca, K), gT (B, Cg, K) ->
outT (B, Cg, Q), with

    outT[b, :, q] = sum_k softmax_k(thetaT[b, :, q] . phiT[b, :, k]) gT[b, :, k]

unscaled (no 1/sqrt(d)), float32 or bfloat16 in and out, float32 inside.

Dispatch has no fallback: a CPU tensor takes `attention_reference`; a CUDA
tensor launches the kernel or raises. `launches` counts kernel launches.
The backward kernel and the fused-block kernel are not ported yet.
"""

from __future__ import annotations

import torch

from scrabblegan_torch.kernels.build import load_library

LOG2E = 1.4426950408889634
KERNEL_CA, KERNEL_CG = 8, 32  # the channel counts the kernel is written for
KEY_TILE, KEY_CHUNK = 128, 32  # csrc/attention_fwd.cu: kKt keys a tile, kKs a chunk
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset; the caller resets it


def attention_reference(thetaT: torch.Tensor, phiT: torch.Tensor,
                        gT: torch.Tensor) -> torch.Tensor:
    """The plain version; mirrors the JAX `_xla_attention`: float32 scores and
    softmax, the weights cast to the input dtype, the value product
    accumulated in float32 and cast back. Materialises the (B, Q, K) scores."""
    scores = torch.matmul(thetaT.float().transpose(1, 2), phiT.float())  # (B, Q, K)
    attn = torch.softmax(scores, dim=-1).to(thetaT.dtype)
    return torch.matmul(gT, attn.transpose(1, 2))  # (B, Cg, Q)


def attention_tiled_emulation(thetaT: torch.Tensor, phiT: torch.Tensor,
                              gT: torch.Tensor, key_tile: int = KEY_TILE,
                              key_chunk: int = KEY_CHUNK) -> torch.Tensor:
    """The CUDA kernel's algorithm in plain torch, for testing it on the CPU.

    As the kernel does: theta in float32 premultiplied by log2(e); K walked in
    tiles of `key_tile` keys, zero-filled past the end; inside a tile, chunks
    of `key_chunk` scores, with keys past the end masked to -inf; an online
    softmax in base 2 whose running max moves once per chunk; one division by
    the running sum at the end."""
    b, ca, q = thetaT.shape
    cg, k = gT.shape[1], gT.shape[2]
    theta = thetaT.float().transpose(1, 2) * LOG2E  # (B, Q, Ca)
    m = torch.full((b, q, 1), float("-inf"))
    l = torch.zeros(b, q, 1)
    acc = torch.zeros(b, q, cg)
    for k0 in range(0, k, key_tile):
        kn = min(key_tile, k - k0)
        phi_t = torch.zeros(b, ca, key_tile)
        g_t = torch.zeros(b, cg, key_tile)
        phi_t[..., :kn] = phiT[..., k0:k0 + kn].float()
        g_t[..., :kn] = gT[..., k0:k0 + kn].float()
        for j0 in range(0, kn, key_chunk):
            s = theta @ phi_t[..., j0:j0 + key_chunk]  # (B, Q, chunk)
            s = s.masked_fill(torch.arange(j0, j0 + key_chunk) >= kn, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            scale = torch.exp2(m - m_new)  # 0 on the first chunk, 1 if the max held
            p = torch.exp2(s - m_new)
            l = l * scale + p.sum(-1, keepdim=True)
            acc = acc * scale + p @ g_t[..., j0:j0 + key_chunk].transpose(1, 2)
            m = m_new
    return (acc * (1.0 / l)).transpose(1, 2).to(thetaT.dtype)


def _check_operands(thetaT: torch.Tensor, phiT: torch.Tensor, gT: torch.Tensor) -> None:
    if not thetaT.dim() == phiT.dim() == gT.dim() == 3:
        raise ValueError("thetaT, phiT and gT must be 3-D (B, C, N)")
    b, ca, q = thetaT.shape
    if phiT.shape[:2] != (b, ca) or gT.shape[0] != b or gT.shape[2] != phiT.shape[2]:
        raise ValueError(f"mismatched operands: thetaT {tuple(thetaT.shape)}, "
                         f"phiT {tuple(phiT.shape)}, gT {tuple(gT.shape)}")
    if 0 in (b, q, phiT.shape[2]):
        raise ValueError("empty attention operands")
    if thetaT.dtype not in _DTYPE_CODE or not thetaT.dtype == phiT.dtype == gT.dtype:
        raise TypeError(f"operands must all be float32 or all bfloat16, got "
                        f"{thetaT.dtype}, {phiT.dtype}, {gT.dtype}")
    if not thetaT.device == phiT.device == gT.device:
        raise ValueError("operands lie on different devices")


def _launch_kernel(thetaT: torch.Tensor, phiT: torch.Tensor,
                   gT: torch.Tensor) -> torch.Tensor:
    global launches
    b, ca, q = thetaT.shape
    cg, k = gT.shape[1], gT.shape[2]
    if (ca, cg) != (KERNEL_CA, KERNEL_CG):
        raise ValueError(f"the CUDA kernel takes Ca={KERNEL_CA}, Cg={KERNEL_CG}; "
                         f"got Ca={ca}, Cg={cg}")
    for name, t in (("thetaT", thetaT), ("phiT", phiT), ("gT", gT)):
        # each batch's (C, N) block must be dense; the batch stride is free
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            raise ValueError(f"{name}: each batch's (C, N) block must be contiguous, "
                             f"strides {t.stride()}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535")
    lib = load_library()
    out = torch.empty((b, cg, q), dtype=thetaT.dtype, device=thetaT.device)
    err = lib.attention_fwd(
        thetaT.data_ptr(), phiT.data_ptr(), gT.data_ptr(), out.data_ptr(), b, q, k,
        thetaT.stride(0), phiT.stride(0), gT.stride(0), _DTYPE_CODE[thetaT.dtype],
        thetaT.device.index, torch.cuda.current_stream(thetaT.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed with CUDA error {err}")
    launches += 1
    return out


def nonlocal_attention_packed(thetaT: torch.Tensor, phiT: torch.Tensor,
                              gT: torch.Tensor) -> torch.Tensor:
    """thetaT (B, Ca, Q), phiT (B, Ca, K), gT (B, Cg, K) -> outT (B, Cg, Q).

    On CUDA the kernel, which takes Ca=8, Cg=32 and operands whose per-batch
    (C, N) blocks are dense (a channel slice of a wider projection is fine);
    on the CPU the plain version."""
    _check_operands(thetaT, phiT, gT)
    if thetaT.device.type == "cuda":
        return _launch_kernel(thetaT, phiT, gT)
    if thetaT.device.type == "cpu":
        return attention_reference(thetaT, phiT, gT)
    raise ValueError(f"no attention core for device {thetaT.device}")


def nonlocal_attention(theta: torch.Tensor, phi: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """theta (B, Q, Ca), phi (B, K, Ca), g (B, K, Cg) -> (B, Q, Cg), the JAX
    `nonlocal_attention` layout, through the channel-packed core."""
    outT = nonlocal_attention_packed(theta.transpose(1, 2).contiguous(),
                                     phi.transpose(1, 2).contiguous(),
                                     g.transpose(1, 2).contiguous())
    return outT.transpose(1, 2)

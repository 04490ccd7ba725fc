"""Non-local attention core: the plain PyTorch versions and the CUDA kernels.

Port of the core of scrabblegan_tpu/kernels/attention.py: the Pallas TPU
kernels `_attention_kernel` (through `_pallas_forward`) and
`_attention_bwd_kernel` (through `_pallas_backward`) become the sm_90a CUDA
kernels in `scrabblegan_torch/csrc/attention_fwd.cu` (its walk over the keys
in `csrc/attention_mma.cuh`: on the tensor cores for bfloat16 operands, on
the CUDA cores for float32) and `attention_bwd.cu`, joined by the autograd
Function `AttentionCore` as JAX joins them by the custom VJP `_attention_op`.
The operands are channel-packed as there:
thetaT (B, Ca, Q), phiT (B, Ca, K), gT (B, Cg, K) -> outT (B, Cg, Q), with

    outT[b, :, q] = sum_k softmax_k(thetaT[b, :, q] . phiT[b, :, k]) gT[b, :, k]

unscaled (no 1/sqrt(d)), float32 or bfloat16 in and out, float32 inside.

Dispatch has no fallback: a CPU tensor takes `attention_reference`, which
autograd differentiates; a CUDA tensor goes through `AttentionCore`, whose
forward and backward launch the kernels or raise. `launches` and
`bwd_launches` count kernel launches. The whole-block kernel of the 'fused'
dataflow is in `kernels/fused_block.py`.
"""

from __future__ import annotations

import torch

from scrabblegan_torch.kernels.build import load_library

LOG2E = 1.4426950408889634
KERNEL_CA, KERNEL_CG = 8, 32  # the channel counts the kernel is written for
KEY_TILE, KEY_CHUNK = 128, 32  # csrc/attention_mma.cuh: kKt keys a tile, kKs a chunk
WARP_QUERIES = 32  # csrc/attention_mma.cuh: kWarpQ queries a warp on the tensor cores
MAX_SLACK = 8.0  # csrc/attention_mma.cuh: kSlack, log2 units the running max may lag by
BWD_TILE = 128  # csrc/attention_bwd.cu: kTile rows a shared-memory tile
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0      # forward kernel launches since the last reset; the caller resets it
bwd_launches = 0  # backward kernel launches (one per backward call), likewise


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

    As csrc/attention_fwd.cu does around the K walk of `online_softmax_emulation`:
    bfloat16 operands hand theta over as it is and the walk scales the float32
    scores by log2(e); float32 operands premultiply theta by log2(e). One
    division by the running sum at the end, then the cast to the input dtype."""
    theta = thetaT.float().transpose(1, 2)  # (B, Q, Ca)
    log2_scores = thetaT.dtype == torch.float32
    if log2_scores:
        theta = theta * LOG2E
    out = online_softmax_emulation(theta, phiT, gT, log2_scores, key_tile, key_chunk)
    return out.transpose(1, 2).to(thetaT.dtype)


def online_softmax_emulation(theta: torch.Tensor, phiT: torch.Tensor, gT: torch.Tensor,
                             log2_scores: bool, key_tile: int = KEY_TILE,
                             key_chunk: int = KEY_CHUNK) -> torch.Tensor:
    """The K walk of csrc/attention_mma.cuh, which csrc/attention_fwd.cu and
    csrc/fused_block_fwd.cu share: theta (B, Q, Ca) float32 -> (B, Q, Cg)
    float32, divided by the running sum. `log2_scores` says that log2(e) is
    already folded into theta; else the float32 scores are scaled.

    Both walks take K in tiles of `key_tile` keys, zero past the end, and
    inside a tile chunks of `key_chunk` scores with keys past the end masked
    to -inf; the running max moves at most once per chunk and the sums are
    rescaled when it does; the running sum adds the unrounded float32
    probabilities; the value product accumulates in float32.
    - `kwalk_fma` (float32 phiT and gT): a row's max moves whenever its
      chunk's max exceeds it.
    - `kwalk_mma` (bfloat16, on the tensor cores): the max moves only when
      some row among the warp's `WARP_QUERIES` sees a score more than
      `MAX_SLACK` log2 units above its own, and then every row of the warp
      takes the larger of its max and its chunk's; the probabilities are
      rounded to bfloat16 before the value product, as its operands are."""
    b, q, ca = theta.shape
    cg, k = gT.shape[1], gT.shape[2]
    unit = 1.0 if log2_scores else LOG2E  # log2 units per unit of score
    on_tensor_cores = phiT.dtype == torch.bfloat16
    slack = MAX_SLACK / unit if on_tensor_cores else 0.0
    m = torch.full((b, q, 1), float("-inf"))  # in the scores' own units
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
            cmax = s.amax(-1, keepdim=True)
            moved = cmax > m + slack
            if on_tensor_cores:
                moved = _any_row_of_the_warp(moved)
            m_new = torch.where(moved, torch.maximum(m, cmax), m)
            scale = torch.exp2((m - m_new) * unit)  # 0 on the first chunk, 1 if the max held
            p = torch.exp2(s * unit - m_new * unit)
            l = l * scale + p.sum(-1, keepdim=True)
            if on_tensor_cores:
                p = p.bfloat16().float()
            acc = acc * scale + p @ g_t[..., j0:j0 + key_chunk].transpose(1, 2)
            m = m_new
    return acc * (1.0 / l)


def _any_row_of_the_warp(moved: torch.Tensor) -> torch.Tensor:
    """moved (B, Q, 1) bool -> the same shape: true for every query whose
    warp (WARP_QUERIES consecutive queries, the last warp ragged) holds one."""
    b, q, _ = moved.shape
    pad = -q % WARP_QUERIES
    warps = torch.nn.functional.pad(moved, (0, 0, 0, pad)).view(b, -1, WARP_QUERIES)
    return warps.any(-1, keepdim=True).expand_as(warps).reshape(b, -1, 1)[:, :q]


def attention_backward_reference(thetaT: torch.Tensor, phiT: torch.Tensor,
                                 gT: torch.Tensor, doutT: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward; mirrors the JAX `_xla_backward`: float32 scores and
    softmax A, dS = A * (dA - rowsum(A * dA)), the grads cast to the input
    dtypes. Materialises the (B, Q, K) matrices."""
    theta, phi, g = thetaT.float(), phiT.float(), gT.float()
    dout = doutT.float()
    attn = torch.softmax(torch.matmul(theta.transpose(1, 2), phi), dim=-1)  # (B, Q, K)
    d_gT = torch.matmul(dout, attn)                                     # (B, Cg, K)
    d_attn = torch.matmul(dout.transpose(1, 2), g)                      # (B, Q, K)
    d_scores = attn * (d_attn - (attn * d_attn).sum(-1, keepdim=True))
    d_thetaT = torch.matmul(phi, d_scores.transpose(1, 2))              # (B, Ca, Q)
    d_phiT = torch.matmul(theta, d_scores)                              # (B, Ca, K)
    return (d_thetaT.to(thetaT.dtype), d_phiT.to(phiT.dtype), d_gT.to(gT.dtype))


def attention_bwd_emulation(thetaT: torch.Tensor, phiT: torch.Tensor, gT: torch.Tensor,
                            doutT: torch.Tensor, tile: int = BWD_TILE
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's two-launch algorithm in plain torch, for testing
    it on the CPU.

    As csrc/attention_bwd.cu does, in float32 with scores in log2 units:
    the query side walks K in tiles of `tile` keys, key by key, keeping the
    running max m, sum l and t = sum e dA (pass 1, so c = t / l and
    lse = m + log2 l), then walks K again for dtheta (pass 2); the key side
    walks Q in tiles of `tile` queries, in order, accumulating dphi and dg
    from A = exp2(s - lse). Vectorised over the batch and the thread's own
    row; the walk over the other axis is the kernel's, one row at a time."""
    b, ca, q = thetaT.shape
    k = phiT.shape[2]
    theta, phi, g, dout = (t.float() for t in (thetaT, phiT, gT, doutT))
    theta2 = theta * LOG2E
    m = torch.full((b, q), float("-inf"))
    l = torch.zeros(b, q)
    t = torch.zeros(b, q)
    for k0 in range(0, k, tile):
        for j in range(k0, min(k0 + tile, k)):
            s = (theta2 * phi[:, :, j:j + 1]).sum(1)             # (B, Q)
            da = (dout * g[:, :, j:j + 1]).sum(1)
            m_new = torch.maximum(m, s)
            scale = torch.exp2(m - m_new)                        # 0 on the first key
            e = torch.exp2(s - m_new)
            l = l * scale + e
            t = t * scale + e * da
            m = m_new
    lse = m + torch.log2(l)
    c = t / l
    d_theta = torch.zeros(b, ca, q)
    for j in range(k):  # pass 2
        s = (theta2 * phi[:, :, j:j + 1]).sum(1)
        da = (dout * g[:, :, j:j + 1]).sum(1)
        ds = torch.exp2(s - lse) * (da - c)
        d_theta += ds[:, None, :] * phi[:, :, j:j + 1]
    d_phi = torch.zeros(b, ca, k)
    d_g = torch.zeros(b, g.shape[1], k)
    phi2 = phi * LOG2E
    for i in range(q):  # key side: the query tiles are walked in order
        s = (phi2 * theta[:, :, i:i + 1]).sum(1)                 # (B, K)
        da = (g * dout[:, :, i:i + 1]).sum(1)
        a = torch.exp2(s - lse[:, i:i + 1])
        ds = a * (da - c[:, i:i + 1])
        d_phi += ds[:, None, :] * theta[:, :, i:i + 1]
        d_g += a[:, None, :] * dout[:, :, i:i + 1]
    return (d_theta.to(thetaT.dtype), d_phi.to(phiT.dtype), d_g.to(gT.dtype))


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


def _check_kernel_operands(*named: tuple[str, torch.Tensor]) -> None:
    for name, t in named:
        # each batch's (C, N) block must be dense; the batch stride is free
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            raise ValueError(f"{name}: each batch's (C, N) block must be contiguous, "
                             f"strides {t.stride()}")
    if named[0][1].shape[0] > 65535:
        raise ValueError(f"batch {named[0][1].shape[0]} exceeds the kernel grid's 65535")


def _launch_kernel(thetaT: torch.Tensor, phiT: torch.Tensor,
                   gT: torch.Tensor) -> torch.Tensor:
    global launches
    b, ca, q = thetaT.shape
    cg, k = gT.shape[1], gT.shape[2]
    if (ca, cg) != (KERNEL_CA, KERNEL_CG):
        raise ValueError(f"the CUDA kernel takes Ca={KERNEL_CA}, Cg={KERNEL_CG}; "
                         f"got Ca={ca}, Cg={cg}")
    _check_kernel_operands(("thetaT", thetaT), ("phiT", phiT), ("gT", gT))
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


def _launch_backward(thetaT: torch.Tensor, phiT: torch.Tensor, gT: torch.Tensor,
                     doutT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel (two launches, one count): dthetaT, dphiT, dgT in
    the operands' dtype, dense."""
    global bwd_launches
    b, ca, q = thetaT.shape
    cg, k = gT.shape[1], gT.shape[2]
    if (ca, cg) != (KERNEL_CA, KERNEL_CG):
        raise ValueError(f"the CUDA kernel takes Ca={KERNEL_CA}, Cg={KERNEL_CG}; "
                         f"got Ca={ca}, Cg={cg}")
    if doutT.shape != (b, cg, q) or doutT.device != thetaT.device:
        raise ValueError(f"doutT {tuple(doutT.shape)} on {doutT.device} does not match "
                         f"the output (B, Cg, Q) = {(b, cg, q)} on {thetaT.device}")
    doutT = doutT.to(thetaT.dtype).contiguous()
    _check_kernel_operands(("thetaT", thetaT), ("phiT", phiT), ("gT", gT), ("doutT", doutT))
    lib = load_library()
    dev = thetaT.device
    d_thetaT = torch.empty((b, ca, q), dtype=thetaT.dtype, device=dev)
    d_phiT = torch.empty((b, ca, k), dtype=thetaT.dtype, device=dev)
    d_gT = torch.empty((b, cg, k), dtype=thetaT.dtype, device=dev)
    scratch = torch.empty((2, b, q), dtype=torch.float32, device=dev)  # lse, c per row
    err = lib.attention_bwd(
        thetaT.data_ptr(), phiT.data_ptr(), gT.data_ptr(), doutT.data_ptr(),
        d_thetaT.data_ptr(), d_phiT.data_ptr(), d_gT.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), b, q, k,
        thetaT.stride(0), phiT.stride(0), gT.stride(0), doutT.stride(0),
        _DTYPE_CODE[thetaT.dtype], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed with CUDA error {err}")
    bwd_launches += 1
    return d_thetaT, d_phiT, d_gT


class AttentionCore(torch.autograd.Function):
    """The kernel path with its gradient: the forward kernel, and the
    backward kernel on the saved (theta, phi, g), as the JAX custom VJP
    `_attention_op` saves them in `_attention_fwd`. The launchers are looked
    up when called, so a test can put the CPU emulations in their place."""

    @staticmethod
    def forward(ctx, thetaT, phiT, gT):
        ctx.save_for_backward(thetaT, phiT, gT)
        return _launch_kernel(thetaT, phiT, gT)

    @staticmethod
    def backward(ctx, doutT):
        return _launch_backward(*ctx.saved_tensors, doutT)


def nonlocal_attention_packed(thetaT: torch.Tensor, phiT: torch.Tensor,
                              gT: torch.Tensor) -> torch.Tensor:
    """thetaT (B, Ca, Q), phiT (B, Ca, K), gT (B, Cg, K) -> outT (B, Cg, Q).

    On CUDA the kernels through `AttentionCore`, which take Ca=8, Cg=32 and
    operands whose per-batch (C, N) blocks are dense (a channel slice of a
    wider projection is fine); on the CPU the plain version. Both carry
    gradients."""
    _check_operands(thetaT, phiT, gT)
    if thetaT.device.type == "cuda":
        return AttentionCore.apply(thetaT, phiT, gT)
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

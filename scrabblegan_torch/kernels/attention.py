"""Non-local attention core: the plain PyTorch versions and the CUDA kernels.

Port of the core of scrabblegan_tpu/kernels/attention.py: the Pallas TPU
kernels `_attention_kernel` (through `_pallas_forward`) and
`_attention_bwd_kernel` (through `_pallas_backward`) become the sm_90a CUDA
kernels in `scrabblegan_torch/csrc/attention_fwd.cu` (its walk over the keys
in `csrc/attention_mma.cuh`: on the tensor cores for bfloat16 operands, on
the CUDA cores for float32) and `attention_bwd.cu` (on the tensor cores for
both dtypes, float32 operands as three bfloat16 parts), joined by the autograd
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

The launch paths are capture-safe: they read nothing from the device
(`backward_plan` works from the shapes and the SM count), launch on the
current stream and take their output and scratch from `torch.empty`, so a
CUDA graph (train/graphs.py) captures them; the library is built and loaded
at the first eager call, before any capture. A capture counts its launches
once; `train/graphs.py` adds them again on every replay.
"""

from __future__ import annotations

import functools

import torch

from scrabblegan_torch.kernels.build import load_library

LOG2E = 1.4426950408889634
KERNEL_CA, KERNEL_CG = 8, 32  # the channel counts the kernel is written for
KEY_TILE, KEY_CHUNK = 128, 32  # csrc/attention_mma.cuh: kKt keys a tile, kKs a chunk
WARP_QUERIES = 32  # csrc/attention_mma.cuh: kWarpQ queries a warp on the tensor cores
MAX_SLACK = 8.0  # csrc/attention_mma.cuh: kSlack, log2 units the running max may lag by
# csrc/attention_bwd.cu: kWarps warps a block; kRows rows of scores a warp owns
# (queries in the statistics kernel, keys in the gradient kernel) and queries
# a step of the gradient kernel's walk; kKeys keys a block of the gradient
# kernel; kQt queries a tile of its walk; kStatsBlocksPerSm and
# kGradsBlocksPerSm blocks an SM the plan aims at for either kernel;
# Parts<T>::kParts bfloat16 parts an operand of that type is split into
BWD_WARPS, BWD_WARP_ROWS, BWD_KEYS, BWD_QUERY_TILE = 4, 16, 64, 128
BWD_STATS_BLOCKS_PER_SM, BWD_GRADS_BLOCKS_PER_SM = 2, 8
BWD_SMS = 132  # an H100's SMs: the plan of the CPU emulation
BWD_PARTS = {torch.float32: 3, torch.bfloat16: 1}
# Parts<T>::kRegParts: the parts A and dS, float32 in registers, are split into
BWD_REG_PARTS = {torch.float32: 3, torch.bfloat16: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0      # forward kernel launches since the last reset; the caller resets it
bwd_launches = 0  # backward kernel launches (one per backward call), likewise
bwd_dout_copies = 0  # backward calls whose cotangent had to be copied dense or cast first


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


def backward_plan(batch: int, q: int, k: int, sms: int = BWD_SMS) -> dict:
    """How the backward kernel cuts a call into blocks, from the shapes and the
    card's SM count alone, so that a small batch still fills the card:
    - `query_warps`: of the four warps of a block of the statistics kernel,
      how many split the block's queries (BWD_WARP_ROWS each); the others
      split the keys of every tile, chunk by chunk. Halved while the grid
      stays under BWD_STATS_BLOCKS_PER_SM blocks an SM.
    - `key_tiles`: blocks of BWD_KEYS keys of the gradient kernel;
    - `tiles_per_split`, `query_splits`: each such block walks
      `tiles_per_split` query tiles of BWD_QUERY_TILE, as few as give
      BWD_GRADS_BLOCKS_PER_SM blocks an SM; the splits' partial
      dphi and dg and the key tiles' partial dtheta are summed in order by
      the reduction kernel."""
    query_warps = BWD_WARPS
    while (query_warps > 1 and batch * -(-q // (BWD_WARP_ROWS * query_warps))
           < BWD_STATS_BLOCKS_PER_SM * sms):
        query_warps //= 2
    want = BWD_GRADS_BLOCKS_PER_SM * sms
    key_tiles = -(-k // BWD_KEYS)
    query_tiles = -(-q // BWD_QUERY_TILE)
    splits = min(query_tiles, max(1, -(-want // (batch * key_tiles))))
    tiles_per_split = -(-query_tiles // splits)
    return {"query_warps": query_warps, "key_tiles": key_tiles,
            "tiles_per_split": tiles_per_split,
            "query_splits": -(-query_tiles // tiles_per_split)}


def _bf16_parts(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """x (float32) as `parts` bfloat16 numbers whose sum approaches it: each
    the bfloat16 rounding of what the ones before left over."""
    out, rest = [], x
    for _ in range(parts):
        out.append(rest.bfloat16().float())
        rest = rest - out[-1]
    return out


def _parts_product(a: list[torch.Tensor], b: list[torch.Tensor], product) -> torch.Tensor:
    """sum of product(a[i], b[j]) over i + j < max(len(a), len(b)): every
    pair of parts whose product is not below the last part's weight, b's
    index outermost, as the kernel issues its mma instructions."""
    total = None
    for j in range(len(b)):
        for i in range(min(len(a), max(len(a), len(b)) - j)):
            term = product(a[i], b[j])
            total = term if total is None else total + term
    return total


def attention_bwd_emulation(thetaT: torch.Tensor, phiT: torch.Tensor, gT: torch.Tensor,
                            doutT: torch.Tensor, sms: int = BWD_SMS
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' algorithm in plain torch, for testing it on the CPU.

    As csrc/attention_bwd.cu does. Every product is a sum of bfloat16
    products with float32 sums, as the tensor cores form it: bfloat16 operands
    as they are, float32 operands as BWD_PARTS[float32] bfloat16 parts
    (`_bf16_parts`, `_parts_product`).
    1. Statistics, queries as rows: K in tiles of KEY_TILE keys and chunks of
       KEY_CHUNK; of a block's warps `query_warps` split the queries and the
       others the chunks. Each lane keeps, for its own columns of a chunk (2
       of every 8 keys), a running max m that moves only when a score
       exceeds it by more than MAX_SLACK log2 units, the sum l of exp2 and
       t = sum exp2 dA; the four lanes of a row, then the key groups, are
       merged in order: lse = m + log2 l (log2 units), c = t / l.
    2. Gradients, keys as rows: a block owns BWD_KEYS keys, a warp
       BWD_WARP_ROWS of them, and walks `tiles_per_split` query tiles in
       steps of BWD_WARP_ROWS queries: A = exp2(s - lse), dS = A (dA - c),
       both split into bfloat16 parts like the operands (one part: rounded)
       for dphi += dS^T theta, dg += A^T dout and the warp's dtheta = dS phi,
       which the block's warps sum in order per key tile.
    3. Reduction: dtheta over the key tiles and dphi, dg over the query
       splits, in order, then the cast to the operands' dtype."""
    b, ca, q = thetaT.shape
    cg, k = gT.shape[1], gT.shape[2]
    plan = backward_plan(b, q, k, sms)
    parts = BWD_PARTS[thetaT.dtype]
    theta, phi, g, dout = (_bf16_parts(t.float(), parts) for t in (thetaT, phiT, gT, doutT))
    rows_by_cols = lambda x, y: x.transpose(1, 2) @ y  # noqa: E731  (B, C, M), (B, C, N) -> (B, M, N)

    # 1. statistics
    groups = BWD_WARPS // plan["query_warps"]
    m = torch.full((b, q, groups, 4), -1e30)  # per key group and lane of the row's four
    l = torch.zeros(b, q, groups, 4)
    t = torch.zeros(b, q, groups, 4)
    for k0 in range(0, k, KEY_TILE):
        kn = min(KEY_TILE, k - k0)
        for chunk, j0 in enumerate(range(0, kn, KEY_CHUNK)):
            cols = slice(k0 + j0, min(k0 + j0 + KEY_CHUNK, k))
            pad = KEY_CHUNK - (cols.stop - cols.start)
            s = _parts_product(theta, [p[..., cols] for p in phi], rows_by_cols)
            da = _parts_product(dout, [p[..., cols] for p in g], rows_by_cols)
            s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
            da = torch.nn.functional.pad(da, (0, pad))
            # a lane's columns: 2 t, 2 t + 1 of each of the chunk's four 8-key tiles
            s, da = (x.view(b, q, KEY_CHUNK // 8, 4, 2).transpose(2, 3).reshape(b, q, 4, -1)
                     for x in (s, da))
            kg = chunk % groups
            moved = s.amax(-1) > m[:, :, kg] + MAX_SLACK / LOG2E
            m_new = torch.where(moved, s.amax(-1), m[:, :, kg])
            scale = torch.exp2((m[:, :, kg] - m_new) * LOG2E)
            p = torch.exp2(s * LOG2E - (m_new * LOG2E)[..., None])
            l[:, :, kg] = l[:, :, kg] * scale + p.sum(-1)
            t[:, :, kg] = t[:, :, kg] * scale + (p * da).sum(-1)
            m[:, :, kg] = m_new
    top = m.amax(-1, keepdim=True)  # the four lanes of a row: xor 1, then xor 2
    w = torch.exp2((m - top) * LOG2E)
    l, t = ((x * w)[..., 0::2] + (x * w)[..., 1::2] for x in (l, t))
    l, t, m = l[..., 0] + l[..., 1], t[..., 0] + t[..., 1], top[..., 0]
    top = m.amax(-1)  # the key groups, in order
    lsum, tsum = torch.zeros(b, q), torch.zeros(b, q)
    for kg in range(groups):
        w = torch.exp2((m[:, :, kg] - top) * LOG2E)
        lsum = lsum + l[:, :, kg] * w
        tsum = tsum + t[:, :, kg] * w
    lse = top * LOG2E + torch.log2(lsum)  # (B, Q), log2 units
    c = tsum / lsum

    # 2. gradients
    kt, splits, per = plan["key_tiles"], plan["query_splits"], plan["tiles_per_split"]
    k_pad = kt * BWD_KEYS
    phi_rows = [torch.nn.functional.pad(p, (0, k_pad - k)).transpose(1, 2)
                .reshape(b, -1, BWD_WARP_ROWS, ca) for p in phi]  # (B, warps, 16, Ca)
    dth_part = torch.zeros(b, kt, ca, q)
    dkv_part = torch.zeros(b, splits, ca + cg, k)
    for split in range(splits):
        q_lo = split * per * BWD_QUERY_TILE
        q_hi = min(q, q_lo + per * BWD_QUERY_TILE)
        for q0 in range(q_lo, q_hi, BWD_WARP_ROWS):
            sub = slice(q0, min(q0 + BWD_WARP_ROWS, q_hi))
            th_s, do_s = ([p[..., sub] for p in x] for x in (theta, dout))
            s = _parts_product(phi, th_s, rows_by_cols)  # (B, K, 16): keys are the rows
            da = _parts_product(g, do_s, rows_by_cols)
            a = torch.exp2(s * LOG2E - lse[:, None, sub])
            ds = a * (da - c[:, None, sub])
            a_p, ds_p = (_bf16_parts(x, BWD_REG_PARTS[thetaT.dtype]) for x in (a, ds))
            by_cols = lambda x, y: x @ y.transpose(1, 2)  # noqa: E731  (B, K, n), (B, C, n) -> (B, K, C)
            dkv_part[:, split, :ca] += _parts_product(ds_p, th_s, by_cols).transpose(1, 2)
            dkv_part[:, split, ca:] += _parts_product(a_p, do_s, by_cols).transpose(1, 2)
            ds_rows = [torch.nn.functional.pad(x, (0, 0, 0, k_pad - k))
                       .view(b, -1, BWD_WARP_ROWS, x.shape[-1]) for x in ds_p]
            warp_dth = _parts_product(ds_rows, phi_rows,
                                      lambda x, y: x.transpose(2, 3) @ y)  # (B, warps, n, Ca)
            warp_dth = warp_dth.view(b, kt, BWD_WARPS, -1, ca)
            tile_dth = warp_dth[:, :, 0]
            for wi in range(1, BWD_WARPS):  # the block's warps, in order
                tile_dth = tile_dth + warp_dth[:, :, wi]
            dth_part[..., sub] = tile_dth.transpose(2, 3)

    # 3. reduction, in order
    d_theta, d_kv = dth_part[:, 0], dkv_part[:, 0]
    for i in range(1, kt):
        d_theta = d_theta + dth_part[:, i]
    for i in range(1, splits):
        d_kv = d_kv + dkv_part[:, i]
    return (d_theta.to(thetaT.dtype), d_kv[:, :ca].to(phiT.dtype), d_kv[:, ca:].to(gT.dtype))


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


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_backward(thetaT: torch.Tensor, phiT: torch.Tensor, gT: torch.Tensor,
                     doutT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels (three launches, four for float32; one count):
    dthetaT, dphiT, dgT in the operands' dtype, dense. The float32 scratch
    (lse and c per query, the partial sums of `backward_plan`'s blocks) and,
    for float32 operands, their bfloat16 parts are allocated here."""
    global bwd_launches, bwd_dout_copies
    b, ca, q = thetaT.shape
    cg, k = gT.shape[1], gT.shape[2]
    if (ca, cg) != (KERNEL_CA, KERNEL_CG):
        raise ValueError(f"the CUDA kernel takes Ca={KERNEL_CA}, Cg={KERNEL_CG}; "
                         f"got Ca={ca}, Cg={cg}")
    if doutT.shape != (b, cg, q) or doutT.device != thetaT.device:
        raise ValueError(f"doutT {tuple(doutT.shape)} on {doutT.device} does not match "
                         f"the output (B, Cg, Q) = {(b, cg, q)} on {thetaT.device}")
    dense = doutT.to(thetaT.dtype).contiguous()  # no copy if it is dense and of the dtype
    bwd_dout_copies += dense is not doutT
    doutT = dense
    _check_kernel_operands(("thetaT", thetaT), ("phiT", phiT), ("gT", gT), ("doutT", doutT))
    lib = load_library()
    dev = thetaT.device
    plan = backward_plan(b, q, k, _sm_count(dev))
    d_thetaT = torch.empty((b, ca, q), dtype=thetaT.dtype, device=dev)
    d_phiT = torch.empty((b, ca, k), dtype=thetaT.dtype, device=dev)
    d_gT = torch.empty((b, cg, k), dtype=thetaT.dtype, device=dev)
    sizes = (b * q, b * q, b * plan["key_tiles"] * ca * q,  # lse, c, partial dtheta,
             b * plan["query_splits"] * (ca + cg) * k)      # partial dphi and dg
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    starts = (0, sizes[0], sizes[0] + sizes[1], sizes[0] + sizes[1] + sizes[2])
    planes = None
    if thetaT.dtype == torch.float32:  # theta, phi, g, dout in bfloat16 parts, rows padded to 8
        planes = torch.empty(BWD_PARTS[torch.float32] * b * (ca + cg) * (-(-q // 8) + -(-k // 8)) * 8,
                             dtype=torch.bfloat16, device=dev)
    err = lib.attention_bwd(
        thetaT.data_ptr(), phiT.data_ptr(), gT.data_ptr(), doutT.data_ptr(),
        d_thetaT.data_ptr(), d_phiT.data_ptr(), d_gT.data_ptr(),
        *(scratch.data_ptr() + 4 * at for at in starts),
        planes.data_ptr() if planes is not None else None,
        b, q, k, thetaT.stride(0), phiT.stride(0), gT.stride(0), doutT.stride(0),
        plan["query_warps"], plan["tiles_per_split"],
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

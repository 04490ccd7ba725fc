"""The per-character filter bank (the paper's "spatial embedding").

Port of scrabblegan_tpu/ops/embedding.py (FilterBank.contract). The bank is
(V, 32, 8192), V = vocabulary plus any PAD row. `contract` is the one-hot
matrix product (B*L, V*32) @ (V*32, 8192), which reads the bank once. The
gather form, bank[ids], would materialise (B, L, 32, 8192): 5.4 GB in bf16 at
batch 1024, length 10.
"""

from __future__ import annotations

import torch
from torch import nn

from scrabblegan_torch.ops.layers import FlaxLeaf
from scrabblegan_torch.parallel.tp import split_call


class FilterBank(nn.Module):
    def __init__(self, vocab_size: int, filter_dim: tuple[int, int] = (32, 8192),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.bank = nn.Parameter(torch.zeros(vocab_size, *filter_dim, device=device))

    def flax_leaves(self) -> list[FlaxLeaf]:
        return [FlaxLeaf("params", ("filter_bank",), "bank", "same", "glorot_uniform")]

    def contract(self, ids: torch.Tensor, z0: torch.Tensor) -> torch.Tensor:
        """(B, L) ids, (B, k) z0 -> (B, L, d) in the compute dtype.

        Equals einsum('bk,blkd->bld', z0, bank[ids]). An id outside the bank
        gives a zero row, as jax.nn.one_hot does."""
        v, k, d = self.bank.shape
        b, length = ids.shape
        onehot = (ids.reshape(-1, 1) == torch.arange(v, device=ids.device)).to(self.dtype)
        z0_rows = z0.to(self.dtype)[:, None, :].expand(b, length, k).reshape(b * length, k)
        # a[r, v*k + k'] = onehot[r, v] * z0[row's batch, k']: exact 0/1 scaling
        a = (onehot[:, :, None] * z0_rows[:, None, :]).reshape(b * length, v * k)
        # under tensor parallelism this rank's slice of the 8192 axis, gathered
        # back before the seed reshape (parallel/tp.py)
        out = split_call(self, lambda a, bank, _: a @ bank.reshape(v * k, -1), a,
                         self.bank.to(self.dtype), None, 2, -1)
        return out.reshape(b, length, d)

"""ScrabbleGAN gradient balancing.

Port of scrabblegan_tpu/ops/balance.py. Every std here is the population std
(jnp.std; torch's default is the unbiased one), over the global batch in a
parallel step (parallel/mesh.py `global_pstd`), the cotangents' stds of
the fanout's backward included.

- `gradient_balance`: the reference's loss rescaling; the CTC-on-fake loss
  is scaled by std(g_loss) / std(r_fake) over the batch.
- `balance_image_gradients` and `balanced_fanout`: the paper's gradient
  balancing on the generated image. The fanout returns the image twice; its
  backward combines the two branches' cotangents as adv + alpha * std(adv) /
  (std(ctc) + eps) * ctc instead of summing them.
"""

from __future__ import annotations

import torch

from scrabblegan_torch.parallel.mesh import current, global_pstd, use_step


def _pstd(x: torch.Tensor) -> torch.Tensor:
    return global_pstd(x)  # torch.std(x, correction=0) outside a parallel step


def gradient_balance(r_fake: torch.Tensor, g_loss: torch.Tensor, alpha: float = 1.0):
    """-> (g_balanced, r_balanced, alpha, r_fake_std, g_loss_std)."""
    r_fake_std = _pstd(r_fake)
    g_loss_std = _pstd(g_loss)
    r_balanced = alpha * (g_loss_std / r_fake_std) * r_fake
    return g_loss + r_balanced, r_balanced, alpha, r_fake_std, g_loss_std


def balance_image_gradients(adv_cot: torch.Tensor, ctc_cot: torch.Tensor,
                            alpha: float = 1.0, eps: float = 1e-12):
    """-> (adv + scale * ctc, scale), scale = alpha * std(adv) / (std(ctc) + eps)."""
    scale = alpha * _pstd(adv_cot) / (_pstd(ctc_cot) + eps)
    return adv_cot + scale * ctc_cot, scale


class _BalancedFanout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, imgs, alpha):
        ctx.alpha = alpha
        ctx.step = current()  # a card's backward runs on another thread
        return imgs.clone(), imgs.clone()

    @staticmethod
    def backward(ctx, cot_adv, cot_ctc):
        # a branch that feeds nothing arrives as zeros, as in JAX
        with use_step(ctx.step):
            return balance_image_gradients(cot_adv, cot_ctc, ctx.alpha)[0], None


def balanced_fanout(imgs: torch.Tensor, alpha: float = 1.0):
    """(imgs, imgs): route the adversarial terms through the first and the
    CTC-on-fake term through the second; their cotangents meet balanced."""
    return _BalancedFanout.apply(imgs, alpha)

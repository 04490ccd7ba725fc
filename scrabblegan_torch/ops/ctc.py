"""Per-sample CTC loss with the blank as the last class.

Port of scrabblegan_tpu/ops/ctc.py, which calls optax.ctc_loss with
blank_id = K - 1 on float32 logits. Here `F.ctc_loss` runs on
log_softmax(logits) in its (T, B, K) layout with reduction='none'. Lengths
are always passed: padded labels carry the PAD id (n_classes = 52), which is
the blank (K - 1 = 52), so no value past a label length may be read as a
label.

The two differ where no alignment exists (a label needs more frames than the
logits have: T < L + the number of repeated neighbours). optax returns a
finite loss there, floored by its log epsilon, and F.ctc_loss returns inf
(zero_infinity is off, so the fault shows). The train step never builds such
a case: T = 4L - 1 >= 2L - 1, the most any label of length L needs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """logits (B, T, K) pre-softmax, blank K - 1; labels (B, L) ints in
    [0, K - 1); logit_lengths, label_lengths (B,) -> (B,) negative
    log-likelihoods, float32."""
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, K)
    return F.ctc_loss(log_probs, labels.long(), logit_lengths.long(), label_lengths.long(),
                      blank=logits.shape[-1] - 1, reduction="none", zero_infinity=False)

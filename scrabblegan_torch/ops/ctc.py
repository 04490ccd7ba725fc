"""Per-sample CTC loss with the blank as the last class.

Port of scrabblegan_tpu/ops/ctc.py, which calls optax.ctc_loss with
blank_id = K - 1 on float32 logits. This is optax's own algorithm
(`ctc_loss_with_forward_probs`) in plain PyTorch, not `F.ctc_loss`: the
log-space alpha recursion over every frame, blank and label states apart,
frames past a sample's logit length and labels past its label length
masked as optax's paddings mask them, log(0) taken as `LOG_EPSILON`, all
in float32. Autograd differentiates it.

So it gives optax's values where no alignment exists (a label that needs
more frames than the logits have): a finite loss floored by the log
epsilon, where `F.ctc_loss` gives inf. And it reads its lengths on the
device: `F.ctc_loss` copies them to the host, which a CUDA graph cannot
capture. The recursion runs over the logits' full T whatever the lengths,
about fifteen small operations a frame. Each state's emission is picked
from the log-probabilities by a one-hot product, not `torch.gather`: the
gather's backward adds the gradients of repeated labels (and of every
padding position, which holds the blank's id) with atomics on the card, in
an order that changes from run to run, where the product's backward is a
fixed-order sum. The values are the same (one term of a sum of zeros).
"""

from __future__ import annotations

import torch

LOG_EPSILON = -1e5  # optax's default log_epsilon


def _add_to_phi(phi: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """optax's update_phi_score: phi[:, 1:] <- logaddexp(phi[:, 1:], score)."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=1)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """logits (B, T, K) pre-softmax, blank K - 1; labels (B, N) ints in
    [0, K); logit_lengths, label_lengths (B,) -> (B,) negative
    log-likelihoods, float32."""
    b, t, k = logits.shape
    n = labels.shape[1]
    device = logits.device
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    label_lens = label_lengths.long().clamp(0, n)
    frame_pad = (torch.arange(t, device=device)[:, None]
                 >= logit_lengths.long()[None, :])[:, :, None]           # (T, B, 1)

    repeat = torch.cat([(labels[:, :-1] == labels[:, 1:]).float(),
                        torch.zeros(b, 1, device=device)], dim=1)         # (B, N)
    eps_repeat = LOG_EPSILON * repeat
    eps_not_repeat = LOG_EPSILON * (1.0 - repeat)
    lp_phi = logprobs[:, :, k - 1:k].transpose(0, 1)                    # (T, B, 1)
    onehot = (labels[:, :, None] == torch.arange(k, device=device)).float()  # (B, N, K)
    lp_emit = (logprobs[:, :, None, :] * onehot[:, None]).sum(-1).transpose(0, 1)  # (T, B, N)

    phi = torch.cat([torch.zeros(b, 1, device=device),
                     torch.full((b, n), LOG_EPSILON, device=device)], dim=1)
    emit = torch.full((b, n), LOG_EPSILON, device=device)
    for i in range(t):
        # emit-to-phi epsilon transition, except into a repeated label
        phi_in = _add_to_phi(phi, emit + eps_repeat)
        # phi-to-emit and emit self-loop
        next_emit = torch.logaddexp(phi_in[:, :-1] + lp_emit[i], emit + lp_emit[i])
        # blank self-loop, and emit-to-phi through a blank only before a repetition
        next_phi = _add_to_phi(phi_in + lp_phi[i], emit + lp_phi[i] + eps_not_repeat)
        emit = torch.where(frame_pad[i], emit, next_emit)
        phi = torch.where(frame_pad[i], phi, next_phi)
    last = _add_to_phi(phi, emit)  # the last epsilon transition
    return -torch.gather(last, 1, label_lens[:, None])[:, 0]

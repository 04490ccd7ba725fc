"""Per-sample CTC loss, blank = the last class, in plain PyTorch.

optax's `ctc_loss` recursion (Graves et al., 2006, in log space): blank and
label states apart, frames past a sample's logit length and labels past its
label length masked, log(0) taken as -1e5, float32. Where no alignment
exists the loss is finite, floored by that log epsilon.
"""

from __future__ import annotations

import torch

LOG_EPSILON = -1e5


def _add_to_phi(phi: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=1)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """logits (B, T, K), labels (B, N), lengths (B,) -> (B,) negative
    log-likelihoods."""
    b, t, k = logits.shape
    n = labels.shape[1]
    device = logits.device
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    label_lens = label_lengths.long().clamp(0, n)
    frame_pad = (torch.arange(t, device=device)[:, None]
                 >= logit_lengths.long()[None, :])[:, :, None]
    repeat = torch.cat([(labels[:, :-1] == labels[:, 1:]).float(),
                        torch.zeros(b, 1, device=device)], dim=1)
    eps_repeat = LOG_EPSILON * repeat
    eps_not_repeat = LOG_EPSILON * (1.0 - repeat)
    lp_phi = logprobs[:, :, k - 1:k].transpose(0, 1)
    onehot = (labels[:, :, None] == torch.arange(k, device=device)).float()
    lp_emit = (logprobs[:, :, None, :] * onehot[:, None]).sum(-1).transpose(0, 1)
    phi = torch.cat([torch.zeros(b, 1, device=device),
                     torch.full((b, n), LOG_EPSILON, device=device)], dim=1)
    emit = torch.full((b, n), LOG_EPSILON, device=device)
    for i in range(t):
        phi_in = _add_to_phi(phi, emit + eps_repeat)
        next_emit = torch.logaddexp(phi_in[:, :-1] + lp_emit[i], emit + lp_emit[i])
        next_phi = _add_to_phi(phi_in + lp_phi[i], emit + lp_phi[i] + eps_not_repeat)
        emit = torch.where(frame_pad[i], emit, next_emit)
        phi = torch.where(frame_pad[i], phi, next_phi)
    last = _add_to_phi(phi, emit)
    return -torch.gather(last, 1, label_lens[:, None])[:, 0]

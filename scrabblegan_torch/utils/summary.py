"""Parameter counts of the four networks, the table `Trainer.init_state`
prints: the port's counterpart of scrabblegan_tpu/utils/summary.py
`summarize_state`. Counts are over parameters, not buffers (BN statistics,
spectral norm's u and sigma), as JAX counts the `params` collection."""

from __future__ import annotations


def summarize_state(state, verbose_print=print) -> dict[str, int]:
    """Print and return {network: parameter count} of a TrainState."""
    counts = {}
    for net, module in zip(("generator", "discriminator", "recognizer", "style_promoter"),
                           state.modules().values()):
        counts[net] = sum(p.numel() for p in module.parameters())
        verbose_print(f"  {net:<16} {counts[net] / 1e6:7.2f}M params")
    verbose_print(f"  {'total':<16} {sum(counts.values()) / 1e6:7.2f}M params")
    return counts

"""Training in the port: optimizers, train state, the four-network step,
checkpoints, the epoch Trainer (`loop`) and its entry point
(`python -m scrabblegan_torch.train`, `main`)."""

from scrabblegan_torch.train.cli import main

__all__ = ["main"]

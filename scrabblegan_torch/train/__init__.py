"""The train step of the port: optimizers, train state, the four-network step
and its entry point (`python -m scrabblegan_torch.train`, `main`)."""

from scrabblegan_torch.train.cli import main

__all__ = ["main"]

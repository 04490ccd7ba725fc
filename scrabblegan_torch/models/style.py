"""The style promoter W, NCHW.

Port of scrabblegan_tpu/models/style.py (`StylePromoter`): a third adversary
with the discriminator's architecture and flax scope names (trunk, head) and
parameters of its own, trained to tell target-style images from others.

The style extractor (`StyleExtractor`, built nowhere on the train path) is not
ported yet.
"""

from __future__ import annotations

from scrabblegan_torch.models.discriminator import Discriminator


class StylePromoter(Discriminator):
    """W: x (B, C, 32, W) -> logits (B,), float32."""

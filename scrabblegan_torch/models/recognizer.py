"""The conv CRNN recognizer R, NCHW.

Port of scrabblegan_tpu/models/recognizer.py (`Recognizer`): conv64 ->
pool(2,2) -> conv128 -> pool(2,2) -> conv256 -> conv256 -> pool(2,1) ->
conv512 -> BN -> conv512 -> BN -> pool(2,1) -> conv512 2x2 VALID -> per-frame
Dense(num_classes). The convs are plain flax `nn.Conv` (bias, no spectral
norm); bn5 and bn6 are flax BatchNorm with scale and bias, after the relu as
in JAX. The width falls to W/4 - 1 frames: T = 4L - 1 for 16 px a character
(`ctc_time_steps`). Logits are float32.

The BiLSTM variant (`shared.my_rec`) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.ops.blocks import BatchNorm
from scrabblegan_torch.ops.layers import Conv, Dense


def ctc_time_steps(width: int) -> int:
    """Frames the conv recognizer produces for an input of pixel width `width`."""
    return width // 4 - 1


class Recognizer(nn.Module):
    """x (B, C, 32, W) -> frame logits (B, W/4 - 1, num_classes), or with
    return_features the per-image mean of the 512-d frame features."""

    def __init__(self, num_classes: int, img_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(img_channels, 64, **kw)
        self.conv2 = Conv(64, 128, **kw)
        self.conv3 = Conv(128, 256, **kw)
        self.conv4 = Conv(256, 256, **kw)
        self.conv5 = Conv(256, 512, **kw)
        self.bn5 = BatchNorm(512, device=device)
        self.conv6 = Conv(512, 512, **kw)
        self.bn6 = BatchNorm(512, device=device)
        self.conv7 = Conv(512, 512, (2, 2), padding="valid", **kw)
        self.frame_logits = Dense(512, num_classes, **kw)

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        net = torch.relu(self.conv1(x.to(self.dtype)))
        net = F.max_pool2d(net, 2)
        net = F.max_pool2d(torch.relu(self.conv2(net)), 2)
        net = torch.relu(self.conv3(net))
        net = torch.relu(self.conv4(net))
        net = F.max_pool2d(net, (2, 1))
        net = self.bn5(torch.relu(self.conv5(net)))
        net = self.bn6(torch.relu(self.conv6(net)))
        net = F.max_pool2d(net, (2, 1))
        net = torch.relu(self.conv7(net))           # (B, 512, 1, T)
        net = net[:, :, 0].transpose(1, 2)          # (B, T, 512)
        if return_features:
            return net.mean(dim=1).float()
        return self.frame_logits(net).float()

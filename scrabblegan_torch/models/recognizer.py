"""The conv CRNN recognizer R, NCHW.

Port of scrabblegan_tpu/models/recognizer.py (`Recognizer`): conv64 ->
pool(2,2) -> conv128 -> pool(2,2) -> conv256 -> conv256 -> pool(2,1) ->
conv512 -> BN -> conv512 -> BN -> pool(2,1) -> conv512 2x2 VALID -> per-frame
Dense(num_classes). The convs are plain flax `nn.Conv` (bias, no spectral
norm); bn5 and bn6 are flax BatchNorm with scale and bias, after the relu as
in JAX. The width falls to W/4 - 1 frames: T = 4L - 1 for 16 px a character
(`ctc_time_steps`). Logits are float32.

The BiLSTM variant (`shared.my_rec`, `BiLSTMRecognizer`): seven plain 3x3
convs (16..144) each with flax BatchNorm and LeakyReLU 0.01, dropout 0.2
before the convs of blocks 3-7, five bidirectional LSTM(256) layers each
after a dropout 0.5, dropout 0.5 and a per-frame Dense. T = W / 4 frames;
the train step still feeds 4L - 1 input frames, which masks the last one.
The LSTM runs in float32 with float32 parameters whatever `shared.dtype`,
as JAX's `OptimizedLSTMCell`, built without a dtype, promotes to its float32
parameters. Dropout draws from the open `ops/dropout.py` stream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scrabblegan_torch.ops.blocks import BatchNorm
from scrabblegan_torch.ops.dropout import dropout
from scrabblegan_torch.ops.layers import Conv, Dense, FlaxLeaf

LSTM_FEATURES = 256
GATES = "ifgo"  # flax's and torch's order of the LSTM's gates


def ctc_time_steps(width: int, my_rec: bool = False) -> int:
    """Frames the recognizer produces for an input of pixel width `width`:
    W / 4 - 1 for the conv one, W / 4 for the BiLSTM one."""
    return width // 4 if my_rec else width // 4 - 1


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


class LSTMCellParams(nn.Module):
    """The parameters of one flax `OptimizedLSTMCell`, one torch parameter a
    flax leaf: input kernels i{gate} (no bias), hidden kernels h{gate} with
    biases. The flax tree names the cells of a recognizer
    OptimizedLSTMCell_0, _1, ... in the order they were built: layer l's
    forward cell is 2l, its backward cell 2l + 1."""

    def __init__(self, in_features: int, features: int = LSTM_FEATURES, device=None):
        super().__init__()
        for gate in GATES:
            self.register_parameter(f"i{gate}", nn.Parameter(
                torch.zeros(features, in_features, device=device)))
            self.register_parameter(f"h{gate}", nn.Parameter(
                torch.zeros(features, features, device=device)))
            self.register_parameter(f"h{gate}_bias", nn.Parameter(
                torch.zeros(features, device=device)))

    def flax_leaves(self) -> list[FlaxLeaf]:
        leaves = []
        for gate in GATES:
            leaves += [FlaxLeaf("params", (f"i{gate}", "kernel"), f"i{gate}", "dense",
                                "lecun_normal"),
                       FlaxLeaf("params", (f"h{gate}", "kernel"), f"h{gate}", "dense",
                                "orthogonal"),
                       FlaxLeaf("params", (f"h{gate}", "bias"), f"h{gate}_bias", "same")]
        return leaves

    def weights(self, zero_bias: torch.Tensor) -> list[torch.Tensor]:
        """torch's (w_ih, w_hh, b_ih, b_hh) of one direction: the gates
        stacked in order; the input side has no bias, so b_ih is zero."""
        cat = lambda prefix, suffix="": torch.cat(  # noqa: E731
            [getattr(self, f"{prefix}{gate}{suffix}") for gate in GATES])
        return [cat("i"), cat("h"), zero_bias, cat("h", "_bias")]


class BiLSTMRecognizer(nn.Module):
    """The `my_rec` variant: x (B, C, 32, W) -> frame logits (B, W/4,
    num_classes), float32."""

    CONVS = (16, 32, 48, 64, 80, 128, 144)
    POOLS = {1: (2, 2), 2: (2, 2), 3: (2, 1), 4: (2, 1), 5: (2, 1)}  # after block n
    LAYERS = 5

    def __init__(self, num_classes: int, img_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        cin = img_channels
        for idx, feats in enumerate(self.CONVS, start=1):
            self.add_module(f"conv_{idx}", Conv(cin, feats, dtype=dtype, device=device))
            self.add_module(f"bn_{idx}", BatchNorm(feats, device=device))
            cin = feats
        for layer in range(self.LAYERS):
            in_features = cin if layer == 0 else 2 * LSTM_FEATURES
            for cell in (2 * layer, 2 * layer + 1):
                self.add_module(f"OptimizedLSTMCell_{cell}",
                                LSTMCellParams(in_features, device=device))
        self.register_buffer("zero_bias", torch.zeros(4 * LSTM_FEATURES, device=device),
                             persistent=False)
        self.frame_logits = Dense(2 * LSTM_FEATURES, num_classes, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eval_mode = not self.training
        net = x.to(self.dtype)
        for idx in range(1, len(self.CONVS) + 1):
            if idx >= 3:
                net = dropout(net, 0.2, eval_mode)
            net = getattr(self, f"bn_{idx}")(getattr(self, f"conv_{idx}")(net))
            net = F.leaky_relu(net, 0.01)
            if idx in self.POOLS:
                net = F.max_pool2d(net, self.POOLS[idx])
        net = net[:, :, 0].transpose(1, 2).float()   # (B, T, 144); the LSTM runs in float32
        zeros = net.new_zeros(2, net.shape[0], LSTM_FEATURES)
        for layer in range(self.LAYERS):
            net = dropout(net, 0.5, eval_mode)
            weights = [w for cell in (2 * layer, 2 * layer + 1) for w in
                       getattr(self, f"OptimizedLSTMCell_{cell}").weights(self.zero_bias)]
            net = torch.lstm(net, (zeros, zeros), weights, True, 1, 0.0, self.training,
                             True, True)[0]
        net = dropout(net, 0.5, eval_mode)
        return self.frame_logits(net).float()

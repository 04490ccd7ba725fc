"""The ScrabbleGAN networks in plain PyTorch, as functions of a dict of tensors.

The benchmark's reference: it imports nothing but torch. Each network reads
its weights and statistics from a dict keyed by the names the benchmark gave
them (the layout of the program's `state_dict`), so the same seeded tensors
feed both sides. The mathematics follows the published ScrabbleGAN (Fogel et
al., CVPR 2020) as the repository trains it (flax semantics):

- spectral norm: the kernel as a (-1, out) matrix, one power-iteration step
  from the stored u on every call (u and v constants), W / sigma; eps 1e-12;
- batch norm: batch moments over (N, H, W) in train mode with the fast
  variance max(0, E[x^2] - E[x]^2), running statistics in eval mode; eps
  1e-5, running update 0.99 old + 0.01 new;
- conditional batch norm: a non-affine batch norm, then gamma and beta from
  SN-Dense layers on the block's 32-d z chunk;
- G: a filter bank contracted with z0 (one 512 x 4 x 4 seed a character), three
  up-blocks 256/128/64 at strides (2,2), (2,2), (2,1), a non-local block after
  the third, BN, relu, a 3x3 SN conv, tanh;
- D and W: four down-blocks 64/512/1024/1024 with a non-local block after the
  first, relu, a global average pool (masked by width in padded mode), an
  SN-Dense(1) head; the DCGAN D: four stride-2 SN convs 16-128 with LeakyReLU
  0.3 and a non-local block after the second;
- R: the conv CRNN (64-512, two BNs) or the BiLSTM recognizer (seven convs
  16-144 with BN and LeakyReLU 0.01, hash dropout, five bidirectional
  LSTM(256) layers in float32).

`Net.prec` is the precision the network computes in: 'float32' (the
reference; TF32 is switched off by the caller), 'bfloat16', or 'fp8' (every
operand of a convolution and a matrix product rounded to float8 e4m3 with one
scale a tensor, the rest in bfloat16), which the controls use. Weights are
float32; every layer rounds its input and its weight to the precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SN_EPS = 1e-12
BN_EPS = 1e-5
BN_MOMENTUM = 0.99
GEN_IN = (512, 256, 128)
GEN_OUT = (256, 128, 64)
DISC_IN = (1, 64, 512, 1024)
DISC_OUT = (64, 512, 1024, 1024)
DCGAN_FEATURES = (16, 32, 64, 128)
BILSTM_CONVS = (16, 32, 48, 64, 80, 128, 144)
BILSTM_POOLS = {1: (2, 2), 2: (2, 2), 3: (2, 1), 4: (2, 1), 5: (2, 1)}
LSTM_FEATURES = 256
FP8_MAX = 448.0


def compute_dtype(prec: str) -> torch.dtype:
    if prec not in ("float32", "bfloat16", "fp8"):
        raise ValueError(f"unknown precision {prec!r}")
    return torch.float32 if prec == "float32" else torch.bfloat16


def quant(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x rounded to `prec`, in the compute dtype of `prec`."""
    if prec == "fp8":
        xf = x.float()
        scale = xf.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (xf / scale).to(torch.float8_e4m3fn).float() * scale
        return (xf + (rounded - xf).detach()).to(torch.bfloat16)  # straight-through
    return x.to(compute_dtype(prec))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """lax 'SAME' padding (low, high) of one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def transpose_padding(k: int, s: int) -> tuple[int, int]:
    """(padding, output_padding) of F.conv_transpose2d giving lax's 'SAME'
    transposed conv with the kernel stored flipped; the output is cropped to
    input * stride."""
    pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
    padding = k - 1 - pad_a
    return padding, max(0, s - k + 2 * padding)


class Net:
    """One network's pass: its tensors, precision and mode.

    `record`, when given in train mode, receives the statistics the pass
    computes ({tensor name: new value}); the caller decides which passes'
    statistics are kept, as the train step does."""

    def __init__(self, tensors: dict, prec: str = "float32", train: bool = False,
                 record: dict | None = None, momentum: float = BN_MOMENTUM):
        self.t = tensors
        self.momentum = momentum
        self.prec = prec
        self.dt = compute_dtype(prec)
        self.train = train
        self.record = record

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return quant(x, self.prec)

    def _propose(self, name: str, value: torch.Tensor) -> None:
        if self.train and self.record is not None:
            self.record[name] = value.detach()

    def weight(self, pre: str, out_axis: int = 0) -> torch.Tensor:
        w = self.t[pre + ".weight"].float()
        u = self.t.get(pre + ".u")
        if u is None:
            return w
        mat = w.movedim(out_axis, -1).reshape(-1, w.shape[out_axis])
        with torch.no_grad():
            v = l2_normalize(u.float() @ mat.T)
            u_new = l2_normalize(v @ mat)
        sigma = ((v @ mat) @ u_new.T)[0, 0]
        self._propose(pre + ".u", u_new)
        self._propose(pre + ".sigma", sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def bias(self, pre: str) -> torch.Tensor | None:
        b = self.t.get(pre + ".bias")
        return None if b is None else b.to(self.dt)

    def conv(self, pre: str, x: torch.Tensor, padding: str = "same",
             strides: tuple[int, int] = (1, 1)) -> torch.Tensor:
        w = self.q(self.weight(pre))
        x = self.q(x)
        if padding == "same" and strides != (1, 1):
            kh, kw = w.shape[2:]
            x = F.pad(x, (*same_padding(x.shape[3], kw, strides[1]),
                          *same_padding(x.shape[2], kh, strides[0])))
            return F.conv2d(x, w, self.bias(pre), stride=strides)
        return F.conv2d(x, w, self.bias(pre), padding=padding, stride=strides)

    def conv_transpose(self, pre: str, x: torch.Tensor, strides: tuple[int, int]) -> torch.Tensor:
        w = self.q(self.weight(pre, out_axis=1))
        pads = [transpose_padding(k, s) for k, s in zip(w.shape[2:], strides)]
        y = F.conv_transpose2d(self.q(x), w, self.bias(pre), stride=strides,
                               padding=tuple(p for p, _ in pads),
                               output_padding=tuple(o for _, o in pads))
        return y[..., : x.shape[2] * strides[0], : x.shape[3] * strides[1]]

    def dense(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.q(x), self.q(self.weight(pre)), self.bias(pre))

    def batch_norm(self, pre: str, x: torch.Tensor, affine: bool = True) -> torch.Tensor:
        xf = x.float()
        if self.train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self._propose(pre + ".running_mean", m * self.t[pre + ".running_mean"]
                              + (1 - m) * mean)
                self._propose(pre + ".running_var", m * self.t[pre + ".running_var"]
                              + (1 - m) * var)
        else:
            mean, var = self.t[pre + ".running_mean"], self.t[pre + ".running_var"]
        mul = torch.rsqrt(var + BN_EPS)
        if affine:
            mul = mul * self.t[pre + ".weight"]
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        if affine:
            y = y + self.t[pre + ".bias"][None, :, None, None]
        return y.to(x.dtype)

    def attention(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        """SAGAN non-local block: theta (C/8) on every position, phi (C/8)
        and g (C/2) max-pooled 2x2, softmax over the pooled keys in float32,
        the out 1x1 conv, sigma * out + x."""
        b, c, h, w = x.shape
        theta = self.conv(pre + ".theta", x).reshape(b, c // 8, h * w)
        phi = F.max_pool2d(self.conv(pre + ".phi", x), 2).reshape(b, c // 8, -1)
        g = F.max_pool2d(self.conv(pre + ".g", x), 2).reshape(b, c // 2, -1)
        scores = torch.matmul(self.q(theta).float().transpose(1, 2), self.q(phi).float())
        attn = torch.softmax(scores, dim=-1)
        out = torch.matmul(self.q(g), self.q(attn).transpose(1, 2)).reshape(b, c // 2, h, w)
        return self.t[pre + ".sigma"].to(self.dt) * self.conv(pre + ".out", out) + x.to(self.dt)

    # ------------------------------------------------------------ blocks
    def cbn(self, pre: str, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.batch_norm(pre, x, affine=False)
        gamma = self.dense(pre + ".gamma", cond)[:, :, None, None]
        beta = self.dense(pre + ".beta", cond)[:, :, None, None]
        return h * gamma + beta

    def block_up(self, pre: str, x: torch.Tensor, cond: torch.Tensor, last: bool) -> torch.Tensor:
        strides = (2, 1) if last else (2, 2)
        h = torch.relu(self.cbn(pre + ".cbn1", x, cond))
        h = self.conv_transpose(pre + ".upconv", h, strides)
        h = torch.relu(self.cbn(pre + ".cbn2", h, cond))
        h = self.conv(pre + ".conv", h)
        return h + self.conv_transpose(pre + ".skip", x, strides)

    def block_down(self, pre: str, x: torch.Tensor, last: bool) -> torch.Tensor:
        h = self.conv(pre + ".conv1", torch.relu(x))
        h = self.conv(pre + ".conv2", torch.relu(h))
        skip = self.conv(pre + ".skip", x)
        if last:
            return h + skip
        return F.avg_pool2d(h, 2) + F.avg_pool2d(skip, 2)


# ---------------------------------------------------------------- networks
def style_encoder(net: Net, style_imgs: torch.Tensor, pre: str = "style_encoder") -> torch.Tensor:
    """(B, 1, 32, W) -> z (B, 128) in the net's compute dtype."""
    x = net.block_down(pre + ".block1", style_imgs.to(net.dt), last=False)
    x = net.attention(pre + ".attn", x)
    for idx in (2, 3, 4):
        x = net.block_down(f"{pre}.block{idx}", x, last=idx == 4)
    pooled = torch.relu(x).float().mean(dim=(2, 3))
    return net.dense(pre + ".proj", pooled)


def generator(net: Net, labels: torch.Tensor, z: torch.Tensor | None = None,
              lengths: torch.Tensor | None = None, style_imgs: torch.Tensor | None = None,
              style_net: Net | None = None) -> torch.Tensor:
    """labels (B, L) -> images (B, 1, 32, 16L) in [-1, 1], the net's compute
    dtype. z (B, 128), or style images encoded by `style_net`."""
    if z is None:
        z = style_encoder(style_net, style_imgs)
    z = z.to(net.dt)
    z0, *z_blocks = torch.split(z, 32, dim=1)
    bank = net.t["filter_bank.bank"]  # (V, 32, 8192)
    v = bank.shape[0]
    onehot = (labels.long()[..., None] == torch.arange(v, device=labels.device)).to(net.dt)
    # (B, L, V) x (B, 32) x (V, 32, 8192) -> (B, L, 8192)
    a = (onehot[:, :, :, None] * z0[:, None, None, :]).reshape(*labels.shape, -1)
    seeds = torch.matmul(net.q(a), net.q(bank.reshape(v * 32, -1)))
    b, length = labels.shape
    x = seeds.reshape(b, -1, 512, 4).permute(0, 2, 3, 1).contiguous()  # (B, 512, 4, 4L)
    for idx, cond in enumerate(z_blocks):
        x = net.block_up(f"up_B{idx + 1}", x, cond, last=idx == 2)
        if idx == 2:
            x = net.attention("attn_B3", x)
    x = torch.relu(net.batch_norm("final_bn", x))
    out = torch.tanh(net.conv("to_image", x))
    if lengths is not None:
        cols = torch.arange(out.shape[3], device=out.device)
        valid = cols[None, None, None, :] < 16 * lengths[:, None, None, None]
        out = torch.where(valid, out, torch.ones((), dtype=out.dtype, device=out.device))
    return out


def adversary(net: Net, x: torch.Tensor, width_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The BigGAN D (and W): (B, 1, 32, W) -> logits (B,), float32."""
    x = x.to(net.dt)
    for idx in range(4):
        x = net.block_down(f"trunk.block_B{idx + 1}", x, last=idx == 3)
        if idx == 0:
            x = net.attention("trunk.attn_B1", x)
    x = torch.relu(x).float()
    if width_mask is None:
        pooled = x.mean(dim=(2, 3))
    else:
        m = width_mask.float()[:, None, None, :]
        denom = (x.shape[2] * width_mask.float().sum(dim=1)).clamp(min=1.0)
        pooled = (x * m).sum(dim=(2, 3)) / denom[:, None]
    return net.dense("head", pooled)[:, 0].float()


def dcgan_discriminator(net: Net, x: torch.Tensor, width_mask=None) -> torch.Tensor:
    """The DCGAN D: (B, 1, 32, W) -> logits (B,), float32; the mask is unused."""
    x = x.to(net.dt)
    for idx in range(1, 5):
        x = F.leaky_relu(net.conv(f"conv{idx}", x, strides=(2, 2)), 0.3)
        if idx == 2:
            x = net.attention("attn_B1", x)
    pooled = F.leaky_relu(x, 0.3).float().mean(dim=(2, 3))
    return net.dense("head", pooled)[:, 0].float()


def conv_recognizer(net: Net, x: torch.Tensor) -> torch.Tensor:
    """The conv CRNN: (B, 1, 32, W) -> frame logits (B, W/4 - 1, 53), float32."""
    x = F.max_pool2d(torch.relu(net.conv("conv1", x.to(net.dt))), 2)
    x = F.max_pool2d(torch.relu(net.conv("conv2", x)), 2)
    x = torch.relu(net.conv("conv3", x))
    x = F.max_pool2d(torch.relu(net.conv("conv4", x)), (2, 1))
    x = net.batch_norm("bn5", torch.relu(net.conv("conv5", x)))
    x = net.batch_norm("bn6", torch.relu(net.conv("conv6", x)))
    x = F.max_pool2d(x, (2, 1))
    x = torch.relu(net.conv("conv7", x, padding="valid"))
    return net.dense("frame_logits", x[:, :, 0].transpose(1, 2)).float()


# ------------------------------------------------------ the BiLSTM's dropout
_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B
_ODD = 0x2545F491


def _mix(x: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def dropout_key(seed: int, step: int, device) -> torch.Tensor:
    """The key of one step's dropout masks: a 32-bit integer hash of the
    dropout seed and the step number."""
    s = torch.tensor(seed, dtype=torch.int64, device=device)
    return _mix(_mix(s & _M32) ^ (step & _M32))


class DropoutStream:
    """Dropout calls numbered 0, 1, 2, ... under one key; element i of call c
    is kept when the top 24 bits of hash(i, hash(key + c * odd)) fall under
    keep_prob * 2^24."""

    def __init__(self, key: torch.Tensor):
        self.key = key
        self.call = 0

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep_prob = 1.0 - rate
        k = _mix((self.key + self.call * _ODD) & _M32)
        self.call += 1
        idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
        bits = _mix(_mix((idx * _ODD + k) & _M32) ^ k)
        keep = ((bits >> 8) < int(keep_prob * 2 ** 24)).reshape(x.shape)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _lstm_weights(net: Net, cell: int) -> list[torch.Tensor]:
    pre = f"OptimizedLSTMCell_{cell}"
    cat = lambda kind: torch.cat([net.t[f"{pre}.{kind}{g}"] for g in "ifgo"])  # noqa: E731
    w_ih, w_hh = cat("i"), cat("h")
    b_hh = torch.cat([net.t[f"{pre}.h{g}_bias"] for g in "ifgo"])
    return [w_ih, w_hh, torch.zeros_like(b_hh), b_hh]


def bilstm_recognizer(net: Net, x: torch.Tensor, drop: DropoutStream | None,
                      lstm_prec: str = "float32") -> torch.Tensor:
    """The BiLSTM R: (B, 1, 32, W) -> frame logits (B, W/4, 53), float32.
    `drop` is the step's dropout stream (None: eval mode). The LSTM layers
    compute in `lstm_prec` (float32 as configured)."""
    def dropout(t, rate):
        return t if drop is None else drop(t, rate)

    x = x.to(net.dt)
    for idx in range(1, 8):
        if idx >= 3:
            x = dropout(x, 0.2)
        x = F.leaky_relu(net.batch_norm(f"bn_{idx}", net.conv(f"conv_{idx}", x)), 0.01)
        if idx in BILSTM_POOLS:
            x = F.max_pool2d(x, BILSTM_POOLS[idx])
    lstm_dt = compute_dtype(lstm_prec)
    x = x[:, :, 0].transpose(1, 2).to(lstm_dt)
    zeros = x.new_zeros(2, x.shape[0], LSTM_FEATURES)
    for layer in range(5):
        x = dropout(x, 0.5)
        weights = [quant(w, lstm_prec) for cell in (2 * layer, 2 * layer + 1)
                   for w in _lstm_weights(net, cell)]
        x = torch.lstm(quant(x, lstm_prec), (zeros, zeros), weights, True, 1, 0.0, net.train,
                       True, True)[0]
    x = dropout(x, 0.5)
    return net.dense("frame_logits", x).float()


def ctc_time_steps(width: int, bilstm: bool) -> int:
    return width // 4 if bilstm else width // 4 - 1


def fan_in(shape: tuple[int, ...], out_axis: int) -> int:
    return math.prod(shape) // shape[out_axis]

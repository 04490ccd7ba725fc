"""Grayscale image IO and resizing on numpy and zlib alone.

The port's counterpart of scrabblegan_tpu/data/images.py, which calls cv2
(or PIL): the card's machine has neither, so this module decodes and writes
PNG itself and resizes as cv2 does.

- `read_grayscale` decodes a PNG of bit depth 8, colour type 0 (grey),
  2 (RGB), 4 (grey + alpha) or 6 (RGBA), not interlaced, any of the five
  row filters, its pixels in one IDAT chunk or several, into what
  `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` gives: the alpha channel is
  dropped and RGB becomes grey by libpng's truncating integer formula
  (9797 R + 19234 G + 3737 B) >> 15, which cv2's PNG reader asks libpng for.
  A missing file gives None, as with cv2; any other image (16-bit, palette,
  interlaced, JPEG, ...) raises ValueError.
- `write_grayscale` writes an 8-bit grey PNG, every row with filter 0.
- `resize` computes cv2.resize's INTER_AREA, INTER_LINEAR and INTER_CUBIC
  (a = -0.75) on float input: the same source coordinates, border rules
  and weights, applied as two matrix products in float64. INTER_AREA is
  cv2's box average when both axes shrink and its bilinear variant
  otherwise.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
# libpng's rgb-to-grey coefficients for cv2's (0.299, 0.587): each computed
# as int(c * 100000 * 32768 / 100000) without rounding; blue takes the rest
_GREY_RED, _GREY_GREEN = 9797, 19234
_GREY_BLUE = 32768 - _GREY_RED - _GREY_GREEN


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG: no IEND chunk")


def _unfilter_slow(ftype: int, line: bytes, prev: bytearray, bpp: int) -> bytearray:
    """Filter types 3 (average) and 4 (Paeth): each byte depends on the one
    bpp to its left, so they are undone byte by byte."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG pixel data holds {rows.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub: a running sum along each sample of the row
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64) % 256
                   ).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # up
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.frombuffer(_unfilter_slow(ftype, line.tobytes(), bytearray(prev.tobytes()),
                                               bpp), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The grey (H, W) uint8 image of PNG bytes, as `read_grayscale` reads it."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file (only PNG is read without cv2)")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype} "
                         "(8-bit grey, grey + alpha, RGB or RGBA only)")
    if interlace:
        raise ValueError("unsupported PNG: interlaced")
    bpp = _CHANNELS[ctype]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    pixels = pixels.reshape(height, width, bpp)
    if bpp <= 2:
        return np.ascontiguousarray(pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    grey = (_GREY_RED * rgb[..., 0] + _GREY_GREEN * rgb[..., 1]
            + _GREY_BLUE * rgb[..., 2]) >> 15
    return grey.astype(np.uint8)


def read_grayscale(path: str) -> np.ndarray | None:
    """An image file as uint8 grey (H, W); None when the file does not
    exist or cannot be opened, as `cv2.imread` returns."""
    try:
        with open(os.fspath(path), "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_png(data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """8-bit grey PNG bytes of a (H, W) uint8 image, filter 0 on every row."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"a grey image is (H, W), got {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_grayscale(path: str, img: np.ndarray) -> None:
    """Write img, clipped to [0, 255] and truncated to uint8 as the JAX
    package's writer does, as an 8-bit grey PNG."""
    with open(os.fspath(path), "wb") as f:
        f.write(encode_png(np.clip(img, 0, 255).astype(np.uint8)))


def _cubic_weights(x: float) -> tuple[float, float, float, float]:
    """cv2's interpolateCubic with A = -0.75, in float32 as cv2 computes it."""
    a = np.float32(-0.75)
    x = np.float32(x)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return float(c0), float(c1), float(c2), float(1 - c0 - c1 - c2)


def _area_tab(src: int, dst: int, scale: float) -> np.ndarray:
    """cv2's computeResizeAreaTab as a (dst, src) matrix: the share of each
    source pixel in each destination cell."""
    w = np.zeros((dst, src))
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx2 = min(math.floor(fsx2), src - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _interp_tab(src: int, dst: int, quality: str) -> np.ndarray:
    """cv2's per-axis coefficients for INTER_LINEAR, INTER_CUBIC and the
    bilinear form of INTER_AREA, as a (dst, src) matrix."""
    inv = dst / src
    scale = 1.0 / inv
    w = np.zeros((dst, src))
    for dx in range(dst):
        if quality == "area":
            sx = math.floor(dx * scale)
            f = (dx + 1) - (sx + 1) * inv
            fx = 0.0 if f <= 0 else float(np.float32(f - math.floor(f)))
        else:
            f = (dx + 0.5) * scale - 0.5
            sx = math.floor(f)
            fx = float(np.float32(f - sx))
        if quality == "cubic":  # taps sx-1..sx+2, indices clamped to the image
            for j, c in enumerate(_cubic_weights(fx)):
                w[dx, min(max(sx - 1 + j, 0), src - 1)] += c
            continue
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= src - 1:
            sx, fx = src - 1, 0.0
        w[dx, sx] += float(np.float32(1.0) - np.float32(fx))
        if fx:
            w[dx, sx + 1] += fx
    return w


def resize(img: np.ndarray, width: int, height: int, quality: str = "area") -> np.ndarray:
    """Resize (H, W) to float32 (height, width) as cv2.resize does float32
    input with INTER_AREA ('area'), INTER_LINEAR ('linear') or INTER_CUBIC
    ('cubic'). (cv2's uint8 path is fixed point; every caller passes
    float32.)"""
    if quality not in ("area", "linear", "cubic"):
        raise ValueError(f"unknown resize quality {quality!r}")
    src = np.asarray(img, np.float32)
    h, w = src.shape
    if (h, w) == (height, width):
        return src.copy()
    if quality == "area" and h >= height and w >= width:  # both axes shrink
        wy, wx = _area_tab(h, height, h / height), _area_tab(w, width, w / width)
    else:
        wy, wx = _interp_tab(h, height, quality), _interp_tab(w, width, quality)
    return (wy @ src.astype(np.float64) @ wx.T).astype(np.float32)

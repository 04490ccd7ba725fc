"""Sample grids and the training GIF, on numpy alone.

The port's counterpart of scrabblegan_tpu/utils/viz.py, which draws with
matplotlib and writes the GIF with imageio; the card's machine has neither.
- `save_image_grid` tiles the images into one grey PNG (`data.images`
  writer) on a white page, rows x cols with a 4-pixel gutter. A known
  divergence from the JAX grid: the decoded labels are not drawn above the
  images but written, one line per image in grid order, to a .txt file
  beside the PNG (<out>.txt with the extension replaced).
- `save_epoch_grid` names the grid image_at_epoch_%04d.png.
- `make_gif` writes a GIF89a (256-entry grey palette, LZW, looping) over the
  image_at_epoch PNGs with the JAX package's sqrt-spaced frame schedule.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Sequence

import numpy as np

from scrabblegan_torch.config import CHAR_VECTOR
from scrabblegan_torch.data.images import read_grayscale, write_grayscale

GUTTER = 4


def grid_pixels(images: np.ndarray, grid: tuple = (4, 4)) -> np.ndarray:
    """(N, H, W) or (N, H, W, 1) images in [-1, 1] -> the uint8 grid page:
    the first rows x cols images, row by row."""
    images = np.asarray(images, np.float32)
    if images.ndim == 4:
        images = images[..., 0]
    pixels = np.clip(np.rint((images + 1.0) * 127.5), 0, 255).astype(np.uint8)
    rows, cols = grid
    n, h, w = pixels.shape
    page = np.full((rows * (h + GUTTER) + GUTTER, cols * (w + GUTTER) + GUTTER), 255, np.uint8)
    for i in range(min(n, rows * cols)):
        r, c = divmod(i, cols)
        y, x = GUTTER + r * (h + GUTTER), GUTTER + c * (w + GUTTER)
        page[y:y + h, x:x + w] = pixels[i]
    return page


def save_image_grid(images: np.ndarray, labels: Sequence[Sequence[int]],
                    out_path: str, char_vector: str = CHAR_VECTOR,
                    grid: tuple = (4, 4)) -> str:
    """Write the grid PNG to out_path and its decoded labels to the .txt
    beside it; returns the .txt's path."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_grayscale(out_path, grid_pixels(images, grid))
    rows, cols = grid
    words = ["".join(char_vector[int(c)] for c in label if int(c) < len(char_vector))
             for label in list(labels)[:rows * cols]]
    txt = os.path.splitext(out_path)[0] + ".txt"
    with open(txt, "w") as f:
        f.write("\n".join(words) + "\n")
    return txt


def save_epoch_grid(images, labels, gen_path: str, epoch: int,
                    char_vector: str = CHAR_VECTOR) -> str:
    out = os.path.join(gen_path, f"image_at_epoch_{epoch:04d}.png")
    save_image_grid(images, labels, out, char_vector)
    return out


def _lzw(pixels: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of `pixels` (codes of min_size bits), as
    packed little-endian bits; the table restarts with a clear code when it
    holds 4096 codes."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0
    size = min_size + 1

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table: dict[int, int] = {}
    nxt = eoi + 1
    emit(clear)
    prefix = pixels[0]
    for byte in pixels[1:]:
        key = (prefix << 8) | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:  # the decoder's table is one code behind
                size += 1
        else:
            emit(clear)
            table.clear()
            nxt, size = eoi + 1, min_size + 1
        prefix = byte
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def encode_gif(frames: Sequence[np.ndarray], delay_cs: int = 50) -> bytes:
    """A looping GIF89a of uint8 grey frames (each (H, W), drawn at the
    top-left of a page the size of the largest) on a 256-grey palette."""
    h = max(f.shape[0] for f in frames)
    w = max(f.shape[1] for f in frames)
    palette = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 255, 0) + palette)
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for frame in frames:
        frame = np.ascontiguousarray(frame, np.uint8)
        fh, fw = frame.shape
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, fw, fh, 0) + b"\x08"
        data = _lzw(frame.tobytes())
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            out += bytes([len(block)]) + block
        out += b"\x00"
    out += b"\x3b"
    return bytes(out)


def make_gif(gen_path: str, out_name: str = "training.gif") -> str | None:
    """The GIF over <gen_path>/image*.png in name order: frame i is kept
    when round(2 sqrt(i)) passes the last kept frame's, and the last image
    closes the GIF; None when there is no image."""
    filenames = sorted(glob.glob(os.path.join(gen_path, "image*.png")))
    if not filenames:
        return None
    frames, last = [], -1.0
    for i, filename in enumerate(filenames):
        frame = 2 * (i ** 0.5)
        if round(frame) > round(last):
            last = frame
        else:
            continue
        frames.append(read_grayscale(filename))
    frames.append(read_grayscale(filenames[-1]))
    anim_file = os.path.join(gen_path, out_name)
    with open(anim_file, "wb") as f:
        f.write(encode_gif(frames))
    return anim_file

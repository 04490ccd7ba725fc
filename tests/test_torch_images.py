"""The port's image IO and resizing (`scrabblegan_torch.data.images`, numpy
and zlib) against cv2, which the JAX package reads, writes and resizes with.

- The PNG reader is bitwise equal to `cv2.imread(path, IMREAD_GRAYSCALE)`
  on the synthetic fixture's PNGs (written by cv2 through the JAX package)
  and on grey, RGB and RGBA files written by cv2 (several compression
  levels: its writer picks a filter per row) and by PIL (one filter type
  per file, 0-4, and several IDAT chunks).
- The writer round-trips, and cv2 reads its files identically.
- `resize` 'area', 'linear' and 'cubic' on float32, shrinking and growing,
  each axis alone and both, within 1e-3 of cv2 on the 0-255 scale (the
  measured worst is ~3e-4, for 'cubic': cv2 evaluates its float32 cubic
  weights in another order).
"""

import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from scrabblegan_tpu.data.synthetic import make_synthetic_dataset
from scrabblegan_torch.data import images

RESIZE_TOL = 1e-3


@pytest.fixture(scope="module")
def fixture_pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    make_synthetic_dataset(str(root), samples_per_bucket=2, bucket_size=4, style="script")
    return sorted(root.rglob("*.png"))


def test_reader_matches_cv2_on_the_fixture(fixture_pngs):
    assert len(fixture_pngs) == 8 + 12
    for path in fixture_pngs:
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        got = images.read_grayscale(str(path))
        assert got.dtype == np.uint8 and np.array_equal(got, want), path


def _textured(rng, shape):
    """Noise with flat patches and ramps, so encoders choose varied filters."""
    img = rng.integers(0, 256, shape, np.uint8)
    img[3:17, 5:40] = 200
    ramp = np.linspace(0, 255, shape[1]).astype(np.uint8)
    img[20:30] = ramp[:, None] if img.ndim == 3 else ramp
    return img


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("level", [0, 3, 9])
def test_reader_matches_cv2_on_cv2_files(tmp_path, channels, level):
    rng = np.random.default_rng(channels * 10 + level)
    img = _textured(rng, (37, 61) if channels == 1 else (37, 61, channels))
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(images.read_grayscale(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _pil_png_with_filter(path, img: np.ndarray, mode: str, ftype: int, idat_parts: int):
    """A PNG of img written by PIL, then every row re-filtered with one
    filter type and the pixel data split into several IDAT chunks."""
    Image.fromarray(img, mode).save(path)
    data = open(path, "rb").read()
    bpp = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    h, w = img.shape[:2]
    raw = img.reshape(h, w * bpp).astype(np.int64)
    rows = []
    for y in range(h):
        cur, prev = raw[y], raw[y - 1] if y else np.zeros_like(raw[0])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    body = zlib.compress(b"".join(rows))
    step = -(-len(body) // idat_parts)
    parts = [body[i:i + step] for i in range(0, len(body), step)]
    # rebuild: signature, IHDR (PIL's), the new IDATs, IEND
    ihdr_end = 8 + 8 + 13 + 4
    out = data[:ihdr_end] + b"".join(images._chunk(b"IDAT", p) for p in parts)
    out += images._chunk(b"IEND", b"")
    open(path, "wb").write(out)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_reader_matches_cv2_on_every_filter_type(tmp_path, mode):
    rng = np.random.default_rng(7)
    shape = {"L": (23, 41), "RGB": (23, 41, 3), "RGBA": (23, 41, 4)}[mode]
    img = _textured(rng, shape)
    for ftype in range(5):
        path = str(tmp_path / f"f{ftype}.png")
        _pil_png_with_filter(path, img, mode, ftype, idat_parts=3)
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        assert want is not None
        np.testing.assert_array_equal(images.read_grayscale(path), want)
        if mode == "L":
            np.testing.assert_array_equal(want, img)


def test_reader_errors(tmp_path):
    assert images.read_grayscale(str(tmp_path / "missing.png")) is None
    assert cv2.imread(str(tmp_path / "missing.png"), cv2.IMREAD_GRAYSCALE) is None
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        images.read_grayscale(jpg)
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.zeros((8, 8), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        images.read_grayscale(deep)
    interlaced = str(tmp_path / "i.png")
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(interlaced)
    data = bytearray(open(interlaced, "rb").read())
    data[28] = 1  # IHDR's interlace byte
    data[29:33] = (zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF).to_bytes(4, "big")
    open(interlaced, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        images.read_grayscale(interlaced)


def test_writer_round_trips_and_cv2_reads_it(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.normal(128, 90, (32, 77))  # out of range on both sides: clipped
    path = str(tmp_path / "w.png")
    images.write_grayscale(path, img)
    want = np.clip(img, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(images.read_grayscale(path), want)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), want)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)


SIZES = [(32, 160), (45, 97), (31, 20), (64, 300), (7, 5)]
TARGETS = [(32, 100), (32, 17), (90, 400), (16, 80), (64, 33), (3, 2)]


@pytest.mark.parametrize("quality,flag", [("area", cv2.INTER_AREA),
                                          ("linear", cv2.INTER_LINEAR),
                                          ("cubic", cv2.INTER_CUBIC)])
def test_resize_matches_cv2(quality, flag):
    rng = np.random.default_rng(11)
    worst = 0.0
    for h, w in SIZES:
        img = (rng.random((h, w)) * 255).astype(np.float32)
        # shrink, grow, one axis each way (cv2's INTER_AREA is bilinear then), same size
        for th, tw in TARGETS + [(h, 2 * w), (2 * h, w // 2 + 1), (h + 1, w), (h, w)]:
            want = cv2.resize(img, (tw, th), interpolation=flag)
            got = images.resize(img, tw, th, quality)
            assert got.shape == want.shape and got.dtype == np.float32
            worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= RESIZE_TOL, worst

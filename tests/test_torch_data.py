"""The port's data path against the JAX package's (CPU, numpy only).

- `make_synthetic_dataset`: for one seed both packages write the same words,
  lexicon and pixel arrays (read back with cv2), for both styles and for
  `length_weights='iam'`; `bucket_populations` is the same function.
- `BucketedDataset`: the same store, `bucket_weights`, and the same
  `sample_bucket` / `sample_batch(raw=True|False)` streams over 20 draws,
  bitwise (JAX's loader on its numpy assembly path), a multi-directory
  `reading_dir` included.
- `load_style_images`: the same split and the same arrays within the
  resize tolerance of tests/test_torch_images.py (1e-3 on the 0-255 scale,
  so 1e-3 / 127.5 in [-1, 1]) on the fixture's style images and on
  user-like ones: RGB, taller and shorter than 32 px, and wide enough for
  the validate rule's width fit.
"""

import os

import cv2
import numpy as np
import pytest

from scrabblegan_tpu.data import loaders as jax_loaders
from scrabblegan_tpu.data import synthetic as jax_synthetic
from scrabblegan_torch.data import loaders as port_loaders
from scrabblegan_torch.data import synthetic as port_synthetic

STYLE_TOL = 1e-3 / 127.5  # resize's 1e-3 on the 0-255 scale, in [-1, 1]


def tree(root) -> dict:
    """{relative path: pixels (cv2) or text} of a written data set."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            out[rel] = (cv2.imread(path, cv2.IMREAD_GRAYSCALE) if fn.endswith(".png")
                        else open(path).read())
    return out


@pytest.mark.parametrize("style,weights", [("stripes", None), ("script", None),
                                           ("stripes", "iam")])
def test_synthetic_dataset_is_jax_s(tmp_path, style, weights):
    kw = dict(samples_per_bucket=3, bucket_size=4, seed=5, style=style, length_weights=weights)
    paths_j = jax_synthetic.make_synthetic_dataset(str(tmp_path / "j"), **kw)
    paths_p = port_synthetic.make_synthetic_dataset(str(tmp_path / "p"), **kw)
    assert [os.path.relpath(p, tmp_path / "p") for p in paths_p] == \
        [os.path.relpath(p, tmp_path / "j") for p in paths_j]
    want, got = tree(tmp_path / "j"), tree(tmp_path / "p")
    assert sorted(got) == sorted(want) and len(got) > 12
    for rel, value in want.items():
        if isinstance(value, str):
            assert got[rel] == value, rel
        else:
            np.testing.assert_array_equal(got[rel], value, err_msg=rel)
    for spb, bs, w in ((8, 10, "iam"), (4, 3, (1, 2, 3)), (5, 2, None)):
        assert port_synthetic.bucket_populations(spb, bs, w) == \
            jax_synthetic.bucket_populations(spb, bs, w)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return port_synthetic.make_synthetic_dataset(str(root), samples_per_bucket=4,
                                                 bucket_size=4, length_weights=(1, 3, 0.5, 2))


@pytest.mark.parametrize("multi", [False, True])
def test_bucketed_dataset_streams_match(synth, tmp_path, multi):
    read_dir = synth[0]
    if multi:  # a second data set merged into the pool
        other = port_synthetic.make_synthetic_dataset(str(tmp_path / "b"), samples_per_bucket=2,
                                                      bucket_size=3, seed=9)[0]
        read_dir = [read_dir, other]
    port = port_loaders.BucketedDataset(read_dir, (32, 160, 1), 4, seed=3)
    ref = jax_loaders.BucketedDataset(read_dir, (32, 160, 1), 4, seed=3, use_native=False)
    np.testing.assert_array_equal(port.bucket_weights, ref.bucket_weights)
    assert port.num_samples == ref.num_samples and port.nonempty == ref.nonempty
    for b in range(1, 5):
        np.testing.assert_array_equal(port.images[b], ref.images[b])
        np.testing.assert_array_equal(port.labels[b], ref.labels[b])
    for i in range(20):
        assert port.sample_bucket() == ref.sample_bucket()
        raw = i % 2 == 0
        bucket = None if i % 3 else 2
        got, want = (d.sample_batch(3, bucket=bucket, raw=raw) for d in (port, ref))
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_bucketed_dataset_rejects_an_empty_dir(tmp_path):
    with pytest.raises(ValueError, match="no samples"):
        port_loaders.BucketedDataset(str(tmp_path), (32, 160, 1), 3)


def user_style_dir(root) -> str:
    """Style images as a user might bring them: grey and RGB, taller and
    shorter than 32 px, narrow and wide."""
    rng = np.random.default_rng(21)
    os.makedirs(root)
    shapes = [(64, 90), (20, 33), (48, 700), (31, 200), (32, 100), (80, 1300), (45, 61),
              (17, 500), (64, 64), (40, 160), (33, 333), (90, 30), (52, 900)]
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 256, (h, w, 3) if i % 3 == 1 else (h, w), np.uint8)
        cv2.imwrite(os.path.join(root, f"u{i:02d}.png"), img)
    return root


@pytest.mark.parametrize("which", ["fixture", "user"])
@pytest.mark.parametrize("fraction", [0.95, 0.5])
def test_style_images_match(synth, tmp_path, which, fraction):
    style_dir = synth[2] if which == "fixture" else user_style_dir(str(tmp_path / "u"))
    got = port_loaders.load_style_images(style_dir, (32, 160, 1), fraction, seed=4)
    want = jax_loaders.load_style_images(style_dir, (32, 160, 1), fraction, seed=4)
    for split_got, split_want in zip(got, want):
        assert len(split_got) == len(split_want) > 0
        for g, w in zip(split_got, split_want):
            assert g.shape == w.shape == (32, 160)
            np.testing.assert_allclose(g, w, rtol=0, atol=STYLE_TOL)


def test_wide_validate_image_is_width_fit(tmp_path):
    """The validate rule on a wide image: width-fit with 'cubic', the
    height falls below 32 and is white-padded (JAX's _fit_canvas)."""
    d = tmp_path / "wide"
    d.mkdir()
    rng = np.random.default_rng(2)
    cv2.imwrite(str(d / "w.png"), rng.integers(0, 120, (64, 1280), np.uint8))
    _, got = port_loaders.load_style_images(str(d), (32, 160, 1), train_fraction=0.0)
    _, want = jax_loaders.load_style_images(str(d), (32, 160, 1), train_fraction=0.0)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=STYLE_TOL)
    np.testing.assert_array_equal(got[0][8:], 1.0)
    assert got[0][:8].mean() < -0.3  # the dark content (cubic may overshoot a pixel)

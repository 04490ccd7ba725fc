"""The port's evaluation (`scrabblegan_torch.eval`) against the JAX
package's (CPU).

- `greedy_ctc_decode`, `levenshtein` and `character_error_rate` are exact.
- `frechet_distance` within 1e-9 relative (both scipy's sqrtm in float64),
  singular covariances (N < D) included.
- `rfid_rand_seed0.npz` equals the kernels `jax.random` draws for seed 0,
  bit for bit; `random_features` is within 1e-4 relative of JAX's jitted
  extractor on 33 x 48 (odd: SAME pads (1, 1)), 32 x 160 and 31 x 47.
- `recognizer_features` from converted R weights within 1e-5 (relative to
  the features' scale).
- `score_export` / `annotate_export`: the same dict within 1e-3 on the
  scores, the same flag and the same `latest_good` link.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.eval import decode as jax_decode
from scrabblegan_tpu.eval import fid as jax_fid
from scrabblegan_tpu.eval import gate as jax_gate
from scrabblegan_tpu.models.recognizer import Recognizer as JaxRecognizer
from scrabblegan_torch.config import load_config
from scrabblegan_torch.convert import fake_flax_variables, load_flax
from scrabblegan_torch.eval import decode, fid, gate
from scrabblegan_torch.models.build import build_models

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

FRECHET_RTOL = 1e-9
FEATURE_RTOL = 1e-4
RECOGNIZER_TOL = 1e-5
SCORE_TOL = 1e-3


def test_decode_and_cer_are_exact():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 11, 5)).astype(np.float32)
    logits[:, 3] = logits[:, 2]  # repeats to collapse
    lengths = np.array([11, 7, 1, 0, 11, 4])
    for lens in (None, lengths):
        got = decode.greedy_ctc_decode(logits, lens)
        assert got == jax_decode.greedy_ctc_decode(logits, lens)
        assert all(isinstance(c, int) for row in got for c in row)
    refs = [list(rng.integers(0, 4, rng.integers(0, 6))) for _ in range(6)]
    preds = decode.greedy_ctc_decode(logits, lengths)
    assert decode.character_error_rate(preds, refs) == \
        jax_decode.character_error_rate(preds, refs)
    for a, b in (("kitten", "sitting"), ("", "abc"), ("flaw", "lawn")):
        assert decode.levenshtein(a, b) == jax_decode.levenshtein(a, b)


@pytest.mark.parametrize("n_a,n_b,d", [(40, 50, 8), (20, 25, 30), (6, 6, 64)])
def test_frechet_distance_matches(n_a, n_b, d):
    rng = np.random.default_rng(n_a + d)
    a = rng.normal(size=(n_a, d))
    b = rng.normal(0.3, 1.2, size=(n_b, d)).astype(np.float32)
    got, want = fid.frechet_distance(a, b), jax_fid.frechet_distance(a, b)
    assert got == pytest.approx(want, rel=FRECHET_RTOL)
    assert fid.frechet_distance(a, a) == pytest.approx(jax_fid.frechet_distance(a, a),
                                                       abs=1e-9)


def test_shipped_random_kernels_are_jax_s_bit_for_bit():
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    shipped = fid.load_random_kernels()
    cin = 1
    assert len(shipped) == 4
    for key, width, got in zip(keys, (64, 128, 256, 512), shipped):
        want = np.asarray(jax.random.normal(key, (3, 3, cin, width), jnp.float32)
                          * (2.0 / (9 * cin)) ** 0.5)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        cin = width
    assert sum(k.size for k in shipped) == 1_548_864


@pytest.mark.parametrize("shape", [(5, 33, 48, 1), (4, 32, 160, 1), (3, 31, 47, 1)])
def test_random_features_match_jax(shape):
    x = np.random.default_rng(shape[1]).uniform(-1, 1, shape).astype(np.float32)
    want = jax_fid.random_features()(x)
    got = fid.random_features("cpu")(x)
    assert got.shape == want.shape == (shape[0], 512)
    assert np.abs(got - want).max() <= FEATURE_RTOL * np.abs(want).max()
    got3 = fid.random_features("cpu")(x[..., 0])  # (N, H, W) is accepted too
    np.testing.assert_array_equal(got3, got)


def test_recognizer_features_match_jax():
    cfg = load_config(None)
    variables = fake_flax_variables(cfg, 3, "recognizer")
    port = load_flax(build_models(cfg, "meta").recognizer.to_empty(device="cpu"), variables)
    port.train()
    jax_r = JaxRecognizer(num_classes=cfg.io.n_classes + 1)
    x = np.random.default_rng(4).uniform(-1, 1, (3, 32, 48, 1)).astype(np.float32)
    want = jax_fid.recognizer_features(jax_r, variables["params"], variables["batch_stats"])(x)
    got = fid.recognizer_features(port)(x)
    assert port.training  # the extractor restores the mode
    assert got.shape == want.shape == (3, 512)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RECOGNIZER_TOL * max(1.0, np.abs(want).max()))


def test_rfid_in_chunks():
    rng = np.random.default_rng(5)
    gen = rng.uniform(-1, 1, (12, 32, 32, 1)).astype(np.float32)
    real = rng.uniform(-1, 1, (12, 32, 32, 1)).astype(np.float32)
    ext = fid.random_features("cpu")
    whole = fid.compute_rfid(gen, real, ext)
    assert fid.compute_rfid(gen, real, ext, batch_size=5) == pytest.approx(whole, rel=1e-5)
    want = jax_fid.compute_rfid(gen, real, jax_fid.random_features(), batch_size=5)
    assert whole == pytest.approx(want, rel=SCORE_TOL)


def word_like(rng, n, dark: float) -> np.ndarray:
    """n word-ish images: white pages with dark strokes."""
    x = np.ones((n, 32, 48, 1), np.float32)
    for i in range(n):
        for _ in range(6):
            r, c = rng.integers(4, 28), rng.integers(2, 40)
            x[i, r - 2:r + 2, c:c + rng.integers(3, 8)] = dark
    return x


@pytest.mark.parametrize("kind", ["readable", "garbage"])
def test_score_and_annotate_match_jax(tmp_path, kind):
    rng = np.random.default_rng(6)
    real = word_like(rng, 24, -1.0)
    gen = (word_like(rng, 12, -1.0) if kind == "readable"
           else rng.uniform(-1, 1, (12, 32, 48, 1)).astype(np.float32))
    got = gate.score_export(gen, real, extractor=fid.random_features("cpu"))
    want = jax_gate.score_export(gen, real)
    assert got["flag"] == want["flag"] == ("ok" if kind == "readable" else "suspect")
    for key in want:
        if key in ("rfid_rand", "real_floor", "excess"):
            assert got[key] == pytest.approx(want[key], rel=SCORE_TOL, abs=SCORE_TOL)
        else:
            assert got[key] == want[key], key
    for name, module, result in (("port", gate, got), ("jax", jax_gate, want)):
        model_dir = str(tmp_path / name)
        for epoch in (1, 2):
            module.annotate_export(model_dir, epoch, result)
        os.makedirs(os.path.join(model_dir, "generator", "2"))
    for epoch in (1, 2):
        a, b = (json.loads((tmp_path / w / "generator" / f"quality_{epoch}.json").read_text())
                for w in ("port", "jax"))
        assert sorted(a) == sorted(b) and a["flag"] == b["flag"]
    links = [os.readlink(tmp_path / w / "generator" / "latest_good")
             if (tmp_path / w / "generator" / "latest_good").is_symlink() else None
             for w in ("port", "jax")]
    assert links[0] == links[1] == ("2" if kind == "readable" else None)
    assert gate.latest_good_export(str(tmp_path / "port")) == \
        jax_gate.latest_good_export(str(tmp_path / "port"))

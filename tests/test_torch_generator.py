"""Parity of the PyTorch port's generator with the JAX Generator (CPU), and the
weight conversion, the flax tree layout, the serving CLI and import hygiene.

JAX variables come from `jax.eval_shape(Generator.init)` filled by
`scrabblegan_torch.convert.fake_fill` (random SN u, non-trivial BN statistics,
attention sigma in [0.5, 1]). The generator runs at its full widths (they are
fixed by the architecture) at batch 2 and lengths 1 and 3.

Tolerances on images in [-1, 1]: 1e-4 absolute in float32 (the two sides
differ only in summation order); 2e-2 in bfloat16, where the frameworks round
at different places through some twenty layers (measured ~5e-3)."""

import dataclasses
import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrabblegan_tpu.config import load_config
from scrabblegan_tpu.models.generator import Generator as JaxGenerator
from scrabblegan_torch import convert, infer
from scrabblegan_torch.models.build import build_generator, build_models, noise_config

# One intra-op thread: the suite runs in parallel worker processes, and
# torch's OpenMP pool in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOLS = {"float32": 1e-4, "bfloat16": 2e-2}


def cfg_for(dtype="float32", padded=False, **extra):
    return load_config(None, {"shared.z_source": "noise", "shared.dtype": dtype,
                              "parallel.shape_mode": "padded" if padded else "bucketed",
                              **extra})


def test_noise_config():
    assert noise_config().shared.z_source == "noise"
    assert dataclasses.asdict(noise_config(None, {"shared.dtype": "bfloat16"})) == \
        dataclasses.asdict(cfg_for("bfloat16"))


def jax_generator(dtype="float32", padded=False):
    return JaxGenerator(vocab_size=52, z_source="noise", use_pallas_attention=True,
                        num_pad_tokens=int(padded), dtype=getattr(jnp, dtype))


@functools.cache
def jax_tree_shapes(padded):
    """{flax path: ShapeDtypeStruct} of JAX Generator.init (eval_shape only)."""
    shapes = jax.eval_shape(lambda: jax_generator(padded=padded).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 3), jnp.int32),
        z=jnp.zeros((2, 128)), train=False))
    return convert.flatten(shapes)


def inputs(length, padded, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 52, (2, length)).astype(np.int32)
    z = rng.standard_normal((2, 128)).astype(np.float32)
    lengths = None
    if padded:
        lengths = np.array([length, length - 1], np.int32)
        labels[1, length - 1] = 52  # the PAD id
    return labels, z, lengths


def run_port(generator, labels, z, lengths=None):
    with torch.inference_mode():
        out = generator(torch.from_numpy(labels), torch.from_numpy(z),
                        None if lengths is None else torch.from_numpy(lengths))
    return out.float().permute(0, 2, 3, 1).numpy()  # NHWC, as JAX returns


@pytest.mark.parametrize("length,dtype,padded", [
    (1, "float32", False), (3, "float32", False), (1, "bfloat16", False),
    (3, "bfloat16", False), (3, "float32", True)])
def test_generator_matches_jax(length, dtype, padded):
    variables = convert.fake_fill(
        {p: s.shape for p, s in jax_tree_shapes(padded).items()}, seed=length)
    labels, z, lengths = inputs(length, padded)
    apply = jax.jit(functools.partial(jax_generator(dtype, padded).apply, train=False))
    ref = apply(variables, labels, z=z, lengths=lengths)
    ref = np.asarray(ref.astype(jnp.float32))
    got = run_port(convert.generator_from_flax(variables, cfg_for(dtype, padded)),
                   labels, z, lengths)
    assert got.shape == ref.shape == (2, 32, 16 * length, 1)
    assert ref.std() > 0.05  # not a constant image
    np.testing.assert_allclose(got, ref, rtol=TOLS[dtype], atol=TOLS[dtype])
    if padded:  # the PAD columns of the shorter word are white
        assert (got[1, :, 16 * (length - 1):] == 1.0).all()


@pytest.mark.parametrize("padded", [False, True])
def test_fake_tree_layout_matches_flax_init(padded):
    fake = convert.flatten(convert.fake_flax_variables(cfg_for(padded=padded), seed=0))
    ref = jax_tree_shapes(padded)
    assert sorted(fake) == sorted(ref)
    for path, s in ref.items():
        assert (fake[path].shape, fake[path].dtype) == (s.shape, s.dtype), path
    # fake_fill draws by sorted path: the same tree gives the same values
    again = convert.flatten(convert.fake_fill({p: s.shape for p, s in ref.items()}, seed=0))
    np.testing.assert_array_equal(again[("params", "attn_B3", "sigma")],
                                  fake[("params", "attn_B3", "sigma")])


def test_conversion_rejects_bad_trees_and_skips_the_style_encoder():
    cfg = cfg_for()
    variables = convert.fake_flax_variables(cfg, seed=1)
    variables["params"]["style_encoder"] = {"proj": {"Dense_0": {"kernel": np.zeros((1, 1))}}}
    generator = convert.generator_from_flax(variables, cfg)  # a style-trained export
    del variables["params"]["style_encoder"]
    variables["params"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        convert.load_flax(generator, variables)
    del variables["params"]["extra"]
    del variables["batch_stats"]["final_bn"]["var"]
    with pytest.raises(KeyError, match="final_bn/var"):
        convert.load_flax(generator, variables)


def test_config_choices():
    style = build_generator(cfg_for(**{"shared.z_source": "style"}), "meta")
    assert not style.style_encoder.attn.use_kernel  # JAX builds it without use_pallas
    variants = build_models(cfg_for(**{"shared.my_rec": True, "shared.my_disc": True}), "meta")
    assert type(variants.discriminator).__name__ == "DCGANDiscriminator"
    assert type(variants.recognizer).__name__ == "BiLSTMRecognizer"
    assert type(variants.style_promoter).__name__ == "StylePromoter"  # BigGAN W, as in JAX
    assert variants.style_promoter.trunk.attn_B1.use_kernel
    with pytest.raises(ValueError):
        build_generator(cfg_for(**{"shared.dtype": "float16"}))
    # 'subpixel' is a TPU lowering of the same transposed conv
    variables = convert.fake_flax_variables(cfg_for(), seed=2)
    labels, z, _ = inputs(2, False)
    a = run_port(convert.generator_from_flax(variables, cfg_for()), labels, z)
    b = run_port(convert.generator_from_flax(
        variables, cfg_for(**{"shared.conv_lowering": "subpixel"})), labels, z)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("suffix", ["npy", "png"])
def test_infer_cli_writes_images(tmp_path, suffix):
    cfg = cfg_for()
    variables = convert.fake_flax_variables(cfg, seed=3)
    weights = tmp_path / "g.npz"
    convert.save_flax_npz(str(weights), variables)
    out = tmp_path / f"cab.{suffix}"
    assert infer.main(["--weights", str(weights), "--word", "cab", "-n", "2",
                       "--device", "cpu", "--seed", "5", "--out", str(out)]) == 0
    if suffix == "png":  # an image grid through scrabblegan_tpu.utils.viz
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        return
    images = np.load(out)
    assert images.shape == (2, 32, 48, 1) and images.dtype == np.float32
    assert np.isfinite(images).all() and np.abs(images).max() <= 1.0
    z = np.random.default_rng(5).standard_normal((2, 128)).astype(np.float32)
    labels = np.array([[2, 0, 1]] * 2, np.int32)
    np.testing.assert_array_equal(
        images, run_port(convert.generator_from_flax(variables, cfg), labels, z))


def test_export_script_npz_round_trip(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "export_generator_npz", REPO / "scripts" / "export_generator_npz.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    tree = convert.fake_fill({p: s.shape for p, s in jax_tree_shapes(False).items()
                              if "attn_B3" in p}, seed=4)
    np.savez(tmp_path / "t.npz", **script.flatten_npz_dict(tree))
    back = convert.flatten(convert.load_flax_npz(str(tmp_path / "t.npz")))
    want = convert.flatten(tree)
    assert sorted(back) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], arr)


def test_port_imports_no_jax():
    code = """
import sys
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax"}
for name in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"the port imported {name}")

sys.meta_path.insert(0, Block())
import scrabblegan_torch.models.generator, scrabblegan_torch.convert, scrabblegan_torch.infer
import scrabblegan_torch.models.discriminator, scrabblegan_torch.models.recognizer
import scrabblegan_torch.models.style, scrabblegan_torch.models.build
import scrabblegan_torch.train, scrabblegan_torch.train.step, scrabblegan_torch.train.cli
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

"""The serving bundle of the port (`scrabblegan_torch.train.export`) on the
CPU: G at its full widths exported at batch 2, length 3 with noise z, and
reloaded; and the registered attention ops it carries. The export CLI runs
on a Trainer-written model dir in tests/test_torch_loop.py.

- the reloaded program's images equal the eager G's, bitwise, in JAX's
  layout (NHWC, float32), and the program holds the attention op;
- meta.json holds JAX's keys (scrabblegan_tpu/train/export.py) and the
  device, dataflow and dtype;
- the loader runs in a fresh process in which `scrabblegan_torch.models`
  and `scrabblegan_torch.ops` cannot be imported, and serves the same
  images;
- each op's fake implementation gives the shape, dtype and device of the
  CUDA path, traced on fake CUDA tensors.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from scrabblegan_torch.convert import fake_flax_variables, generator_from_flax
from scrabblegan_torch.kernels import attention, fused_block
from scrabblegan_torch.models.build import noise_config
from scrabblegan_torch.train.export import export_generator, load_exported_generator

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_META_KEYS = {"batch_size", "length", "z_source", "latent_dim", "img_hw"}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    cfg = noise_config(None, {})
    g = generator_from_flax(fake_flax_variables(cfg, 0), cfg, "cpu")
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 52, (2, 3)).astype(np.int32)
    z = rng.standard_normal((2, 128)).astype(np.float32)
    with torch.no_grad():
        want = g(torch.from_numpy(labels).long(), torch.from_numpy(z)).permute(0, 2, 3, 1)
    root = tmp_path_factory.mktemp("bundle")
    out = export_generator(str(root / "g"), g, 2, 3, "noise")
    np.save(root / "labels.npy", labels)
    np.save(root / "z.npy", z)
    return Path(out), labels, z, want


def test_reloaded_program_equals_eager_g(bundle):
    path, labels, z, want = bundle
    call, meta = load_exported_generator(str(path))
    got = call(labels, z)
    assert got.shape == (2, 32, 48, 1) and got.dtype == torch.float32
    assert torch.equal(got, want)
    program = torch.export.load(str(path / "generator.pt2"))
    targets = {str(n.target) for n in program.graph.nodes}
    assert "scrabblegan.attention_fwd.default" in targets


def test_meta_holds_jax_s_keys(bundle):
    meta = json.loads((bundle[0] / "meta.json").read_text())
    assert JAX_META_KEYS <= set(meta)
    assert meta == {"batch_size": 2, "length": 3, "z_source": "noise", "latent_dim": 128,
                    "img_hw": [32, 160], "device": "cpu", "dataflow": "nhwc1",
                    "dtype": "float32"}


LOAD_WITHOUT_MODELS = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[:2] in (["scrabblegan_torch", "models"], ["scrabblegan_torch", "ops"]):
            raise ImportError(f"{name} is not importable here")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
torch.set_num_threads(1)
from scrabblegan_torch.train.export import load_exported_generator
root = sys.argv[1]
call, meta = load_exported_generator(root + "/g")
images = call(np.load(root + "/labels.npy"), np.load(root + "/z.npy"))
np.save(root + "/served.npy", images.numpy())
assert not [m for m in sys.modules if m.startswith(("scrabblegan_torch.models",
                                                     "scrabblegan_torch.ops"))]
print("served", tuple(images.shape))
"""


def test_loader_needs_no_model_code(bundle):
    path, _, _, want = bundle
    proc = subprocess.run([sys.executable, "-c", LOAD_WITHOUT_MODELS, str(path.parent)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served (2, 32, 48, 1)" in proc.stdout
    np.testing.assert_array_equal(np.load(path.parent / "served.npy"), want.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations_give_the_cuda_path_s_outputs(dtype):
    """On fake CUDA tensors (no card needed) each op's fake gives what the
    CUDA launchers allocate: attention_fwd (B, Cg, Q), attention_bwd the
    operands' shapes, fused_block_fwd x's shape, all in the operands' dtype
    on their device; the CPU implementations agree."""
    b, c, q, k = 2, 64, 96, 24
    shapes = {"thetaT": (b, 8, q), "phiT": (b, 8, k), "gT": (b, 32, k), "doutT": (b, 32, q),
              "x": (b, c, q), "w_theta": (c, 8), "w_out": (32, c)}
    real = {n: torch.randn(s).to(dtype) for n, s in shapes.items()}
    cpu = {"fwd": attention.attention_fwd(real["thetaT"], real["phiT"], real["gT"]),
           "bwd": attention.attention_bwd(real["thetaT"], real["phiT"], real["gT"],
                                          real["doutT"]),
           "fused": fused_block.fused_block_fwd(real["x"], real["w_theta"], real["phiT"],
                                                real["gT"], real["w_out"])}
    with FakeTensorMode():
        t = {n: torch.empty(s, dtype=dtype, device="cuda") for n, s in shapes.items()}
        fake = {"fwd": attention.attention_fwd(t["thetaT"], t["phiT"], t["gT"]),
                "bwd": attention.attention_bwd(t["thetaT"], t["phiT"], t["gT"], t["doutT"]),
                "fused": fused_block.fused_block_fwd(t["x"], t["w_theta"], t["phiT"], t["gT"],
                                                     t["w_out"])}
    want = {"fwd": [(b, 32, q)], "bwd": [(b, 8, q), (b, 8, k), (b, 32, k)], "fused": [(b, c, q)]}
    for name, outs in fake.items():
        outs = outs if isinstance(outs, tuple) else (outs,)
        cpus = cpu[name] if isinstance(cpu[name], tuple) else (cpu[name],)
        assert [tuple(o.shape) for o in outs] == [tuple(o.shape) for o in cpus] == want[name]
        assert all(o.dtype == dtype and o.device.type == "cuda" for o in outs), name
        assert all(o.dtype == dtype for o in cpus), name

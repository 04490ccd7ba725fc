"""The port's bench twin (scrabblegan_torch/bench.py) run small on the CPU.

Its five sections at batch 2 (`bench.run`), one forward or step a timed
run (no warm-up calls: the CPU captures no graph), the e2e Trainer at 2
epochs of 1 batch: each line on stdout parses, the last
carries every key of the JAX bench's line (bench.py), each line holds the
one before it, and the FLOP counts behind the shares equal
`utils/flops.py`'s for the same function at the same shapes.
"""

from __future__ import annotations

import json

import torch

from scrabblegan_torch import bench
from scrabblegan_torch.convert import fake_flax_variables, generator_from_flax
from scrabblegan_torch.models.build import build_models, noise_config
from scrabblegan_torch.train.state import new_train_state
from scrabblegan_torch.train.step import make_train_step
from scrabblegan_torch.utils.flops import matmul_flops

JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
JAX_EXTRA = ("mfu_inference_len5", "train_steps_per_sec_batch16", "mfu_train_len5",
             "train_steps_per_sec_e2e", "e2e_over_raw", "images_per_sec_len10",
             "mfu_inference_len10", "train_steps_per_sec_len10", "mfu_train_len10")


def test_sections_small_on_the_cpu(capsys):
    torch.manual_seed(0)
    bench.run("cpu", inference_batch=2, train_batch=2, iters=(1, 1), train_steps=1, windows=1,
              e2e_batches=1, e2e_epochs=2)
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 5
    for before, after in zip(lines, lines[1:]):
        assert set(before["extra"]) <= set(after["extra"])
    last = lines[-1]
    assert all(k in last for k in JAX_KEYS) and all(k in last["extra"] for k in JAX_EXTRA)
    assert last["metric"] == "word_images_per_sec_per_chip" and last["unit"] == "images/s"
    assert last["value"] > 0 and last["vs_baseline"] == last["value"] / 5000
    extra = last["extra"]
    assert extra["peak_tflops"] == 989 and extra["card"] is None
    for key in JAX_EXTRA:
        assert extra[key] > 0, key

    # the FLOPs behind the shares are utils/flops.py's
    cfg = noise_config(None, {"shared.batch_size": 2, "shared.dtype": "bfloat16"})
    g = generator_from_flax(fake_flax_variables(cfg, seed=0), cfg, "cpu")
    for length in (5, 10):
        with torch.no_grad():
            want = matmul_flops(g, torch.zeros((2, length), dtype=torch.long),
                                torch.zeros((2, cfg.shared.latent_dim)))
        assert extra[f"flops_inference_len{length}"] == want
    cfg5 = bench.trainer_cfg(5, 2)
    state = new_train_state(cfg5, build_models(cfg5))  # the count reads shapes, not values
    assert extra["flops_train_len5"] == matmul_flops(make_train_step(cfg5, state.models), state,
                                                     bench.uint8_batch(2, 5))
    assert extra["mfu_train_len5"] == (
        extra["train_steps_per_sec_batch16"] * extra["flops_train_len5"] / 989e12)

"""The analytic work counts: repeatable, from the reference on the meta
device, and the attention core's equal to 2 Q K (Ca + Cv)."""

import re

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import common, weights, work


def _leaves(cell):
    from scrabblegan_torch.models.build import build_models

    _, _, cfg_file = common.find_cell(common.manifest(), cell)
    models = build_models(common.port_config(cfg_file), "meta")
    return cfg_file, {net: weights.specs(m) for net, (_, m) in zip("gdrw", models.items())}


def test_generator_and_step_counts_repeat():
    cfg_file, leaves = _leaves("train.recommended.b16")
    one = work.generator_flops(leaves["g"], 8, 3)
    assert one == work.generator_flops(leaves["g"], 8, 3) > 0
    # linear in the batch but for the spectral norms' power iterations, one a layer a call
    two, three = (work.generator_flops(leaves["g"], 8 * n, 3) for n in (2, 3))
    assert three - two == two - one > 0.99 * one
    step = work.train_step_flops(cfg_file, leaves, 2, 2)
    assert step == work.train_step_flops(cfg_file, leaves, 2, 2) > 3 * work.generator_flops(
        leaves["g"], 2, 2, style=True)


@pytest.mark.parametrize("b,q,k", [(2, 64, 16), (3, 160, 40)])
def test_attention_core_count(b, q, k):
    flops, nbytes = work.attention_core(b, q, k)
    assert flops == 2 * q * k * (8 + 32) * b
    assert nbytes == b * (8 * q + 8 * k + 32 * k + 32 * q) * 2
    theta, phi, g = torch.zeros(b, 8, q), torch.zeros(b, 8, k), torch.zeros(b, 32, k)
    counter = FlopCounterMode(display=False)
    with counter:
        attn = torch.softmax(torch.matmul(theta.transpose(1, 2), phi), -1)
        torch.matmul(g, attn.transpose(1, 2))
    assert counter.get_total_flops() == flops


def test_readers_take_no_work_from_the_program():
    for path in [*(common.BENCH_DIR / "metrics").glob("*.py"), common.BENCH_DIR / "work.py"]:
        assert not re.search(r"scrabblegan_torch|utils\.flops", path.read_text()), path.name

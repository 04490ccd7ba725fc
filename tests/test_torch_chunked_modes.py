"""The chunked train step of the port on the CPU against the eager step, at
the networks' full widths, batch 2, words of 2 characters: K = 3 steps a
call (`make_chunked_train_step`) against 3 sequential `make_train_step`
calls from the same state, bitwise: every parameter, statistic, moment,
count, the EMA, the step counters and the 16 metrics of each step; in padded
and bucketed mode, `disc_iters` 2 (G's update masked on the device) and the
cosine schedule (a learning rate evaluated on the device from the count).
The padded case runs here and the bucketed one in
test_torch_chunked_modes_bucketed.py, so that the two full-width runs go to
two test workers.
"""

import pytest
import torch

import test_torch_step_parity as parity
from scrabblegan_torch.train.step import (METRIC_NAMES, make_chunked_train_step,
                                          make_train_step)
from test_torch_chunked import K, all_tensors, assert_bitwise, port_state, stacked

torch.set_num_threads(1)

SCHEDULE = {"optimizer.disc_iters": 2, "optimizer.lr_schedule": "cosine",
            "optimizer.decay_steps": 4}
MODES = {"padded": dict(padded=True, **SCHEDULE), "bucketed": dict(padded=False, **SCHEDULE)}


@pytest.mark.parametrize("mode", ["padded"])
def test_chunk_equals_sequential_eager_steps(mode):
    cfg = parity.config(**MODES[mode])
    batches = [parity.make_batch(cfg, 2, seed=s) for s in range(K)]
    eager, chunked = port_state(cfg), port_state(cfg)
    step = make_train_step(cfg, eager.models)
    rows = [step(eager, b) for b in batches]
    want = torch.stack([torch.stack([m[n] for n in METRIC_NAMES]) for m in rows], dim=1)
    got = make_chunked_train_step(cfg, chunked.models)(chunked, stacked(batches))
    assert got.shape == (16, K) and torch.equal(got, want)
    assert chunked.step == eager.step == K
    assert_bitwise(all_tensors(chunked), all_tensors(eager))
    # the cadence: G moved once in 3 steps (at step 2), D on every step
    assert int(chunked.opt_states["g"].count) == 1 and int(chunked.opt_states["d"].count) == 3

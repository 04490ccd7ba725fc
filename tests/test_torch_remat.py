"""`shared.remat` in the port: G's own pass under the non-reentrant
`torch.utils.checkpoint`, on the CPU, at the networks' full widths, batch
2, words of 2 characters, padded mode.

- One remat step against the plain port step from the same state, at
  tests/test_remat.py's tolerances (metrics rtol 1e-4, atol 1e-5; G's
  parameters rtol 1e-3, atol 1e-5), the statistics of every network at
  the metrics' tolerance.
- The statistics are proposed once: the backward recomputes G's layers
  (more proposals are made than without remat), but no record is open
  then, so the proposals that land in a record, and what is committed,
  are those of the plain step.
"""

import pytest
import torch

import test_torch_step_parity as parity
from scrabblegan_torch.ops import blocks, layers
from scrabblegan_torch.train.step import METRIC_NAMES, make_train_step
from test_torch_chunked import port_state

torch.set_num_threads(1)


def run(remat: bool, monkeypatch):
    """One step; returns (state, metrics, proposals made, proposals kept)."""
    counts = {"made": 0, "kept": 0}
    original = layers.propose_stats

    def counting(module, **values):
        counts["made"] += 1
        counts["kept"] += layers._RECORD.get() is not None
        original(module, **values)
    monkeypatch.setattr(layers, "propose_stats", counting)
    monkeypatch.setattr(blocks, "propose_stats", counting)
    cfg = parity.config(padded=True, **{"shared.remat": remat})
    state = port_state(cfg)
    metrics = make_train_step(cfg, state.models)(state, parity.make_batch(cfg, 2))
    monkeypatch.undo()
    return state, metrics, counts["made"], counts["kept"]


@pytest.fixture(scope="module")
def steps():
    mp = pytest.MonkeyPatch()
    return {remat: run(remat, mp) for remat in (False, True)}


def test_remat_step_matches_plain(steps):
    (plain, m0, _, _), (remat, m1, _, _) = steps[False], steps[True]
    for name in METRIC_NAMES:
        torch.testing.assert_close(m1[name], m0[name], rtol=1e-4, atol=1e-5, msg=name)
    for a, b in zip(remat.params("g"), plain.params("g")):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    for net, module in remat.modules().items():
        want = plain.modules()[net].state_dict()
        for key, value in module.state_dict().items():
            torch.testing.assert_close(value, want[key], rtol=1e-4, atol=1e-5,
                                       msg=f"{net}.{key}")


def test_remat_proposes_statistics_once(steps):
    (_, _, made0, kept0), (_, _, made1, kept1) = steps[False], steps[True]
    assert made1 > made0  # the backward ran G's layers again
    assert kept1 == kept0 > 0  # and none of its proposals reached a record

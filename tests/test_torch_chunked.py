"""The chunked train step of the port (`make_chunked_train_step`) on the
CPU, at the networks' full widths, batch 2, words of 2 characters (its
bitwise agreement with eager steps is test_torch_chunked_modes.py):

- against JAX's `make_chunked_train_step` from the same weights, K = 3,
  `disc_iters` 2 (G updated once, at the second step; D, R and W three
  times): the one test here that compiles a JAX step. JAX's chunk is a
  `lax.scan` of its step over the stacked batch and the K rngs, the cadence
  by `lax.cond` on the step counter; tests/test_chunked.py holds it to K
  sequential calls of the jitted step on the same batches and rngs (within
  XLA's reassociation, ~1e-4 relative). The JAX side here makes those K
  calls: XLA's CPU backend runs the scanned body ~30x slower than the
  standalone step (200-345 s against ~3 s a step, measured on this test's
  shapes), so one jit and K calls keep the file inside the suite's time. The learning rates are 2e-6: lean
  Adam's first update is +-lr on every element whatever the gradient's
  size, so gradient entries at rounding level take opposite signs in the
  two implementations; at the default 2e-4 those flips part the two
  trajectories by 1-13% in some metrics by the third step, while at 2e-6
  they move no metric by more than 2e-5 relative. What is held, and what
  each check would catch:
  - the 16 metrics of the 3 steps at tests/test_chunked.py's tolerance
    (rtol 5e-3, atol 1e-4): a wrong loss, a wrong batch or step order;
  - the four optimizers' counts and the step counters, exactly: an
    inverted or missing `disc_iters` mask (G's count 2 or 3, not 1);
  - G's update by the rule of the one-step parity tests (the gradient
    read from lean Adam's nu within 1e-1 of its scale, and the update's
    sign wherever no such error can flip it): a G update that is missing,
    taken at the wrong step or from the wrong gradient;
  - each network's parameter change (after minus before) and the EMA's
    change against JAX's, within 0.1 of JAX's change in norm (the flips
    of rounding-level entries leave 0.05 for G, 9e-3 for R, 3e-3 for W,
    1e-4 for D): a missing update (error 1), a bias correction that is
    off (lean Adam's first update without it is 31.6 lr), a missing EMA
    step. The EMA decay is 0.5 here, so its change is half the parameters'
    and not lost in the rounding of an EMA that moves by 1e-3 of a step;
  - every network's statistics (BN running stats, spectral norm's u and
    sigma) at the one-step tests' 1e-4: statistics committed from the wrong
    pass or not at all;
- the (16, K) metrics of a call are a fresh tensor: a later call does not
  write into an earlier one's block.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_step_parity as parity
from scrabblegan_torch.convert import flatten, state_from_flax, to_flax
from scrabblegan_torch.train.step import METRIC_NAMES, make_chunked_train_step
from scrabblegan_tpu.train.step import make_train_step as jax_make_train_step

torch.set_num_threads(1)

K = 3


def port_state(cfg, seed=0):
    trees = {n: parity.fake_tree(cfg, n, seed) for n in "gdrw"}
    return state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                           {n: t.get("batch_stats", {}) for n, t in trees.items()})


def stacked(batches):
    return {key: np.stack([b[key] for b in batches]) for key in batches[0]}


def all_tensors(state) -> dict:
    """Every tensor of the state by name, for a bitwise comparison."""
    out = {}
    for net, module in state.modules().items():
        out.update({f"{net}.{k}": v for k, v in module.state_dict().items()})
        s = state.opt_states[net]
        out[f"{net}.count"] = s.count
        out.update({f"{net}.nu{i}": v for i, v in enumerate(s.nu)})
        out.update({f"{net}.mu{i}": v for i, v in enumerate(s.mu or ())})
    out.update({f"ema{i}": v for i, v in enumerate(state.g_ema or ())})
    out["step_t"] = state.step_t
    return out


def assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


def change_error(after: dict, want: dict, before: dict) -> float:
    """|(after - before) - (want - before)| / |want - before| over the
    leaves of flat trees, in float64."""
    paths = sorted(want)
    got = np.concatenate([np.asarray(after[p], np.float64).ravel() for p in paths])
    ref = np.concatenate([np.asarray(want[p], np.float64).ravel() for p in paths])
    start = np.concatenate([np.asarray(before[p], np.float64).ravel() for p in paths])
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref - start))


@pytest.fixture(scope="module")
def chunk_pair():
    """K steps of JAX's step and one K-step call of the port's chunk from the
    same start: (port metrics (16, K), JAX metrics, the StepPair)."""
    cfg = parity.config(padded=True, **{"parallel.steps_per_call": K, "optimizer.disc_iters": 2,
                                        "optimizer.g_ema_decay": 0.5,
                                        **{f"optimizer.{n}_lr": 2e-6 for n in "gdrw"}})
    models, jstate, trees = parity.jax_start_state(cfg)
    batches = [parity.make_batch(cfg, 2, seed=s) for s in range(K)]
    step = jax.jit(jax_make_train_step(cfg, models))  # the body of JAX's chunk
    jax_after, per_step = jstate, []
    for batch, rng in zip(batches, jax.random.split(jax.random.PRNGKey(1), K)):
        jax_after, metrics = step(jax_after, batch, rng)
        per_step.append(metrics)
    jax_metrics = {name: np.stack([np.asarray(m[name]) for m in per_step])
                   for name in METRIC_NAMES}
    state = state_from_flax(cfg, {n: t[0] for n, t in trees.items()},
                            {n: t[1] for n, t in trees.items()})
    before = {n: to_flax(m) for n, m in state.modules().items()}
    got = make_chunked_train_step(cfg, state.models)(state, stacked(batches)).numpy()
    return got, jax_metrics, parity.StepPair(cfg, jstate, jax_after, {}, state, {}, before)


def test_chunk_matches_jax_chunked_step(chunk_pair):
    got, jax_metrics, _ = chunk_pair
    for j, name in enumerate(METRIC_NAMES):
        want = np.asarray(jax_metrics[name])
        assert np.isfinite(got[j]).all(), name
        np.testing.assert_allclose(got[j], want, rtol=5e-3, atol=1e-4, err_msg=name)


def test_chunk_counts_match_jax(chunk_pair):
    state, jax_after = chunk_pair[2].port_state, chunk_pair[2].jax_after
    assert state.step == int(jax_after.step) == int(state.step_t) == K
    for net in "gdrw":
        count = int(getattr(jax_after, f"{net}_opt")[0].count)
        assert int(state.opt_states[net].count) == count == (1 if net == "g" else K), net


def test_chunk_g_update_matches_jax(chunk_pair):
    assert parity.check_gradients_of(chunk_pair[2], "g", 1e-1) > 1e-3


def test_chunk_parameter_and_ema_changes_match_jax(chunk_pair):
    pair = chunk_pair[2]
    state, jax_after, before = pair.port_state, pair.jax_after, pair.port_before
    for net, module in state.modules().items():
        err = change_error(flatten(to_flax(module)["params"]),
                           flatten(getattr(jax_after, f"{net}_params")),
                           flatten(before[net]["params"]))
        assert err < 0.1, f"{net} parameter change: error {err} of JAX's"
    err = change_error(parity._port_tree(state.models.generator, state.g_ema),
                       flatten(jax_after.g_ema), flatten(before["g"]["params"]))
    assert err < 0.1, f"EMA change: error {err} of JAX's"


def test_chunk_statistics_match_jax(chunk_pair):
    assert parity.check_stats(chunk_pair[2], rtol=1e-4, atol=1e-4) > 100


def test_chunk_metrics_do_not_alias():
    cfg = parity.config(padded=False)
    state = port_state(cfg)
    chunk = make_chunked_train_step(cfg, state.models)
    first = chunk(state, stacked([parity.make_batch(cfg, 2, seed=0)]))
    kept = first.clone()
    second = chunk(state, stacked([parity.make_batch(cfg, 2, seed=1)]))
    assert first.shape == second.shape == (16, 1)
    assert first.data_ptr() != second.data_ptr() and torch.equal(first, kept)
    assert not torch.equal(first, second)
    assert chunk.graphs is None  # the CPU runs the body eagerly

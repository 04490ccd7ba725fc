"""The BiLSTM recognizer (`shared.my_rec`) of the port against the JAX module
on the CPU, at its full widths, batch 2, word length 2 (images 32 x 32, T = 8
frames of 53 classes): eval mode, and train mode (BN on the batch, its
statistics, the parameter gradients) with dropout replaced by the identity on
both sides (flax's `nn.Dropout` and the port's `dropout` monkeypatched; the
two frameworks draw other bits); `ctc_time_steps`; the float32 LSTM under a
bfloat16 `shared.dtype`; and the port's dropout stream: rate, scaling, and
one stream read by both R passes of a step.

Tolerances: float32 outputs and statistics 1e-4, gradients 2e-4 of the
network's largest (tests/test_torch_models.py; five recurrent layers over 8
frames). The bfloat16 network holds its logits at 2e-2: its convs and its
Dense round in bfloat16, the frameworks at other places.
"""

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

import test_torch_models as tm
import test_torch_step_parity as parity
from scrabblegan_tpu.models.recognizer import BiLSTMRecognizer as JaxBiLSTM
from scrabblegan_tpu.models.recognizer import ctc_time_steps as jax_ctc_time_steps
from scrabblegan_torch.convert import fake_fill, flatten, load_flax, state_from_flax
from scrabblegan_torch.models import recognizer
from scrabblegan_torch.models.recognizer import BiLSTMRecognizer, ctc_time_steps
from scrabblegan_torch.ops import dropout as port_dropout
from scrabblegan_torch.train.step import make_train_step

torch.set_num_threads(1)

X = tm.rand(31, (2, 32, 32, 1))
W = np.random.default_rng(32).standard_normal((2, 8, 53)).astype(np.float32)


def frame_loss(out):
    return (out * (W if isinstance(out, jax.Array) else torch.from_numpy(W))).sum()


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(recognizer, "dropout", lambda x, rate, deterministic: x)


def jax_variables(module, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), X, False))
    return fake_fill({p: s.shape for p, s in flatten(shapes).items()}, seed)


def test_eval_mode_matches_jax():
    module = JaxBiLSTM(num_classes=53)
    v = jax_variables(module, 33)
    want = np.asarray(module.apply(v, X, False))
    port = load_flax(BiLSTMRecognizer(53), v).eval()
    with torch.no_grad():
        got = port(tm.nchw(X))
    assert got.shape == (2, ctc_time_steps(32, my_rec=True), 53) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tm.TOL, atol=tm.TOL)


def test_train_mode_matches_jax(no_dropout):
    v, out, stats, grads = tm.jax_train(JaxBiLSTM(num_classes=53), (X, True), {}, 34,
                                        frame_loss)
    port = load_flax(BiLSTMRecognizer(53), v)
    p_out, p_stats, before, p_grads = tm.port_train(port, (tm.nchw(X),), frame_loss)
    assert any(not np.array_equal(p_stats[k], before[k]) for k in p_stats)
    tm.check(out, p_out.numpy(), stats, p_stats, grads, p_grads)


def test_bfloat16_network_keeps_a_float32_lstm(monkeypatch):
    """JAX passes no dtype to OptimizedLSTMCell: under shared.dtype bfloat16
    the LSTM promotes to its float32 parameters."""
    module = JaxBiLSTM(num_classes=53, dtype=jax.numpy.bfloat16)
    v = jax_variables(module, 35)
    want = np.asarray(module.apply(v, X, False))
    port = load_flax(BiLSTMRecognizer(53, dtype=torch.bfloat16), v).eval()
    assert all(p.dtype == torch.float32 for p in port.parameters())
    seen, lstm = [], torch.lstm
    monkeypatch.setattr(torch, "lstm", lambda x, *a: seen.append(x.dtype) or lstm(x, *a))
    with torch.no_grad():
        got = port(tm.nchw(X))
    assert seen == [torch.float32] * 5
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("width", [16, 32, 80, 160])
@pytest.mark.parametrize("my_rec", [False, True])
def test_ctc_time_steps(width, my_rec):
    assert ctc_time_steps(width, my_rec) == jax_ctc_time_steps(width, my_rec)


def test_dropout_rate_scale_and_stream():
    key = port_dropout.step_key(torch.tensor(7), torch.tensor(3))
    x = torch.ones(4, 64, 128)
    with port_dropout.dropout_stream(key):
        a = port_dropout.dropout(x, 0.2, deterministic=False)
        b = port_dropout.dropout(x, 0.2, deterministic=False)
    with port_dropout.dropout_stream(key):
        again = port_dropout.dropout(x, 0.2, deterministic=False)
    assert set(a.unique().tolist()) == {0.0, 1.25}
    assert abs((a > 0).float().mean().item() - 0.8) < 0.01
    assert torch.equal(a, again) and not torch.equal(a, b)  # call numbers restart
    other = port_dropout.step_key(torch.tensor(7), torch.tensor(4))
    with port_dropout.dropout_stream(other):
        assert not torch.equal(port_dropout.dropout(x, 0.2, deterministic=False), a)
    assert torch.equal(port_dropout.dropout(x, 0.2, deterministic=True), x)
    with pytest.raises(RuntimeError, match="stream"):
        port_dropout.dropout(x, 0.2, deterministic=False)


def test_both_r_passes_of_a_step_read_one_stream(monkeypatch):
    """With dropout on, R's pass on fake images and its pass on real ones
    draw the same masks (one key, the calls numbered from 0 in each), as
    both JAX passes read the step's one rng_drop; the next step draws new
    ones."""
    cfg = parity.config(padded=False, **{"shared.my_rec": True, "shared.my_disc": True,
                                         "shared.use_style_promoter": False})
    trees = {n: parity.fake_tree(cfg, n) for n in "gdrw"}
    state = state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                            {n: t.get("batch_stats", {}) for n, t in trees.items()})
    drawn = []
    keep_mask = port_dropout.keep_mask
    monkeypatch.setattr(port_dropout, "keep_mask",
                        lambda *a: drawn.append((a[1], keep_mask(*a))) or drawn[-1][1])
    step = make_train_step(cfg, state.models)
    step(state, parity.make_batch(cfg, 2))
    assert [c for c, _ in drawn] == list(range(11)) * 2
    for (_, fake), (_, real) in zip(drawn[:11], drawn[11:]):
        assert torch.equal(fake, real)
    first = drawn[:11]
    drawn.clear()
    step(state, parity.make_batch(cfg, 2, seed=1))
    assert not any(torch.equal(a, b) for (_, a), (_, b) in zip(first, drawn[:11]))

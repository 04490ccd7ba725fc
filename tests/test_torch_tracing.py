"""The port's tracer (scrabblegan_torch/utils/profiling.py) and the spans,
counters and phase marks the program records with it.

CPU tests: tracing off records nothing and opens no profiler range; nested
spans' parent ids and self time; a span among a CPU profiler session's
events; `trace(dir)`'s spans.json; the train step's phase order in both
configurations (conv R with ResNet D, BiLSTM R with DCGAN D); the Trainer
feed's `feed.wait`, `feed.make` and `feed.empty`; G's `g.forward` and
`g.style_encoder`. The step and G run on narrowed networks (the width
functions of models/generator.py, discriminator.py and style.py patched to
a few channels, the filter bank to match): the marks and spans do not
depend on the widths, and a full-width CPU step takes seconds.

The `card` test (skips without a CUDA card; on the card: `python -m pytest
--noconftest -m card tests/test_torch_tracing.py`): a captured replay's
phases sum to the replay's own device time within 2%, at full width."""

import json
import threading
import time

import pytest
import torch

from scrabblegan_torch.config import load_config
from scrabblegan_torch.models import discriminator, generator, style
from scrabblegan_torch.models.build import build_generator, build_models
from scrabblegan_torch.train.loop import _Prefetcher
from scrabblegan_torch.train.state import new_train_state
from scrabblegan_torch.train.step import make_chunked_train_step, make_step_body
from scrabblegan_torch.utils import profiling

PHASES = ["step.inputs", "g.fwd", "d.fwd", "w.fwd", "r.fwd", "ctc", "r.fwd", "ctc", "losses",
          "backward.drw", "backward.g", "stats", "update", "ema", "step.end"]
VARIANTS = {"conv_r_resnet_d": {}, "bilstm_r_dcgan_d": {"shared.my_disc": True,
                                                        "shared.my_rec": True}}
BATCH = 2


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _narrow_disc_channels(colors: int = 1, resolution: int = 32):
    outs = [8, 16, 32, 32]
    return [colors] + outs[:-1], outs


@pytest.fixture(scope="module")
def narrow():
    """Patches the networks' widths to a few channels for the module."""
    mp = pytest.MonkeyPatch()
    for module in (generator, discriminator, style):
        mp.setattr(module, "disc_channels", _narrow_disc_channels)
    mp.setattr(generator, "GEN_IN_CHANNELS", (64, 32, 16))
    mp.setattr(generator, "GEN_OUT_CHANNELS", (32, 16, 8))
    yield {"shared.embed_y": [32, 64 * 16]}
    mp.undo()


@pytest.fixture(scope="module")
def steps(narrow):
    """{variant: (body, state)} of the recommended config, narrowed, on the CPU."""
    out = {}
    for name, over in VARIANTS.items():
        cfg = load_config("configs/recommended.json", {**narrow, **over})
        models = build_models(cfg, torch.device("cpu"))
        out[name] = (make_step_body(cfg, models), new_train_state(cfg, models))
    return out


def _inputs(length: int = 1) -> dict:
    gen = torch.Generator().manual_seed(0)
    img = lambda w: torch.randint(0, 256, (BATCH, 32, w, 1), generator=gen, dtype=torch.uint8)
    return {"real_imgs": img(160), "style_imgs": img(160),
            "real_labels": torch.randint(0, 52, (BATCH, 10), generator=gen),
            "fake_labels": torch.randint(0, 52, (BATCH, 10), generator=gen),
            "real_lengths": torch.full((BATCH,), length),
            "fake_lengths": torch.full((BATCH,), length)}


def _refuse(*args, **kwargs):
    raise AssertionError("a profiler range or a device event was made with tracing off")


def test_off_records_nothing_and_opens_no_range(steps, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    assert not profiling.on()
    with profiling.span("a"):
        profiling.count("c")
        profiling.mark("m")
    body, state = steps["conv_r_resnet_d"]
    body(state, _inputs(), None)
    feed = _Prefetcher(lambda: 1, 2, 1)
    assert [feed.get(), feed.get()] == [1, 1]
    feed.close()
    snap = profiling.snapshot()
    assert snap == {"spans": {}, "counters": {}, "replay_ms": [], "phase_ms": {}, "marks": []}
    assert profiling.records() == []


def test_once_is_recorded_with_tracing_off(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    with profiling.once("graphs.capture") as took:
        time.sleep(0.002)
    spans = profiling.snapshot()["spans"]
    assert spans["graphs.capture"]["count"] == 1
    assert spans["graphs.capture"]["seconds"] == took.seconds >= 0.002


def test_nested_spans_parent_ids_and_self_time():
    with profiling.tracing():
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.003)
            with profiling.span("inner"):
                pass
        with profiling.span("outer"):
            pass
    by_name = {}
    for name, start, end, sid, parent, root, thread in profiling.records():
        by_name.setdefault(name, []).append((start, end, sid, parent, root, thread))
    (o1, o2), inners = by_name["outer"], by_name["inner"]
    assert o1[3] is None and o1[4] == o1[2] and o2[3] is None and o2[4] == o2[2]
    assert all(i[3] == o1[2] and i[4] == o1[2] for i in inners)
    assert all(o1[0] <= i[0] <= i[1] <= o1[1] for i in inners)
    assert {r[5] for r in (o1, o2, *inners)} == {threading.get_ident()}
    spans = profiling.snapshot()["spans"]
    inner_ns = sum(i[1] - i[0] for i in inners)
    outer_ns = (o1[1] - o1[0]) + (o2[1] - o2[0])
    assert spans["outer"]["count"] == 2 and spans["inner"]["count"] == 2
    assert spans["outer"]["seconds"] == pytest.approx(outer_ns * 1e-9, abs=1e-12)
    assert spans["outer"]["self_seconds"] == pytest.approx((outer_ns - inner_ns) * 1e-9,
                                                           abs=1e-12)
    assert spans["inner"]["self_seconds"] == spans["inner"]["seconds"] >= 0.003


def test_span_in_profiler_session_and_spans_json(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        with profiling.span("tracer.probe"):
            torch.ones(4).add_(1)
        profiling.count("tracer.count", 3)
    assert not profiling.on()
    assert "tracer.probe" in {e.name for e in prof.events()}
    assert profiling.snapshot()["counters"] == {"tracer.count": 3}
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced.block"):
            torch.ones(4).mul_(2)
    written = json.loads((tmp_path / "spans.json").read_text())
    assert written["spans"]["traced.block"]["count"] == 1
    assert (tmp_path / "trace.json").exists() and (tmp_path / "ops.txt").exists()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eager_step_lists_the_phases_in_order(steps, variant):
    body, state = steps[variant]
    with profiling.tracing():
        body(state, _inputs(), None)
    snap = profiling.snapshot()
    assert snap["marks"] == PHASES
    assert snap["phase_ms"] == {} and snap["replay_ms"] == []  # no device here
    assert snap["spans"]["g.forward"]["count"] == 1  # G's own pass (style z)
    assert snap["spans"]["g.style_encoder"]["count"] == 1


def test_prefetcher_counts_waits_makes_and_empty_queue():
    release = threading.Event()

    def make():
        release.wait(5)
        return "item"

    with profiling.tracing():
        feed = _Prefetcher(make, 3, 1)
        try:
            threading.Timer(0.05, release.set).start()
            assert feed.get() == "item"  # starved: the maker waits for the release
            deadline = time.monotonic() + 5
            while not feed._q.full() and time.monotonic() < deadline:
                time.sleep(0.001)
            assert feed._q.full()
            assert feed.get() == "item"  # ready
            assert feed.get() == "item"
        finally:
            feed.close()
        assert not feed._thread.is_alive()
    snap = profiling.snapshot()
    assert snap["spans"]["feed.wait"]["count"] == 3
    assert snap["spans"]["feed.make"]["count"] == 3
    assert snap["spans"]["feed.wait"]["seconds"] >= 0.04
    assert 1 <= snap["counters"]["feed.empty"] <= 2


def test_prefetcher_thread_spans_are_on_the_producer_thread():
    with profiling.tracing():
        feed = _Prefetcher(lambda: 0, 2, 2)
        feed.get(), feed.get()
        feed.close()
    threads = {name: thread for name, *_, thread in profiling.records()}
    assert threads["feed.wait"] == threading.get_ident() != threads["feed.make"]


@pytest.mark.parametrize("z_source", ["noise", "style"])
def test_generator_spans(narrow, z_source):
    cfg = load_config(None, {**narrow, "shared.z_source": z_source})
    g = build_generator(cfg, torch.device("cpu"))
    labels = torch.randint(0, cfg.io.n_classes, (BATCH, 2))
    with torch.no_grad(), profiling.tracing():
        for _ in range(2):
            if z_source == "noise":
                g(labels, torch.randn(BATCH, cfg.shared.latent_dim))
            else:
                g(labels, style_imgs=torch.zeros(BATCH, 1, 32, 48))
    spans = profiling.snapshot()["spans"]
    assert spans["g.forward"]["count"] == 2
    recs = profiling.records()
    calls = [r for r in recs if r[0] == "g.forward"]
    encoders = [r for r in recs if r[0] == "g.style_encoder"]
    if z_source == "noise":
        assert not encoders
        return
    assert spans["g.style_encoder"]["count"] == 2
    for call, enc in zip(calls, encoders):  # one G call's spans share its id
        assert enc[4] == enc[5] == call[3] == call[5]
    assert spans["g.forward"]["self_seconds"] == pytest.approx(
        spans["g.forward"]["seconds"] - spans["g.style_encoder"]["seconds"], abs=1e-9)


@pytest.mark.card
def test_replay_phases_tile_the_replay_on_the_card(card):
    cfg = load_config("configs/recommended.json")
    models = build_models(cfg, card)
    state = new_train_state(cfg, models)
    chunk = make_chunked_train_step(cfg, models)
    batch = {k: v[None].pin_memory() for k, v in _inputs(length=3).items()}
    for _ in range(4):  # two warm-up steps, the capture, a replay
        chunk(state, batch)
    spans = profiling.snapshot()["spans"]
    assert spans["graphs.warmup"]["count"] == 2 and spans["graphs.capture"]["count"] == 1
    with profiling.tracing():
        for _ in range(3):
            chunk(state, batch)
    torch.cuda.synchronize(card)
    snap = profiling.snapshot()
    assert len(snap["replay_ms"]) == 3
    assert list(snap["phase_ms"]) == list(dict.fromkeys(PHASES[:-1]))
    assert all(ms >= 0 for ms in snap["phase_ms"].values())
    assert sum(snap["phase_ms"].values()) == pytest.approx(snap["replay_ms"][-1], rel=0.02)
    assert snap["spans"]["graphs.replay"]["count"] == 3

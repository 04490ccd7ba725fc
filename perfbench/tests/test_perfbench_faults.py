"""`correct` comes out false when the timed path is broken underneath, and
when the control (the reference one precision below the configuration's)
stands in for the program: each run here skips the harness's look for a card
and drives the rest of a run on the CPU at a small size, with the cell's own
limits."""

import pytest
import torch

from perfbench import run


def small_offline(cfg, traffic):
    traffic.update(batch=4, length=2, compare_batches=2, trace_units=1, warmup=1)


def small_request(cfg, traffic):
    traffic.update(batch=2, length_cycle=[1, 1], style_pages=2, compare_requests=2,
                   compare_longest=1, trace_units=1, warmup=1, warm_requests=2)


def small_train(cfg, traffic):
    cfg["shared"]["batch_size"] = 2
    cfg["io"]["bucket_size"] = 2
    cfg["dataset_rows"] = 16
    traffic.update(length_weights=[0.5, 0.5], trace_units=1, warm_calls=0)


def broken_generator(monkeypatch, fault):
    from scrabblegan_torch.models import build

    real = build.build_generator

    def make(cfg, device="cpu"):
        g = real(cfg, device)
        forward = g.forward

        def broken(labels, z=None, lengths=None, style_imgs=None):
            if fault == "half_batch":  # half the rows computed, the rest copied from them
                h = labels.shape[0] // 2
                out = forward(labels[:h], None if z is None else z[:h], None,
                              None if style_imgs is None else style_imgs[:h])
                return torch.cat([out, out[: labels.shape[0] - h]])
            out = forward(labels, z, lengths, style_imgs).clone()
            out[0] = -out[0]  # one answer altered
            return out
        g.forward = broken
        return g
    monkeypatch.setattr(build, "build_generator", make)


def broken_step(monkeypatch, fault):
    from scrabblegan_torch.train import step

    if fault == "climbing":  # G follows +D(G(z)): its adversarial gradient has the wrong sign
        monkeypatch.setitem(step.GEN_LOSS_REGISTRY, "hinge", lambda fake: fake)
        return
    real = step.make_chunked_train_step

    def make(cfg, models, mesh=None):
        chunk = real(cfg, models, mesh)
        fed = []

        def broken(state, batches, z=None):
            fed.append(batches)
            if fault == "half_batch":
                h = next(iter(batches.values())).shape[1] // 2
                return chunk(state, {k: v[:, :h] for k, v in batches.items()}, z)
            if fault == "stale":  # after set-up's first three calls, the call before's batch
                return chunk(state, fed[-2] if len(fed) > 3 else batches, z)
            kept = [t.detach().clone() for t in _state_tensors(state)]
            out = chunk(state, batches, z)
            with torch.no_grad():  # the state left as it was
                for t, old in zip(_state_tensors(state), kept):
                    t.copy_(old)
            return out
        broken.graphs = chunk.graphs
        return broken
    monkeypatch.setattr(step, "make_chunked_train_step", make)


def _state_tensors(state):
    tensors = [p for m in state.modules().values() for p in m.parameters()]
    tensors += [v for o in state.opt_states.values() for v in o.nu]
    return tensors + list(state.g_ema or [])


# A request's images are one word in one style, the same image `batch` times
# (`infer`'s expansion of one style page), so rows computed once and copied
# are no fault there.
@pytest.mark.parametrize("cell,adjust,fault", [
    ("serve.g.len10.b1024", small_offline, "half_batch"),
    ("serve.g.len10.b1024", small_offline, "altered"),
    ("serve.request.b16", small_request, "altered")])
def test_serving_faults_are_not_correct(monkeypatch, cell, adjust, fault):
    broken_generator(monkeypatch, fault)
    result = run.execute(cell, 2 ** 31 + 41, 0.2, False, "cpu", adjust=adjust)
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "stale", "climbing"])
def test_train_faults_are_not_correct(monkeypatch, fault):
    broken_step(monkeypatch, fault)
    result = run.execute("train.recommended.b16", 2 ** 31 + 43, 0.2, False, "cpu",
                         adjust=small_train)
    assert result["correct"] is False
    if fault == "stale":  # only the steps after the window see it
        start = {k: c for k, c in result["checks"].items() if not k.startswith("steady.")}
        assert all(c["value"] <= c["limit"] for c in start.values()), start


@pytest.mark.parametrize("cell,adjust", [("serve.g.len10.b1024", small_offline),
                                         ("serve.request.b16", small_request),
                                         ("train.recommended.b16", small_train)])
def test_control_is_not_correct(monkeypatch, cell, adjust):
    from perfbench.drivers import offline_batches, requests, train_steps

    for module in (offline_batches, requests, train_steps):
        monkeypatch.setattr(module.Driver, "compare", module.Driver.control)
    result = run.execute(cell, 2 ** 31 + 47, 0.2, False, "cpu", adjust=adjust)
    assert result["correct"] is False

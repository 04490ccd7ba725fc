"""The plain reference agrees with the port at tiny shapes on the CPU, in
float32: each network, and three train steps of each configuration. (The
test imports both; the reference imports nothing of the port.)"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import common, weights
from perfbench.reference import nets, step


def _cfg(cell, **overrides):
    _, _, cfg_file = common.find_cell(common.manifest(), cell)
    return cfg_file, common.port_config(cfg_file, overrides)


@pytest.mark.parametrize("source", ["noise", "style"])
def test_generator(source):
    from scrabblegan_torch.models.build import build_generator

    _, cfg = _cfg("serve.request.b16", **{"shared.z_source": source})
    g = build_generator(cfg, "cpu")
    t = weights.make({"g": weights.specs(g)}, 3, "cpu")["g"]
    labels = torch.tensor([[0, 5, 51], [52, 7, 3]])
    weights.calibrate_generator(t, labels, torch.randn(2, 128),
                                style_imgs=torch.rand(2, 1, 32, 160) * 2 - 1)
    weights.load(g, t)
    z, style = torch.randn(2, 128), torch.rand(2, 1, 32, 160) * 2 - 1
    with torch.no_grad():
        if source == "noise":
            got, want = g(labels, z), nets.generator(nets.Net(t), labels, z)
        else:
            got = g(labels, style_imgs=style)
            want = nets.generator(nets.Net(t), labels, style_imgs=style,
                                  style_net=nets.Net(t, "bfloat16"))
    assert want.std() > 0.05
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", [False, True])
def test_adversary_and_recognizer(variant):
    from scrabblegan_torch.models.build import build_models

    _, cfg = _cfg("train.recommended.b16", **{"shared.trunk_dtype": "float32",
                                               "shared.my_disc": variant,
                                               "shared.my_rec": variant})
    models = build_models(cfg, "cpu")
    x = torch.rand(2, 1, 32, 48) * 2 - 1
    for net, (_, module) in zip("gdrw", models.items()):
        if net == "g":
            continue
        module.eval()
        t = weights.make({net: weights.specs(module)}, 4, "cpu")[net]
        weights.load(module, t)
        with torch.no_grad():
            got = module(x)
            if net == "r":
                want = (nets.bilstm_recognizer(nets.Net(t), x, None) if variant
                        else nets.conv_recognizer(nets.Net(t), x))
            elif net == "d" and variant:
                want = nets.dcgan_discriminator(nets.Net(t), x)
            else:
                want = nets.adversary(nets.Net(t), x)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", ["train.recommended.b16", "train.variant.b16"])
def test_three_train_steps(cell):
    from scrabblegan_torch.models.build import build_models
    from scrabblegan_torch.train.state import new_train_state
    from scrabblegan_torch.train.step import METRIC_NAMES, make_chunked_train_step

    cfg_file, cfg = _cfg(cell, **{"shared.trunk_dtype": "float32", "shared.batch_size": 2,
                                  "io.bucket_size": 2})
    cfg_file = json.loads(json.dumps(dataclasses.asdict(cfg)))
    models = build_models(cfg, "cpu")
    modules = dict(zip("gdrw", (m for _, m in models.items())))
    t = weights.make({n: weights.specs(m) for n, m in modules.items()}, 11, "cpu")
    for n, m in modules.items():
        weights.load(m, t[n])
    state = new_train_state(cfg, models)
    state.dropout_seed.fill_(6)
    chunk = make_chunked_train_step(cfg, models)
    rng = np.random.default_rng(0)
    batches = [{"real_imgs": rng.integers(0, 256, (2, 32, 32, 1), np.uint8),
                "style_imgs": rng.integers(0, 256, (2, 32, 160, 1), np.uint8),
                "real_labels": np.array([[1, 2], [3, 52]], np.int32),
                "fake_labels": np.array([[4, 52], [5, 6]], np.int32),
                "real_lengths": np.array([2, 1], np.int32),
                "fake_lengths": np.array([1, 2], np.int32)} for _ in range(3)]
    call = lambda b: dict(zip(METRIC_NAMES, chunk(state, {  # noqa: E731
        k: torch.from_numpy(v)[None] for k, v in b.items()})[:, 0].tolist()))
    first = call(batches[0])
    nu1 = {n: {k: v.clone() for (k, _), v in zip(modules[n].named_parameters(),
                                                 state.opt_states[n].nu)} for n in modules}
    after_one = {n: {k: p.detach().clone() for k, p in m.named_parameters()}
                 for n, m in modules.items()}
    later = [call(b) for b in batches[1:]]
    ref = step.run_steps(cfg_file, t, batches[:1], 6)
    for name in step.LOSS_NAMES:
        assert first[name] == pytest.approx(ref["losses"][0][name], rel=1e-5, abs=1e-6), name
    for net, params in after_one.items():
        b2 = cfg_file["optimizer"]["beta_2"]
        norms = {k: float(ref["grad1"][net][k].double().norm()) * (1 - b2) ** 0.5
                 for k in params}
        median = float(np.median(list(norms.values())))
        for name, p in params.items():
            if norms[name] < 1e-3 * median:  # moved by round-off alone (ahead of a batch norm)
                continue
            assert float(nu1[net][name].double().sum().sqrt()) == pytest.approx(norms[name],
                                                                               rel=1e-4)
            change = float((p - t[net][name]).norm())
            assert change == pytest.approx(float((ref["params"][net][name] - t[net][name]).norm()),
                                           rel=2e-2), f"{net} {name}"
    # later steps part by round-off amplified through Adam's normalised updates
    ref3 = step.run_steps(cfg_file, t, batches, 6)
    for got, want in zip([first, *later], ref3["losses"]):
        for name in ("d_loss", "s_loss", "r_loss_real", "g_loss_final"):
            assert got[name] == pytest.approx(want[name], rel=3e-2), name

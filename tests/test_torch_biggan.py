"""BigGAN at 128 x 128 in the port (models/biggan.py, the class-conditional
step of train/step.py, the class feed) against the benchmark's plain
reference (perfbench/reference/biggan.py), and the attention kernels at
BigGAN's widths on a card.

CPU: G, D and three steps on seeded weights at the 128 x 128 block layout
with ch 8 and batch 4, in float32 on both sides (the program's CPU path,
which takes the plain attention core), so the two implementations differ by
float32 rounding alone: forwards within 1e-4 of the output's scale, losses
within 1e-4, each leaf's first-step gradient within 2e-3 of its norm, the
leaves' change over three steps within 3e-3 at the median leaf and 1e-2 at
the worst, and the committed statistics within 1e-4 (each tolerance's
reason beside it). The feed, the data file, the CLI's refusal of what BigGAN lacks,
and the CLI's steps at ch 8 from an .npz, resumed from their checkpoint.

Card (`card`, skips without one; `python -m pytest --noconftest -m card
tests/test_torch_biggan.py`): the forward and backward kernels at (12, 48)
and (24, 96), and at (8, 32), against the plain core on the card, within
the bf16 tolerances of tests/test_kernels.py (rtol = atol = 2e-2); G and D
at the published widths in bf16 with their channels_last trunks against the
same networks laid out NCHW (forward and backward), and in float32, both
layouts, against the plain reference, with no cuDNN layout transform in
their profile; the pool launches of a captured step, all of them the pool's
channels_last instance. The CPU tests run the networks NCHW: channels_last
there sums in other orders, which the three steps' float32 bounds do not
leave room for.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from scrabblegan_torch.config import load_biggan, load_config
from scrabblegan_torch.kernels import attention

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

CONFIG = "configs/biggan128.json"
WIDTHS = [(12, 48), (24, 96)]


# ---- the card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def card_operands(b, ca, cg, q, k, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, c, n, generator=gen, device=device).bfloat16()
            for c, n in ((ca, q), (ca, k), (cg, k), (cg, q))]


def assert_close(got, want):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(), rtol=2e-2, atol=2e-2)


SHAPES = [(4, 4096, 1024),  # BigGAN's blocks at 64 x 64: Q 4096, K 1024
          (2, 300, 75),     # ragged: neither Q nor K a multiple of a tile or of 8
          (3, 128, 129)]    # K one past a key tile


@pytest.mark.card
@pytest.mark.parametrize("ca,cg", WIDTHS + [(8, 32)])
@pytest.mark.parametrize("b,q,k", SHAPES)
def test_kernels_match_the_plain_core_on_the_card(card, ca, cg, b, q, k):
    th, ph, g, d = card_operands(b, ca, cg, q, k, card)
    before = dict(attention.width_launches)
    assert_close(attention.attention_fwd(th, ph, g), attention.attention_reference(th, ph, g))
    for got, want in zip(attention.attention_bwd(th, ph, g, d),
                         attention.attention_backward_reference(th, ph, g, d)):
        assert_close(got, want)
    moved = {key: n - before[key] for key, n in attention.width_launches.items()
             if n != before[key]}
    assert moved == {f"attention.launches.{ca}x{cg}": 1,
                     f"attention.bwd_launches.{ca}x{cg}": 1}


@pytest.mark.card
def test_other_widths_and_float32_at_the_new_widths_raise_on_the_card(card):
    for ca, cg, dtype in ((16, 64, torch.bfloat16), (24, 96, torch.float32)):
        th, ph, g, d = (t.to(dtype) for t in card_operands(1, ca, cg, 64, 32, card))
        with pytest.raises(ValueError, match="the CUDA kernels take"):
            attention.attention_fwd(th, ph, g)
        with pytest.raises(ValueError, match="the CUDA kernels take"):
            attention.attention_bwd(th, ph, g, d)


TRANSFORMS = r"nchwToNhwc|nhwcToNchw"  # cuDNN's layout conversions (perfbench/trace.py)


def card_networks(device, batch, plain_float32=False):
    """G and D of configs/biggan128.json (bf16, published widths) on `device`
    with the benchmark's seeded weights, and a batch's labels, z and images;
    `plain_float32`: the same networks computing in float32 on the plain
    attention core."""
    from perfbench import weights
    from scrabblegan_torch.models.build import build_models

    cfg = load_config(CONFIG)
    if plain_float32:
        cfg = dataclasses.replace(cfg, shared=dataclasses.replace(
            cfg.shared, dtype="float32", use_pallas_attention=False))
    models = build_models(cfg, device, load_biggan(CONFIG))
    mods = dict(zip("gd", (m for _, m in models.items())))
    tensors = weights.make({n: weights.specs(m) for n, m in mods.items()}, 7, device)
    for net, module in mods.items():
        weights.load(module, tensors[net])
    gen = torch.Generator(device=device).manual_seed(7)
    y = torch.randint(0, 1000, (batch,), generator=gen, device=device)
    z = torch.randn(batch, 120, generator=gen, device=device)
    x = torch.rand(batch, 3, 128, 128, generator=gen, device=device) * 2 - 1
    return mods, y, z, x


def g_and_d(mods, y, z, x):
    """G's images, D's logits on them and on x, and the gradients of the
    logits' sum for every parameter."""
    img = mods["g"](y, z)
    logits = torch.cat([mods["d"](img, y), mods["d"](x, y)])
    params = [p for net in "gd" for p in mods[net].parameters()]
    return img, logits, torch.autograd.grad(logits.sum(), params)


def reference_g_and_d(mods, y, z, x):
    """`g_and_d` in perfbench/reference/biggan.py (float32, NCHW) on the
    tensors of the port's G and D."""
    import json

    from perfbench.reference import biggan as ref

    with open(CONFIG) as f:
        spec = json.load(f)["biggan"]
    t = {net: {k: v.detach().clone() for k, v in mods[net].state_dict().items()}
         for net in "gd"}
    params = [t[net][k].requires_grad_() for net in "gd" for k, _ in mods[net].named_parameters()]
    img = ref.generator(ref._Net(t["g"], train=True), spec, y, z)
    logits = torch.cat([ref.discriminator(ref._Net(t["d"], train=True), spec, img, y),
                        ref.discriminator(ref._Net(t["d"], train=True), spec, x, y)])
    return img.detach(), logits.detach(), torch.autograd.grad(logits.sum(), params)


def rel_gap(got, want) -> float:
    """|got - want| / |want| over whole tensors (or lists of them)."""
    got, want = ([t.detach().float().flatten() for t in ts] for ts in (got, want))
    return float(torch.cat(got).sub(torch.cat(want)).norm() / torch.cat(want).norm())


@pytest.mark.card
def test_channels_last_networks_match_nchw_on_the_card(card, monkeypatch):
    """G and D in bf16, channels_last and laid out NCHW (the entry's layout
    patched), each against the plain reference (perfbench/reference/
    biggan.py, float32, NCHW, TF32 off) on the same tensors: G's images, D's
    logits and each network's gradient. The two bf16 layouts round in other
    orders (train-mode batch norm at batch 8 spreads that over whole images,
    G's gradient read 7e-2 apart between them), so channels_last is held to
    be no further from float32 than NCHW is, within half as much again and
    5e-3: a fault in a layout reads as far as the quantity itself. Leaves
    whose float32 gradient is under 1e-3 of their network's median leaf (the
    biases ahead of a batch norm, their bf16 gradient round-off) are left
    out."""
    from scrabblegan_torch.models import biggan

    mods, y, z, x = card_networks(card, 8)
    got = g_and_d(mods, y, z, x)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    monkeypatch.setattr(biggan, "trunk_format", lambda device: torch.contiguous_format)
    nchw = g_and_d(mods, y, z, x)
    assert nchw[0].is_contiguous()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ref = reference_g_and_d(mods, y, z, x)
    n_g = len(list(mods["g"].parameters()))
    parts = {"images": lambda r: [r[0]], "logits": lambda r: [r[1]]}
    for net, leaves in (("g", slice(0, n_g)), ("d", slice(n_g, None))):
        norms = torch.stack([t.float().norm() for t in ref[2][leaves]])
        moved = [i for i, n in enumerate(norms.tolist()) if n >= 1e-3 * float(norms.median())]
        parts[f"grad.{net}"] = lambda r, leaves=leaves, moved=moved: [r[2][leaves][i]
                                                                       for i in moved]
    gaps = {name: (rel_gap(pick(got), pick(ref)), rel_gap(pick(nchw), pick(ref)))
            for name, pick in parts.items()}
    assert all(cl <= 1.5 * nc + 5e-3 for cl, nc in gaps.values()), gaps


@pytest.mark.card
def test_channels_last_networks_match_the_reference_on_the_card(card, monkeypatch):
    """G and D in float32 on the plain attention core (TF32 off) at the
    published widths, batch 8, their trunks channels_last as on any card and
    then laid out NCHW (the entry's layout patched), each against the plain
    reference (perfbench/reference/biggan.py, float32, NCHW) on the same
    tensors: G's images and D's logits within 1e-4 of their scale (the CPU
    forwards' bound), and each network's gradient of the logits' sum within
    2e-3 (the CPU first step's bound on a leaf, here over the network's
    leaves whose reference gradient is at least 1e-3 of the median leaf).
    Both layouts meet the same bounds, so the layout the card runs is held
    to an implementation that shares no code with it. The blocks up to each
    network's non-local block run channels_last (read by forward hooks);
    the plain core's non-local block, as the DCGAN D runs it, keeps no
    layout, so the trunk may go on in NCHW after it."""
    from scrabblegan_torch.models import biggan
    from scrabblegan_torch.utils.layout import memory_format

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mods, y, z, x = card_networks(card, 8, plain_float32=True)
    want = reference_g_and_d(mods, y, z, x)
    layouts = []
    for net in "gd":
        for block in mods[net].blocks[:mods[net].attn_after + 1]:
            block.register_forward_hook(lambda m, args, out: layouts.append(memory_format(out)))
    runs = {"channels_last": g_and_d(mods, y, z, x)}
    assert layouts and set(layouts) == {torch.channels_last}
    layouts.clear()
    monkeypatch.setattr(biggan, "trunk_format", lambda device: torch.contiguous_format)
    runs["nchw"] = g_and_d(mods, y, z, x)
    assert layouts and set(layouts) == {torch.contiguous_format}
    n_g = len(list(mods["g"].parameters()))
    gaps = {}
    for layout, got in runs.items():
        gaps[layout] = {name: float((got[i].detach() - want[i]).abs().max() / want[i].abs().max())
                        for i, name in ((0, "images"), (1, "logits"))}
        for net, leaves in (("g", slice(0, n_g)), ("d", slice(n_g, None))):
            norms = [float(t.norm()) for t in want[2][leaves]]
            moved = [i for i, n in enumerate(norms) if n >= 1e-3 * float(np.median(norms))]
            gaps[layout][f"grad.{net}"] = rel_gap([got[2][leaves][i] for i in moved],
                                                  [want[2][leaves][i] for i in moved])
    assert all(g["images"] <= 1e-4 and g["logits"] <= 1e-4 and g["grad.g"] <= 2e-3
               and g["grad.d"] <= 2e-3 for g in gaps.values()), gaps


@pytest.mark.card
def test_channels_last_networks_run_no_layout_transform(card):
    """G and D forward and backward in channels_last launch none of cuDNN's
    NCHW<->NHWC conversion kernels (the profiler's trace), and pool through
    the channels_last instance alone."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from scrabblegan_torch.kernels import pool

    mods, y, z, x = card_networks(card, 8)
    g_and_d(mods, y, z, x)  # cuDNN's first calls outside the trace
    before = (pool.launches, pool.nhwc_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g_and_d(mods, y, z, x)
        torch.cuda.synchronize(card)
    transforms = sorted({e.name for e in prof.events() if re.search(TRANSFORMS, e.name)})
    assert transforms == []
    assert pool.launches - before[0] == pool.nhwc_launches - before[1] == 12


@pytest.mark.card
def test_captured_step_pools_channels_last(card):
    """A captured BigGAN step (batch 8) pools through the channels_last
    instance only: 18 forward and 16 backward launches a step (D's blocks 0-4
    in 3 passes, block 0 twice; the input's pool backward only in the pass
    for G), in the eager warm-up steps and on every replay."""
    from scrabblegan_torch.data.classes import synthetic_classes
    from scrabblegan_torch.kernels import pool
    from scrabblegan_torch.train.classes import class_feed
    from scrabblegan_torch.train.graphs import WARMUP_STEPS
    from scrabblegan_torch.train.state import create_train_state
    from scrabblegan_torch.train.step import make_chunked_train_step

    cfg, spec = load_config(CONFIG), load_biggan(CONFIG)
    cfg = dataclasses.replace(cfg, shared=dataclasses.replace(cfg.shared, batch_size=8))
    state = create_train_state(cfg, 3, card, spec)
    chunk = make_chunked_train_step(cfg, state.models)
    images, labels = synthetic_classes(16, spec.resolution, spec.n_classes, 3)
    calls = WARMUP_STEPS + 1 + 3  # the eager warm-up, the capture, 3 replays
    feed = class_feed(cfg, spec, images, labels, 8, 3, calls, card)
    counts = []
    for _ in range(calls):
        batch = feed.get()
        pool.launches = pool.bwd_launches = pool.nhwc_launches = pool.nhwc_bwd_launches = 0
        chunk(state, batch)
        torch.cuda.synchronize(card)
        counts.append((pool.launches, pool.bwd_launches, pool.nhwc_launches,
                       pool.nhwc_bwd_launches))
    eager, replays = counts[:WARMUP_STEPS], counts[WARMUP_STEPS + 1:]
    assert set(eager) == set(replays) == {(18, 16, 18, 16)}, counts


# ---- the CPU ---------------------------------------------------------------------

def small_config(batch=4):
    """configs/biggan128.json at ch 8 (the 128 x 128 block layout) and
    `batch`, in float32."""
    cfg = load_config(CONFIG)
    cfg = dataclasses.replace(cfg, shared=dataclasses.replace(
        cfg.shared, batch_size=batch, dtype="float32"))
    return cfg, dataclasses.replace(load_biggan(CONFIG), ch=8)


def test_width_outside_the_kernels_raises():
    with pytest.raises(ValueError, match="the CUDA kernels take"):
        attention.check_kernel_widths(16, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="the CUDA kernels take"):
        attention.check_kernel_widths(12, 48, torch.float32)
    for (ca, cg), dtypes in attention.KERNEL_WIDTHS.items():
        for dtype in dtypes:
            attention.check_kernel_widths(ca, cg, dtype)


def seeded(cfg, spec, seed=5):
    """G and D with the benchmark's seeded weights, and the tensors."""
    from perfbench import weights
    from scrabblegan_torch.models.build import build_models

    models = build_models(cfg, "cpu", spec)
    mods = dict(zip("gd", (m for _, m in models.items())))
    tensors = weights.make({n: weights.specs(m) for n, m in mods.items()}, seed, "cpu")
    for net, module in mods.items():
        weights.load(module, tensors[net])
    return models, mods, tensors


def file_config(batch, ch=8):
    import json

    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["shared"].update(batch_size=batch, dtype="float32")
    cfg["biggan"]["ch"] = ch
    return cfg


def class_batches(batch, n, seed=3):
    from scrabblegan_torch.data.classes import synthetic_classes
    from scrabblegan_torch.train.batches import ClassBatches

    images, labels = synthetic_classes(4 * batch, 128, 1000, seed)
    feed = ClassBatches(images, labels, batch, 1000, 120, seed)
    return [feed.next_batch() for _ in range(n)]


def test_forwards_match_the_reference():
    from perfbench.reference import biggan as ref

    cfg, spec = small_config()
    _, mods, tensors = seeded(cfg, spec)
    b = class_batches(4, 1)[0]
    y, z = torch.from_numpy(b["fake_labels"]), torch.from_numpy(b["z"])
    x = (torch.from_numpy(b["real_imgs"]).permute(0, 3, 1, 2).float() - 127.5) / 127.5
    fspec = file_config(4)["biggan"]
    with torch.no_grad():
        got_g, got_d = mods["g"](y, z), mods["d"](x, y)
        want_g = ref.generator(ref._Net(tensors["g"], train=True, momentum=0.9), fspec, y, z)
        want_d = ref.discriminator(ref._Net(tensors["d"], train=True), fspec, x, y)
    assert got_g.shape == (4, 3, 128, 128) and got_d.shape == (4,)
    # float32 on both sides, summed in other orders: 1e-4 of the output's scale
    assert (got_g - want_g).abs().max() <= 1e-4 * want_g.abs().max()
    assert (got_d - want_d).abs().max() <= 1e-4 * want_d.abs().max()


def test_three_steps_match_the_reference():
    from perfbench.reference import biggan as ref
    from scrabblegan_torch.train.state import new_train_state
    from scrabblegan_torch.train.step import METRIC_NAMES, make_chunked_train_step

    cfg, spec = small_config()
    models, mods, tensors = seeded(cfg, spec)
    state = new_train_state(cfg, models)
    chunk = make_chunked_train_step(cfg, models)
    batches = class_batches(4, 3)
    fcfg = file_config(4)
    trainer = ref.Trainer(fcfg, tensors, device="cpu")
    want = [trainer.step(b) for b in batches]
    got, p1, nu1 = [], None, None
    for i, b in enumerate(batches):
        got.append(dict(zip(METRIC_NAMES, chunk(state, {k: torch.from_numpy(v)[None]
                                                       for k, v in b.items()})[:, 0].tolist())))
        if i == 0:
            p1 = {n: [p.detach().clone() for p in m.parameters()] for n, m in mods.items()}
            nu1 = {n: [v.clone() for v in state.opt_states[n].nu] for n in "gd"}
    # the losses: float32 rounding of two orders of summation
    for g, w in zip(got, want):
        for name in ("d_loss", "g_loss"):
            assert g[name] == pytest.approx(w[name], rel=1e-4, abs=1e-5)
    o = fcfg["optimizer"]
    for net, module in mods.items():
        names = [k for k, _ in module.named_parameters()]
        ref_g = trainer.grad1[net]
        median = np.median([float(ref_g[k].norm()) for k in names])
        moved = [k for k in names if float(ref_g[k].norm()) >= 1e-3 * median]
        # a leaf under a thousandth of the median (a bias ahead of a train-mode
        # batch norm) moves by round-off alone, as perfbench's comparison says
        assert len(moved) >= len(names) - 8
        for k, p, v in zip(names, p1[net], nu1[net]):
            if k not in moved:
                continue
            # the first step's gradient from lean Adam's update (beta_1 = 0):
            # g = -dp (sqrt(nu / (1 - b2)) + eps) / lr; 2e-3 of its norm: float32
            # rounding through the spectral norms' sigma and the batch norms
            g = -(p.double() - tensors[net][k].double()) * (
                (v.double() / (1 - o["beta_2"])).sqrt() + 1e-8) / o[f"{net}_lr"]
            assert float((g - ref_g[k].double()).norm()) <= 2e-3 * float(ref_g[k].norm()), k
        # after three steps, each moved leaf's change against the reference's
        # (the median change where its own is smaller): lean Adam moves every
        # entry by about lr whatever its gradient's size, so the round-off
        # leaves' sign flips in step 1 perturb steps 2 and 3 (G's median leaf
        # reads 1e-3, its worst 3e-3; D's 1e-5): median 3e-3, each 1e-2
        state_dict = module.state_dict()
        with torch.no_grad():
            change = {k: float((trainer.t[net][k] - tensors[net][k]).norm()) for k in moved}
            med = np.median(list(change.values()))
            gaps = [float((state_dict[k] - trainer.t[net][k]).norm()) / max(change[k], med)
                    for k in moved]
        assert np.median(gaps) <= 3e-3 and max(gaps) <= 1e-2, (net, max(gaps))
        # the statistics committed: BN's running moments, SN's u and sigma
        for k, buf in module.named_buffers():
            np.testing.assert_allclose(buf.numpy(), trainer.t[net][k].detach().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_class_feed_and_data_file(tmp_path):
    from scrabblegan_torch.data.classes import load_classes, write_synthetic_classes
    from scrabblegan_torch.train.batches import ClassBatches

    path = write_synthetic_classes(str(tmp_path / "c.npz"), 10, 128, 1000, 7)
    images, labels = load_classes(path)
    assert images.shape == (10, 128, 128, 3) and images.dtype == np.uint8
    assert labels.shape == (10,) and labels.dtype == np.int64 and labels.max() < 1000
    chunks = [ClassBatches(images, labels, 4, 1000, 120, 1).next_chunk(3) for _ in range(2)]
    for key in chunks[0]:
        np.testing.assert_array_equal(chunks[0][key], chunks[1][key])  # seeded
    c = chunks[0]
    assert c["real_imgs"].shape == (3, 4, 128, 128, 3) and c["z"].shape == (3, 4, 120)
    assert c["z"].dtype == np.float32 and c["fake_labels"].dtype == np.int64
    feed = ClassBatches(images, labels, 4, 1000, 120, 2)
    rows = [feed._rows() for _ in range(2)]  # one pass over 10 rows: no row twice
    assert len(set(np.concatenate(rows).tolist())) == 8
    np.savez(tmp_path / "bad.npz", images=images[..., :1], labels=labels)
    with pytest.raises(ValueError, match="uint8"):
        load_classes(str(tmp_path / "bad.npz"))


def test_cli_keeps_biggan_in_one_process_and_its_own_options(capsys):
    from scrabblegan_torch.train import cli

    assert cli.main(["--config", CONFIG, "--steps", "1", "--device", "cpu",
                     "--length", "3"]) == 2
    assert cli.main(["--config", "configs/2_gd_only.json", "--steps", "1", "--device", "cpu",
                     "--data", "x.npz"]) == 2
    assert "BigGAN" in capsys.readouterr().err


def test_cli_trains_biggan_steps_from_an_npz_and_resumes(tmp_path, capsys):
    """The steps mode at ch 8, batch 4 from an .npz: a metric line a step, the
    checkpoint, and a second run that resumes from it; no exports."""
    import json

    from scrabblegan_torch.data.classes import write_synthetic_classes
    from scrabblegan_torch.train import cli

    with open(CONFIG) as f:
        file = json.load(f)
    file["biggan"]["ch"] = 8
    file["shared"].update(batch_size=4, dtype="float32")
    config = tmp_path / "biggan8.json"
    config.write_text(json.dumps(file))
    data = write_synthetic_classes(str(tmp_path / "c.npz"), 6, 128, 1000, 3)
    args = ["--config", str(config), "--device", "cpu", "--data", data,
            "--workdir", str(tmp_path / "w")]
    assert cli.main(args + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    steps = [ln.split(":")[0] for ln in out.splitlines() if ln.startswith("step ")]
    assert steps == ["step 1", "step 2"] and "nan" not in out and "skipped" in out
    assert "saved checkpoint" in out and "exported" not in out
    assert cli.main(args + ["--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out and "step 3: d_loss=" in out

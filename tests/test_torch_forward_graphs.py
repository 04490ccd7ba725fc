"""G's inference forward as CUDA graphs (scrabblegan_torch/models/
forward_graphs.py).

CPU tests (narrowed networks, as in tests/test_torch_tracing.py): in
training mode or with gradients on, and on the CPU, the call is the eager
forward and no graph counter moves; the signature changes with each keyed
field; the weights check sees in-place writes as live and `.to()`,
`load_state_dict(assign=True)` and a `functional_call` override as not;
`state_dict` keys are the flax leaves' and a deep copy or a pickle of G
holds no graph state.

The `card` tests (skip without a CUDA card; on the card: `python -m pytest
--noconftest -m card tests/test_torch_forward_graphs.py`), at full width and
batch 16: a replay is bitwise the eager forward for a style-z G (float32, its
style encoder bfloat16) and a noise-z G (bfloat16, under 'nhwc1' and
'fused'); a replay follows in-place weight writes; a `functional_call`
override and `.to()` run eagerly with no stale replay; an outer capture
bypasses the path; a returned output is not overwritten by the next call;
the attention kernel counts one launch a call; the counters read 1 eager, 1
capture and n - 2 replays for n calls of one signature."""

import contextlib
import copy
import pickle

import pytest
import torch
from torch.func import functional_call

from scrabblegan_torch.config import load_config
from scrabblegan_torch.convert import flax_leaves
from scrabblegan_torch.kernels import attention, fused_block
from scrabblegan_torch.models import forward_graphs, generator
from scrabblegan_torch.models.build import build_generator
from scrabblegan_torch.utils import profiling

BATCH = 16
COUNTERS = ("g.graph.eager", "g.graph.capture", "g.graph.replay")
# style z: G float32, its style encoder bfloat16; noise z: G bfloat16
CONFIGS = {"style": {}, "noise": {"shared.z_source": "noise", "shared.dtype": "bfloat16"}}


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _narrow_disc_channels(colors: int = 1, resolution: int = 32):
    outs = [8, 16, 32, 32]
    return [colors] + outs[:-1], outs


@pytest.fixture(scope="module")
def narrow():
    """Patches G's widths to a few channels for the module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(generator, "disc_channels", _narrow_disc_channels)
    mp.setattr(generator, "GEN_IN_CHANNELS", (64, 32, 16))
    mp.setattr(generator, "GEN_OUT_CHANNELS", (32, 16, 8))
    yield {"shared.embed_y": [32, 64 * 16]}
    mp.undo()


def randomize(g: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded weights and statistics in place (running variances positive)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in g.state_dict().items():
            value = 0.2 * torch.randn(t.shape, generator=gen)
            if name.endswith("running_var"):
                value = value.abs() + 0.5
            t.copy_(value)
    return g


def inputs(g, cfg, length: int, device, seed: int = 1, batch: int = BATCH) -> tuple:
    """(labels, z, lengths, style_imgs) of one call; the style page is one
    page expanded to the batch, as a request sends it."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.io.n_classes, (batch, length), generator=gen).to(device)
    if g.z_source == "style":
        page = torch.rand(1, 1, 32, 16 * length, generator=gen).to(device) * 2 - 1
        return labels, None, None, page.expand(batch, -1, -1, -1)
    return labels, torch.randn(batch, cfg.shared.latent_dim, generator=gen).to(device), None, None


def counters() -> dict:
    got = profiling.snapshot()["counters"]
    return {name: got.get(name, 0) for name in COUNTERS}


# ---- CPU ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow_gs(narrow):
    out = {}
    for z_source, over in CONFIGS.items():
        cfg = load_config("configs/recommended.json", {**narrow, **over})
        out[z_source] = cfg, randomize(build_generator(cfg, torch.device("cpu")))
    return out


@pytest.mark.parametrize("z_source", list(CONFIGS))
@pytest.mark.parametrize("mode", ["train_no_grad", "eval_grad", "train_grad", "eval_no_grad"])
def test_cpu_or_training_or_grad_is_the_eager_forward(narrow_gs, z_source, mode):
    cfg, g = narrow_gs[z_source]
    args = inputs(g, cfg, 3, "cpu", batch=2)
    g.train(mode.startswith("train"))
    try:
        with torch.set_grad_enabled(not mode.endswith("no_grad")), profiling.tracing():
            want = g._forward(*args)
            got = g(*args)
    finally:
        g.eval()
    assert torch.equal(got, want)
    assert counters() == dict.fromkeys(COUNTERS, 0)
    assert not g.forward_graphs.graphs and not g.forward_graphs._seen


def _changed(g, args, field):
    """(the call's inputs, a context) that differ from `args` by `field`."""
    labels, z, lengths, style = args
    same = contextlib.nullcontext()
    if field == "shape":
        return (labels[:, :2], z, lengths, style[..., :32]), same
    if field == "batch":
        return (labels[:1], z, lengths, style[:1]), same
    if field == "dtype":
        return (labels.int(), z, lengths, style), same
    if field == "none":
        return (labels, z, torch.full((labels.shape[0],), 2), style), same
    if field == "inference_mode":
        return args, torch.inference_mode()
    if field == "dataflow":
        return args, _patched(g.attn_B3, "dataflow",
                              "fused" if g.attn_B3.dataflow != "fused" else "nhwc1")
    if field == "use_kernel":
        return args, _patched(g.attn_B3, "use_kernel", not g.attn_B3.use_kernel)
    if field == "tf32":
        return args, torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                                allow_tf32=not torch.backends.cudnn.allow_tf32)
    raise ValueError(field)


@contextlib.contextmanager
def _patched(obj, name, value):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(obj, name, value)
        yield


@pytest.mark.parametrize("field", ["shape", "batch", "dtype", "none", "inference_mode",
                                   "dataflow", "use_kernel", "tf32"])
def test_signature_changes_with_each_keyed_field(narrow_gs, field):
    cfg, g = narrow_gs["style"]
    blocks = [m for m in g.modules() if isinstance(m, forward_graphs.NonLocalBlock)]
    args = inputs(g, cfg, 3, "cpu", batch=2)
    with torch.no_grad():
        base = forward_graphs.signature(blocks, args)
        assert forward_graphs.signature(blocks, tuple(x if x is None else x.clone()
                                                      for x in args)) == base
        other, ctx = _changed(g, args, field)
        with ctx:
            changed = forward_graphs.signature(blocks, other)
        assert changed != base
        assert forward_graphs.signature(blocks, args) == base


@pytest.mark.parametrize("change", ["copy_", "to", "assign", "functional_call"])
def test_weights_check(narrow_gs, change):
    """In-place writes keep a graph live; replaced tensors do not."""
    cfg, base = narrow_gs["noise"]
    g = copy.deepcopy(base)
    graphs = g.forward_graphs
    graphs._weights = forward_graphs._weights(g)
    assert graphs._live()
    if change == "copy_":
        with torch.no_grad():
            for p in g.parameters():
                p.copy_(p * 0.5)
        assert graphs._live()
        return
    if change == "to":
        g.to(torch.float64)
        assert not graphs._live()
        return
    if change == "assign":
        g.load_state_dict({k: v.clone() for k, v in g.state_dict().items()}, assign=True)
        assert not graphs._live()
        return
    seen = []
    g.register_forward_pre_hook(lambda module, args: seen.append(graphs._live()))
    with torch.no_grad():
        functional_call(g, {k: v.clone() for k, v in g.named_parameters()},
                        inputs(g, cfg, 2, "cpu", batch=2))
    assert seen == [False] and graphs._live()


def test_state_dict_keys_are_the_flax_leaves(narrow_gs):
    for _, g in narrow_gs.values():
        keys = list(g.state_dict())
        assert sorted(keys) == sorted(key for _, key, _ in flax_leaves(g))
        assert not any("graph" in key for key in keys)


@pytest.mark.parametrize("how", ["deepcopy", "pickle"])
def test_copies_carry_no_graph_state(narrow_gs, how):
    cfg, g = narrow_gs["style"]
    g.forward_graphs._seen.add(("a", "signature"))
    g.forward_graphs._weights = forward_graphs._weights(g)
    try:
        twin = copy.deepcopy(g) if how == "deepcopy" else pickle.loads(pickle.dumps(g))
    finally:
        g.forward_graphs.clear()
    fresh = twin.forward_graphs
    assert isinstance(fresh, forward_graphs.ForwardGraphs) and fresh is not g.forward_graphs
    assert not fresh.graphs and not fresh._seen and fresh._weights is None
    args = inputs(g, cfg, 2, "cpu", batch=2)
    with torch.no_grad():
        assert torch.equal(twin(*args), g(*args))


# ---- the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def card_g(card, request):
    """(cfg, G) at full width on the card, seeded, graphs and counters fresh."""
    name = getattr(request, "param", "style")
    cfg = load_config("configs/recommended.json", CONFIGS[name.split("-")[0]])
    g = randomize(build_generator(cfg, "cpu")).to(card)
    if name.endswith("-fused"):
        g.attn_B3.dataflow = "fused"
    return cfg, g


@pytest.mark.card
@pytest.mark.parametrize("length", [1, 5, 10])
@pytest.mark.parametrize("card_g", ["style", "noise", "noise-fused"], indirect=True)
def test_replay_is_bitwise_eager(card_g, card, length):
    cfg, g = card_g
    first, second = inputs(g, cfg, length, card, 1), inputs(g, cfg, length, card, 2)
    with torch.inference_mode(), profiling.tracing():
        want = [g._forward(*first), g._forward(*second)]
        got = [g(*first), g(*first), g(*second), g(*first)]  # eager, capture, replays
    assert counters() == {"g.graph.eager": 1, "g.graph.capture": 1, "g.graph.replay": 2}
    for out, ref in zip(got, [want[0], want[0], want[1], want[0]]):
        assert out.dtype == ref.dtype and torch.equal(out, ref)


@pytest.mark.card
def test_replay_follows_in_place_weights(card_g, card):
    cfg, g = card_g
    args = inputs(g, cfg, 4, card)
    with torch.inference_mode():
        g(*args), g(*args)
        before = g(*args)
    with torch.no_grad():
        for p in g.parameters():
            p.mul_(0.9)
    with torch.inference_mode():
        with profiling.tracing():
            got = g(*args)
        want = g._forward(*args)
    assert counters()["g.graph.replay"] == 1
    assert torch.equal(got, want) and not torch.equal(got, before)


@pytest.mark.card
def test_functional_call_runs_eagerly(card_g, card):
    cfg, g = card_g
    args = inputs(g, cfg, 4, card)
    other = copy.deepcopy(g)
    randomize(other, seed=7)
    override = {**dict(other.named_parameters()), **dict(other.named_buffers())}
    with torch.inference_mode():
        g(*args), g(*args)
        with profiling.tracing():
            got = functional_call(g, override, args)
        want = other._forward(*args)
    assert counters() == {"g.graph.eager": 1, "g.graph.capture": 0, "g.graph.replay": 0}
    assert torch.equal(got, want)


@pytest.mark.card
def test_to_leaves_no_stale_replay(card_g, card):
    cfg, g = card_g
    args = inputs(g, cfg, 4, card)
    with torch.inference_mode():
        g(*args), g(*args)
    g.cpu()
    randomize(g, seed=3)
    g.to(card)
    with torch.inference_mode(), profiling.tracing():
        got = g(*args)
        want = g._forward(*args)
    assert counters() == {"g.graph.eager": 1, "g.graph.capture": 0, "g.graph.replay": 0}
    assert torch.equal(got, want) and not g.forward_graphs.graphs


@pytest.mark.card
def test_outer_capture_bypasses(card_g, card):
    cfg, g = card_g
    args = inputs(g, cfg, 3, card)
    with torch.no_grad():
        want = g._forward(*args)  # loads the kernels, warms the libraries
        outer = torch.cuda.CUDAGraph()
        with profiling.tracing():
            with torch.cuda.graph(outer):
                out = g(*args)
            outer.replay()
        torch.cuda.synchronize(card)
    assert counters() == dict.fromkeys(COUNTERS, 0) and not g.forward_graphs._seen
    assert torch.equal(out, want)


@pytest.mark.card
def test_output_is_not_overwritten(card_g, card):
    cfg, g = card_g
    first, second = inputs(g, cfg, 5, card, 1), inputs(g, cfg, 5, card, 2)
    with torch.inference_mode():
        g(*first), g(*first)
        a = g(*first)
        b = g(*second)
        want = g._forward(*first)
    assert torch.equal(a, want) and not torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("card_g", ["noise", "noise-fused"], indirect=True)
def test_kernel_launches_count_one_a_call(card_g, card):
    cfg, g = card_g
    args = inputs(g, cfg, 5, card)
    module = fused_block if g.attn_B3.dataflow == "fused" else attention
    before = module.launches
    with torch.inference_mode():
        for _ in range(6):
            g(*args)
    assert module.launches - before == 6


@pytest.mark.card
def test_counters_for_n_calls(card_g, card):
    cfg, g = card_g
    args = inputs(g, cfg, 6, card)
    n = 7
    with torch.inference_mode(), profiling.tracing():
        for _ in range(n):
            g(*args)
    assert counters() == {"g.graph.eager": 1, "g.graph.capture": 1, "g.graph.replay": n - 2}
    snap = profiling.snapshot()["spans"]
    assert snap["g.graph.capture"]["count"] == 1 and snap["g.forward"]["count"] == n
    graph, = g.forward_graphs.graphs.values()
    assert graph.capture_s > 0 and graph.pool_bytes >= 0

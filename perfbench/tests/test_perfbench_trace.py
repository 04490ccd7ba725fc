"""The traced slice's reduction, the sample of answers, and the harness's
refusals without a card."""

import pytest
import torch

from perfbench import common, run, trace


@pytest.mark.parametrize("name,cls", [
    ("(anonymous namespace)::attention_fwd_mma_kernel(__nv_bfloat16 const*)", "attention kernel"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "layout transform"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv and matmul"),
    ("void at::native::batch_norm_transform_input_kernel<c10::BFloat16>", "batch norm"),
    ("void LSTM_elementWise_bp1<float, float, float>(int)", "LSTM"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("Memset (Unknown)", "copy or set"),
])
def test_op_classes(name, cls):
    assert trace.op_class(name) == cls


def test_reduce_a_cpu_slice():
    spans = common.Spans()
    with trace.profiled("cpu") as prof:
        for _ in range(3):
            with spans("unit"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    s = trace.reduce(prof, 3)
    assert s.units == 3 and s.window_s > 0 and s.busy_s == 0 and s.kernels == 0
    assert sum(sec for _, sec in s.idle_gaps) == pytest.approx(s.window_s)
    assert set(s.breakdown()) == {"device_ops", "idle_gaps"} and spans.counts == {"unit": 3}


def test_sample_is_seeded_and_uniform_in_size():
    def draw(seed):
        sample = common.Sample(4, seed)
        for i in range(100):
            sample.offer(i)
        return sample.items()
    assert draw(3) == draw(3) != draw(2 ** 31 + 3)
    assert len(draw(3)) == 4 and draw(3) == sorted(draw(3))


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "serve.g.len10.b1024", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_jax_modules_are_found_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "scrabblegan_tpu_like", types.ModuleType("x"))
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert common.forbidden_modules() == ["flax"]


@pytest.mark.card
def test_a_short_run_on_the_card(card, capsys):
    assert run.main(["--workload", "serve.g.len10.b1024", "--seed", "5", "--seconds", "2",
                     "--trace", "0"]) == 0
    assert '"correct": true' in capsys.readouterr().out.splitlines()[-1]

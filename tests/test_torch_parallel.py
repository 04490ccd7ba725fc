"""The port's parallel modes against one process, over gloo on the CPU.

scrabblegan_torch/parallel/ runs JAX's DP, FSDP, TP and FSDP x TP as one
process a rank. Here, at the JAX selftest's sizes (the library defaults at
full width, length 2, batch 2 a data rank), one state is drawn and written
once; the one-process reference takes its steps in this process, and each
parallel mode runs in ranks spawned once a world size (2 and 4), every
mode of a spawn from the same checkpoints:
- DP on 2 ranks, TP on (1, 2) (all 4 samples on its one data rank) and
  FSDP x TP on (2, 2) each take 2 steps, each from the state the reference
  took it from (the initial state, then the reference's state after step
  1), and FSDP on 2 ranks steps 2 and 3 (from the reference's state, then
  from its own checkpoint against one process resumed from it): the 16 metrics
  of each step within the selftest's bounds (rtol 2e-3, atol 2e-4), and
  every network's parameters, BN statistics and SN u and sigma within 5e-3
  of the reference's after it, and its Adam moments within 5e-3 relative
  to its largest (printed: Adam's update is blind to a constant factor on
  the gradient, the moments are not, so a rank that counts the loss's
  gradient twice shows there);
- FSDP: each rank holds the pieces the rule gives, the filter bank split
  on its 8192 axis;
- a checkpoint written by FSDP on 2 ranks resumes in one process and the
  next step equals FSDP's own; one written in one process resumes on 2 FSDP
  ranks (FSDP's step 2 above);
- `shared.my_rec` on 2 ranks: every dropout mask of a step is the rank's
  rows of the mask one process draws for the whole batch;
- the parallel options build a step (no NotImplementedError).
Why each step starts from the reference's state: the reference's own
trajectory parts from itself under reordered float32 sums. Lean Adam's
first updates are g / |g|, so a gradient element at float32's rounding
level (the biases before a batch norm, ~1e-8 beside 1e-1) moves by +-lr
either way; the JAX package's selftest on 2 devices parts the same way at
its steps 2 and 3 (rel-diff 1.28 and 0.42, G's parameters within 2.1e-3).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from scrabblegan_torch.parallel import selftest as st
from scrabblegan_torch.train.step import METRIC_NAMES

BATCH = 4  # 2 a data rank on 2 data ranks; TP's mesh (1, 2) takes all 4 on its one
FSDP = {"parallel.fsdp": True}
TP = {"parallel.model_parallel": 2}
BF16 = {"shared.trunk_dtype": "bfloat16"}  # configs/recommended.json's trunks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("parallel")
    d = {name: str(wd / name) for name in ("init", "r1", "r2", "f2", "masks")}
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        st.write_init(st.job_config(BATCH), d["init"], device="cpu")
        one = {"batch": BATCH, "steps": 1, "one_process": True, "device": "cpu"}
        ref = {"a1": st.run_job({**one, "init": d["init"], "save": d["r1"]}),
               "a2": st.run_job({**one, "init": d["r1"], "seed": 1, "save": d["r2"]})}
        step1 = {"batch": BATCH, "init": d["init"], "steps": 1, "compare": d["r1"]}
        step2 = {"batch": BATCH, "init": d["r1"], "steps": 1, "seed": 1, "compare": d["r2"]}
        two = st.spawn(2, [
            step1, step2,
            # FSDP from the one-process checkpoint r1; it writes f2 and steps on
            {**step2, "overrides": FSDP, "check_pieces": True, "save": d["f2"],
             "then_steps": 1},
            {**step1, "overrides": TP}, {**step2, "overrides": TP},
            {"batch": BATCH, "steps": 1, "zero_init": True, "record_masks": d["masks"],
             "overrides": {"shared.my_rec": True}},
            {"batch": BATCH, "init": d["init"], "steps": 1, "shadow": True,
             "witness": [2, 1], "overrides": BF16},
        ], str(wd), device="cpu")
        four = st.spawn(4, [{**step1, "overrides": {**FSDP, **TP}},
                            {**step2, "overrides": {**FSDP, **TP}}], str(wd), device="cpu")
        resumed = st.run_job({**one, "init": d["f2"], "seed": 2})
        masks = [torch.load(f"{d['masks']}.{r}") for r in range(2)]
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(wd, ignore_errors=True)  # ~3.3 GB of checkpoints
    names = ("dp1", "dp2", "fsdp2", "tp1", "tp2", "masks_run", "dp_bf16")
    return {"ref": ref, **dict(zip(names, two)), "ft1": four[0], "ft2": four[1],
            "resumed": resumed, "masks": masks}


def check_step(got: dict, ref: dict, what: str) -> None:
    ok, worst = st.metric_errors(got["metrics"], ref["metrics"])
    bad = {k: (a, b) for k, a, b in zip(METRIC_NAMES, ref["metrics"][0], got["metrics"][0])
           if not np.isclose(b, a, rtol=st.METRIC_RTOL, atol=st.METRIC_ATOL)}
    print(f"{what}: mesh {got['mesh']}, metric max rel-diff {worst:.2e}; state diffs "
          + ", ".join(f"{k} {v:.1e}" for k, v in sorted(got["diffs"].items())))
    assert ok, bad
    assert set(got["diffs"]) >= {"g_params", "d_params", "r_params", "w_params", "g_stats",
                                 "r_stats", "g_u", "d_u", "w_u", "g_nu", "d_nu", "r_nu", "w_nu"}
    assert max(got["diffs"].values()) <= st.PARAM_TOL, got["diffs"]


@pytest.mark.parametrize("mode", ["dp", "tp", "ft"])
def test_mode_matches_one_process_over_two_steps(runs, mode):
    for step in (1, 2):
        check_step(runs[f"{mode}{step}"], runs["ref"][f"a{step}"], f"{mode} step {step}")


def test_fsdp_matches_one_process_over_two_steps(runs):
    """FSDP's steps 2 and 3: from the one-process state r1 against the
    reference's step 2, then from its own checkpoint f2 against one process
    resumed from f2 (test_fsdp_checkpoint_resumes_in_one_process)."""
    check_step(runs["fsdp2"], runs["ref"]["a2"], "fsdp step 2")


def test_dp_in_bf16_within_the_rounding_witness(runs):
    """bf16 trunks: DP's step against one process's from the same state,
    the metrics, parameters and statistics within the selftest's bounds and
    Adam's moments within twice the difference of the rounding witness (one
    process, its layers on the two ranks' batch halves, `split_parts`)."""
    got = runs["dp_bf16"]
    ok, worst = st.shadow_errors(got)
    _, witness = st.metric_errors(got["witness_metrics"], got["shadow_metrics"])
    print(f"dp bf16: {worst}; the witness's metric max rel-diff {witness:.2e}, state "
          + ", ".join(f"{k} {v:.1e}" for k, v in sorted(got["witness_diffs"][0].items())))
    assert ok, (worst, got["step_diffs"])
    assert max(got["witness_diffs"][0].values()) > 0  # the witness splits the layers


def test_meshes(runs):
    assert runs["dp1"]["mesh"] == {"data": 2} == runs["fsdp2"]["mesh"]
    assert runs["tp1"]["mesh"] == {"data": 1, "model": 2}
    assert runs["ft1"]["mesh"] == {"data": 2, "model": 2}


def test_fsdp_ranks_hold_the_rule_pieces(runs):
    report = runs["fsdp2"]
    assert report["pieces_equal_rule"]
    pieces = report["pieces"]
    assert pieces["g/filter_bank.bank"] == {"shape": [52, 32, 4096], "places": [[2, "data"]]}
    split = [k for k, v in pieces.items() if v["places"]]
    assert len(split) > 20 and all(v["places"] == [] or v["places"][0][1] == "data"
                                   for v in pieces.values())
    # DP cuts nothing; FSDP x TP cuts on both axes
    assert not any(v["places"] for v in runs["dp1"]["pieces"].values())
    axes = {a for v in runs["ft1"]["pieces"].values() for _, a in v["places"]}
    assert axes == {"data", "model"}


def test_fsdp_checkpoint_resumes_in_one_process(runs):
    """FSDP on 2 ranks wrote f2 after step 2 and took step 3 from it; one
    process restores f2 and takes step 3: the same metrics."""
    ok, worst = st.metric_errors(runs["resumed"]["metrics"], runs["fsdp2"]["then_metrics"])
    print(f"one process from the FSDP checkpoint vs FSDP: metric max rel-diff {worst:.2e}")
    assert ok


def test_one_process_checkpoint_resumes_on_fsdp_ranks(runs):
    """r1 is the one-process state after step 1; FSDP on 2 ranks restores it
    and its step 2 is the reference's."""
    ok, worst = st.metric_errors(runs["fsdp2"]["metrics"], runs["ref"]["a2"]["metrics"])
    print(f"FSDP from the one-process checkpoint: metric max rel-diff {worst:.2e}")
    assert ok


def test_bilstm_dropout_masks_are_row_slices(runs):
    """Every mask a rank's step drew (both R passes) is its rows of the mask
    one process draws for the whole batch with the same key and call."""
    from scrabblegan_torch.ops.dropout import keep_mask

    parts = runs["masks"]
    assert len(parts[0]) == len(parts[1]) >= 20
    for r, drawn in enumerate(parts):
        for key, call, shape, keep_prob, shard, mask in drawn:
            assert shard == r
            b = shape[0]
            whole = keep_mask(torch.tensor(key), call, (2 * b, *shape[1:]), keep_prob)
            assert torch.equal(mask, whole[r * b:(r + 1) * b]), (r, call)
    assert parts[0][0][:4] == parts[1][0][:4]  # one key, call, shape and rate
    assert not torch.equal(parts[0][0][5], parts[1][0][5])


@pytest.mark.parametrize("overrides", [FSDP, TP, {**FSDP, **TP}])
def test_parallel_options_build_a_step(overrides):
    from scrabblegan_torch.models.build import build_models
    from scrabblegan_torch.train.step import make_step_body

    cfg = st.job_config(2, overrides)
    assert callable(make_step_body(cfg, build_models(cfg, "meta")))

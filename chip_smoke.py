#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (written for an H100).

Drives the port's paths at the full widths of the repo's networks, with
random weights made from a seed, through the hand-written attention CUDA
kernels: the serving path, the generator from (labels, z) to word images
(vocab 52, filter bank (32, 8192), channels 512/256/128/64, bf16, noise z),
the four-network train step (G, D, R, W at batch 16), eager and as CUDA
graphs, the epoch Trainer on a synthetic data set with evaluation and
style-z serving after it, and the real-data campaign config on a raw IAM
tree it converts.
Phases, one line each or more:

1. device: a CUDA card is required; its name and power limit (nvidia-smi);
2. build: nvcc builds scrabblegan_torch/csrc for sm_90a; build seconds;
3. kernel vs plain core at G's B3 shapes (Q = 512L, K = 128L for L = 1, 5, 10),
   at D's and W's B1 shapes (Q = 128L, K = 32L), at a ragged Q = 300,
   K = 75, and at two shapes that stress the staging of the keys (K = 75
   under Q = 640: not a multiple of 8, copied element by element; K = one
   key tile + 8: a second tile of one 16-byte copy a row), float32 within
   1e-4 and bfloat16 within 2e-2 (absolute plus relative), the tolerances of
   the JAX kernel's tests;
4. the generator at batch 1024, len 5 and len 10, through the kernel: one
   launch per forward; finite images in [-1, 1]; agreement with the same
   generator on the plain core at batch 16 (bf16, 2e-2) and with the CPU
   port at batch 2 (float32, 1e-3); padded mode's white-out;
5. serve: scrabblegan_torch.infer.main on an .npz of those weights;
6. times (CUDA events after a warm-up): kernel and plain core at B3 (bf16 at
   batch 1024, float32 at batch 16), the generator's images/s, and a
   profiler trace of 3 forwards at len 5 and 10 (device busy share, ms a
   forward by kernel class), each printed with the card's name and power
   limit;
7. the backward kernels vs the plain backward at every shape the step runs
   (G's B3 and D/W's B1 at L = 1, 5, 10, the style images' (1280, 320), a
   ragged (300, 75)), batch 4, and at shapes that stress the staging and the
   edges (K not a multiple of 8, K one past a key tile, Q not a multiple of
   a warp's 16 rows, batch 1, a batch large enough to need no split), float32
   within 2e-4 (TF32 off) and bfloat16 within 2e-2; two backward runs bitwise
   equal at every shape; at the B1 shapes and the ragged one, in float32 and
   bfloat16, the autograd Function (both kernels): its output vs the plain
   core, its grads vs autograd through the plain core;
8. the train step at batch 16 for configs/recommended.json (padded) and for
   the JAX bench's bucketed len-5 config, from seeded flax-layout weights
   (attention sigma != 0): 10 steps each through the kernels, finite
   metrics, 7 forward and 7 backward launches a step; step 1 (metrics,
   gradients, updated parameters) against the same step on the plain cores,
   both under cuDNN's deterministic algorithms, so that two runs agree;
   one float32 step at batch 2, len 2 on the card against the CPU port;
9. the train CLI (6 steps as CUDA graphs: two eager warm-up steps, the
   capture, replays; its steps/s over the last 3; export G) and the
   inference CLI serving the export with noise z;
10. times: the backward kernels (D/W B1 in bfloat16 and G B3 in float32 at
   batch 16 and 256, G B3 in bfloat16 at batch 256 and 1024; len 5 and 10)
   by CUDA events around eager calls and, from a profiler trace, on the
   device alone per kernel, with the plan's grids, beside the plain
   backward, the library's backward, the bound and the floor of as many
   empty launches; the eager train steps/s on the kernels and on the plain
   cores (four turns of 20 steps, 50 before phase 18 took their time;
   window means and the median of per-step times),
   and a profiler trace of 5 steps (device busy share, kernel launches a
   step, top kernel classes, the attention kernels' share, backward calls
   whose cotangent had to be copied), each printed with the card's name and
   power limit.

The 'fused' attention dataflow (the whole non-local block as one kernel,
csrc/fused_block_fwd.cu) adds four phases, each run after the phase of the
same path above (order 1-3, 11, 4-6, 12, 7, 8, 13, 9, 14, 10, then 18, 15-17, 19):

11. the fused kernel vs its plain version (the composition on the plain
   core) at G's B3 and D's and W's B1 shapes for L = 1, 5, 10, a ragged
   N = 300, K = 75 and phase 3's two staging shapes, batch 4, float32 within
   5e-4 and bfloat16 within 1e-1
   (the JAX fused-kernel test's tolerances); the autograd Function's grads
   vs autograd through the plain composition in the same dtype, within 2e-4
   (float32) and 2e-2 (bfloat16) of each gradient's largest entry;
12. G at batch 1024, bf16, len 5 and 10 under 'fused': one fused launch and
   no core launch a forward, finite images, agreement with the 'nhwc1'
   images of phase 4 (G_TOL_PLAIN); then images/s of both dataflows in
   turns nhwc1, fused, fused, nhwc1, and the fused kernel's and the plain
   version's ms;
13. the train step under 'fused' for both configurations of phase 8, 10
   steps each: 7 fused launches a step, and in the backward 7 core forwards
   (the recompute) and 7 core backwards; finite metrics; step 1 against the
   'nhwc1' step at phase 8's tolerances (the two balanced metrics at the
   card-vs-CPU check's);
14. the train CLI with --workdir under 'fused' (3 steps, then 2 more that
   resume at step 3; checkpoints and the EMA export with standing stats) and
   the inference CLI serving the export with --model-dir.

The captured step adds phase 18, run after phase 10:

18. the train step as CUDA graphs (`make_chunked_train_step`, train/graphs.py)
   at batch 16, full width, for both configurations of phase 8 under
   'nhwc1': the graph's two eager warm-up steps, then K = 1 and K = 4 steps
   a call (the capture and K replays), against as many eager steps from the
   same start, under cuDNN's deterministic algorithms, at phase 8's
   tolerances, and whether they are bitwise equal; the launches of each
   call and of K = 4 more replays (7 forward and 7 backward a step,
   exactly: the counts derive from the steps alone); each graph's capture
   seconds and pool bytes, the replay's and the eager step's peak memory;
   ms a step (CUDA events around 50 calls of K = 1 and 12 of K = 4:
   median, p10-p90) beside phase 10's eager median, a profiler trace of 5
   replays (device busy share, kernel nodes a step, and the attention
   kernels' nodes a replay, which must equal the launches the capture
   counted), and the CTC as a graph of its own at the step's shapes (ms and
   kernel nodes a call, its share of the step; first its gradient, bitwise
   the same over 11 eager calls); then bucketed mode with
   'independent' pairing, three (real, fake) length pairs warmed up,
   captured in one shared pool and replayed out of order against the eager
   steps; one K = 1 capture under 'fused' against
   the eager 'fused' step (7 fused, 7 core forward and 7 core backward
   launches a replay); one `shared.remat` capture against the plain eager
   step (8 forward launches a step: the backward recomputes G's B3), and
   the eager peak memory with and without remat.

The slice of the data path, the epoch Trainer and evaluation adds three
phases, run last (after phase 18):

15. data: `make_synthetic_dataset(style='script', samples_per_bucket=64)`
   writes 640 words in 10 buckets and 12 style images; the port's PNG
   reader reads every file back; `BucketedDataset` and `load_style_images`
   load them; the times of each;
16. the Trainer on the card through the train CLI's Trainer mode
   (`--synthetic --epochs 2 --batches-per-epoch 20`, configs/recommended.json:
   padded, EMA 0.999, 100 standing-statistics batches, the gate at 64
   samples, batch 16), then 1 more epoch that resumes at step 40, on the
   captured step (one graph a run, padded mode; its first two steps eager):
   the attention launches against the count derived from the config (7
   forward and 7 backward a step; a forward for each standing-statistics
   batch, the grid and each gate chunk), finite
   metrics, the JAX Trainer's artifact set
   (16-column summaries, grids read back, the GIF, checkpoints 20/40/60, G
   and R exports 1-3, quality_<epoch>.json and latest_good), the warm
   epoch's steps/s beside phase 10's eager and phase 18's captured step
   medians, the host
   fetches a step in the batch loop (`.cpu()`, `.item()`, `.tolist()`,
   `float()` on a tensor counted), the wall time of each epoch's artifacts;
17. `python -m scrabblegan_torch.evaluate --bucket all` on that workdir
   (finite rFID and CER for each of the 10 buckets), `infer --export auto`
   with the style z source from a phase-15 style image and from a blank
   page (the PNG read back), and G with style z at batch 1024, len 5, bf16
   under 'nhwc1' and 'fused' (one launch of the core or of the fused
   kernel, agreement within G_TOL_PLAIN);
19. configs/iam_campaign.json (padded, EMA 0.999, 'independent' pairing,
   io.stall_timeout_s 900: the stall watchdog on) through the train CLI on a
   raw IAM tree fabricated from a seed (300 words of random sizes written
   with the port's PNG writer, a words.txt with 'err' lines and
   non-alphabetic words), which the first run converts; the Trainer at full
   width, cut in depth to 1 epoch of 8 batches: exit 0, the launches
   derived from the config, the watchdog's beats and one grace at the
   start, one a captured shape and one before the first artifacts, its
   heartbeat file touched.

The dataflow is set through $SCRABBLEGAN_ATTN_DATAFLOW, which the blocks
read at each call; it is 'nhwc1' outside the 'fused' phases. Each launch
count is set to 0 just before a path runs and read just after it.

Then one JSON line {"kernels": [...]}: per kernel its launches on the
main path (`launches`: phase 18's K = 4 replays; for the fused kernel its
'fused' replay) and on the other paths,
its largest error against the plain version, its ms, the plain version's ms,
the least time the card could take for the same work (bound_ms: the largest
of the bytes the call must move over 3.35 TB/s, its operations over 989
TFLOP/s in bf16 or 67 TFLOP/s in float32, the H100 SXM's published peaks,
and its exponentials, one a (query, key) pair, over the special-function
units' 16 a clock on each SM at the card's largest SM clock, which phase 1
prints; bound_by names the term) and, where one PyTorch call computes the
same function, that call's ms
(F.scaled_dot_product_attention with scale 1, timed as a yardstick only).
Then the nvidia-smi line, and last {"ok": true, "device": {...}}. Any
failure raises and the exit code is non-zero; without a card the script
exits non-zero before any result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"
LOG = ROOT / "chiprun_out" / "chip_smoke.log"
BATCH = 1024
LENGTHS = (5, 10)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
G_TOL_PLAIN = 2e-2  # bf16 images, kernel vs plain core, through the layers after B3
G_TOL_CPU = 1e-3    # f32 images, card vs CPU; cuDNN may pick Winograd or FFT convs


def say(phase: str, **fields) -> None:
    """One result line, on stdout and appended to chiprun_out/chip_smoke.log,
    which keeps every phase where only the end of stdout is kept."""
    line = f"[{phase}] " + json.dumps(fields)
    print(line, flush=True)
    LOG.parent.mkdir(exist_ok=True)
    with LOG.open("a") as f:
        f.write(line + "\n")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def staging_shapes() -> list[tuple[int, int]]:
    """(Q, K) that stress the staging of the keys: K not a multiple of 8 under
    a Q of whole blocks, and K just past a key tile."""
    from scrabblegan_torch.kernels.attention import KEY_TILE
    return [(640, 75), (640, KEY_TILE + 8)]


def check_close(what: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """|got - ref| <= tol + tol * |ref| everywhere, as numpy's allclose with
    rtol = atol = tol (the JAX kernel tests' criterion); returns the largest
    absolute error."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    if not bool((diff <= tol + tol * ref.abs()).all()):
        raise AssertionError(f"{what}: max abs error {diff.max().item()} beyond tol {tol}")
    return diff.max().item()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def b3_operands(batch: int, q: int, k: int, dtype, gen: torch.Generator):
    dev = "cuda"
    return (torch.randn(batch, 8, q, generator=gen, device=dev).to(dtype),
            torch.randn(batch, 8, k, generator=gen, device=dev).to(dtype),
            torch.randn(batch, 32, k, generator=gen, device=dev).to(dtype))


def check_kernel(attention, gen) -> float:
    """Phase 3: kernel vs plain at G's B3 shapes, D's and W's B1 shapes (the
    train step's, Q = 128L, K = 32L) and a ragged one; returns the largest
    error."""
    worst = 0.0
    cases = [(512 * n, 128 * n) for n in (1, 5, 10)]
    cases += [(128 * n, 32 * n) for n in (1, 5, 10)] + [(300, 75)] + staging_shapes()
    for dtype in (torch.float32, torch.bfloat16):
        for q, k in cases:
            ops = b3_operands(4, q, k, dtype, gen)
            got = attention.nonlocal_attention_packed(*ops)
            ref = attention.attention_reference(*ops)
            torch.cuda.synchronize()
            err = check_close(f"kernel vs plain at q={q} k={k} {dtype}", got, ref, TOL[dtype])
            say("3 kernel-vs-plain", dtype=str(dtype), q=q, k=k, batch=4, max_abs_err=err,
                tol=TOL[dtype])
            worst = max(worst, err)
    thetaT, phiT, gT = b3_operands(1, 128, 32, torch.float32, gen)
    try:
        attention.nonlocal_attention_packed(thetaT.repeat(1, 2, 1), phiT.repeat(1, 2, 1), gT)
    except ValueError:
        pass
    else:
        raise AssertionError("the kernel wrapper accepted Ca=16")
    return worst


def make_inputs(batch: int, length: int, gen: torch.Generator):
    labels = torch.randint(0, 52, (batch, length), generator=gen, device="cuda")
    z = torch.randn(batch, 128, generator=gen, device="cuda")
    return labels, z


def check_images(images: torch.Tensor, batch: int, length: int) -> None:
    if images.shape != (batch, 1, 32, 16 * length):
        raise AssertionError(f"image shape {tuple(images.shape)}")
    x = images.float()
    if not bool(torch.isfinite(x).all()) or x.abs().max().item() > 1.0:
        raise AssertionError("images not finite or outside [-1, 1]")


# ---- phases 7-10: the train step and the backward kernel ----------------------

BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py:71-72; bf16 ulp
TRAIN_BATCH = 16
TRAIN_STEPS = 10
TIME_STEPS = 20  # steps a timed turn (phase 10; 50 until the captured step's phase 18)
FWD_PER_STEP = BWD_PER_STEP = 7  # D B1 x3, W B1 x3, G B3 x1 ('adversarial', dead pass skipped)
# kernel vs plain cores, step 1 (bf16 D/W trunks, where the two cores round
# the attention output to bf16 at other places): metrics within tol x
# (1 + |value|), and each gradient leaf in the norm relative to max(its norm,
# 1e-2 x the network's largest); about 3x the largest errors measured on an
# H100 (3.3e-4; G 9.2e-3, D 2.6e-2, R 1.1e-6, W 2.2e-2)
STEP_TOL_METRICS = 2e-3
STEP_TOL_GRAD = {"g": 3e-2, "d": 8e-2, "r": 1e-4, "w": 8e-2}
# card vs CPU, float32 step at batch 2, len 2 (TF32 off); measured on two
# calls 1.9e-4 on metrics of up to ~25, G 6.7e-5 and 8.4e-3 (cuDNN picks its
# algorithms per call; G's gradient is ill-conditioned, tests/
# test_torch_step_parity.py), D 5.3e-6, R 3.8e-6, W 7.5e-6. The two balanced
# metrics scale by std(g_loss) over a batch of 2, a difference of two nearly
# equal numbers: 1e-6 on g_loss is 1% there.
CPU_TOL_METRICS = 1e-4
CPU_TOL_BALANCED = 5e-2
CPU_TOL_GRAD = {"g": 3e-2, "d": 1e-4, "r": 1e-4, "w": 1e-4}
NETWORK_NAMES = {"g": "generator", "d": "discriminator", "r": "recognizer",
                 "w": "style_promoter"}


def bwd_shapes() -> list[tuple[str, int, int]]:
    shapes = [(f"G B3 len {n}", 512 * n, 128 * n) for n in (1, 5, 10)]
    shapes += [(f"D/W B1 len {n}", 128 * n, 32 * n) for n in (1, 5, 10)]
    return shapes + [("style images", 1280, 320), ("ragged", 300, 75)]


def bwd_edge_shapes() -> list[tuple[str, int, int, int]]:
    """(what, batch, Q, K) that stress the backward's staging, edges and plan."""
    from scrabblegan_torch.kernels.attention import KEY_TILE
    return [("K not a multiple of 8", 4, 640, 75), ("K a tile and 8", 4, 640, KEY_TILE + 8),
            ("K one past a tile", 4, 72, KEY_TILE + 1), ("Q not a multiple of 16", 4, 72, 40),
            ("Q not a multiple of 8", 4, 300, 160), ("batch 1", 1, 640, 160),
            ("no split", 1024, 256, 96)]


def bwd_operands(batch: int, q: int, k: int, dtype, gen: torch.Generator):
    return [torch.randn(batch, c, n, generator=gen, device="cuda").to(dtype)
            for c, n in ((8, q), (8, k), (32, k), (32, q))]


def check_backward_kernel(attention, gen) -> float:
    """Phase 7; returns the largest error against the plain backward."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for what, batch, q, k in [(w, 4, q, k) for w, q, k in bwd_shapes()] + bwd_edge_shapes():
            ops = bwd_operands(batch, q, k, dtype, gen)
            got = attention._launch_backward(*ops)
            again = attention._launch_backward(*ops)
            ref = attention.attention_backward_reference(*ops)
            torch.cuda.synchronize()
            errs = [check_close(f"backward {name} at {what} {dtype}", g, r, BWD_TOL[dtype])
                    for name, g, r in zip(("dtheta", "dphi", "dg"), got, ref)]
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"backward at {what} {dtype}: two runs differ")
            say("7 backward-vs-plain", what=what, dtype=str(dtype), q=q, k=k, batch=batch,
                max_abs_err=errs, tol=BWD_TOL[dtype], deterministic=True,
                plan=attention.backward_plan(batch, q, k, sm_count()))
            worst = max(worst, *errs)
    # the autograd Function (forward and backward kernels) at D's and W's B1
    # shapes: its output against the plain core in the same dtype, its grads
    # against autograd through the plain core in float32 on the same
    # (rounded) operands, which the kernels' float32 math matches up to the
    # rounding of the stored grads
    b1 = [(what, q, k) for what, q, k in bwd_shapes() if what.startswith("D/W")]
    for dtype in (torch.float32, torch.bfloat16):
        for what, q, k in b1 + [("ragged", 300, 75)]:
            th, ph, g, d = bwd_operands(2, q, k, dtype, gen)
            xs = [t.clone().requires_grad_() for t in (th, ph, g)]
            out = attention.nonlocal_attention_packed(*xs)
            out.backward(d)
            fwd_err = check_close(f"autograd Function forward at {what} {dtype}", out,
                                  attention.attention_reference(th, ph, g), TOL[dtype])
            ys = [t.clone().float().requires_grad_() for t in (th, ph, g)]
            attention.attention_reference(*ys).backward(d.float())
            errs = [check_close(f"autograd Function grads at {what} {dtype}", x.grad, y.grad,
                                BWD_TOL[dtype]) for x, y in zip(xs, ys)]
            say("7 autograd-function-vs-plain", what=what, dtype=str(dtype), q=q, k=k,
                fwd_max_abs_err=fwd_err, fwd_tol=TOL[dtype], grad_max_abs_err=errs,
                grad_tol=BWD_TOL[dtype])
            worst = max(worst, *errs)
    return worst


def train_configs(load_config) -> dict:
    """The two configurations of the slice, at batch 16."""
    return {"recommended (padded)": load_config(str(ROOT / "configs" / "recommended.json")),
            "bench bucketed len 5": load_config(None, {
                "shared.batch_size": TRAIN_BATCH, "io.seq_len": 5, "shared.num_gen": 4,
                "shared.trunk_dtype": "bfloat16"})}


def with_core(cfg, use_kernel: bool):
    return dataclasses.replace(cfg, shared=dataclasses.replace(
        cfg.shared, use_pallas_attention=use_kernel))


def fake_trees(cfg, seed: int = 0) -> dict:
    from scrabblegan_torch.convert import fake_flax_variables
    return {n: fake_flax_variables(cfg, seed, name) for n, name in NETWORK_NAMES.items()}


def state_of(cfg, trees: dict, device):
    from scrabblegan_torch.convert import state_from_flax
    return state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                           {n: t.get("batch_stats", {}) for n, t in trees.items()}, device)


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms only, for two steps that are compared
    with each other: under its default choice two runs of one step differ (the
    same code and data gave 5.5e-4 and 1.7e-3 on the balanced metrics, which
    scale by a std of ~3e-4 over the batch), and the comparison should see
    the two attention cores, not two convolution algorithms."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def gradient_check(state, ref_state, tols: dict, beta_2: float) -> tuple[dict, dict]:
    """Two states after their first step from one start, held by the rule of
    scrabblegan_torch.train.compare. Per network: the largest leaf error of
    |g| (read from lean Adam's nu) relative to its scale, and the count of
    elements, among those whose sign the rule checks at `tols`, whose updated
    parameter differs from the reference's by more than 1e-6 (Adam's first
    update is +-lr there, so a mismatch is a flipped gradient sign)."""
    from scrabblegan_torch.train import compare

    errs, flips = {}, {}
    for net in "gdrw":
        got, want = (compare.abs_grads([v.float().cpu().numpy() for v in s.opt_states[net].nu],
                                       beta_2) for s in (state, ref_state))
        leaf_errs, scales = compare.gradient_errors(got, want)
        errs[net] = max(leaf_errs)
        flips[net] = 0
        for p, q, g, scale in zip(state.params(net), ref_state.params(net), want, scales):
            moved = (p.detach().float().cpu() - q.detach().float().cpu()).abs().numpy() > 1e-6
            flips[net] += int(moved[compare.sign_mask(g, tols[net] * scale)].sum())
    return errs, flips


def check_train_step(attention, load_config, synthetic_batch, make_train_step,
                     METRIC_NAMES) -> dict:
    """Phase 8; returns {config: (kernel state, plain state, batches, cfg)}
    for the timings, and the launches of the kernel-path runs."""
    rng = np.random.default_rng(0)
    runs, launches = {}, {"fwd": 0, "bwd": 0}
    for name, cfg in train_configs(load_config).items():
        trees = fake_trees(cfg)
        length = cfg.io.seq_len or 5
        batches = [synthetic_batch(cfg, TRAIN_BATCH, length, rng) for _ in range(TRAIN_STEPS)]
        kcfg, pcfg = with_core(cfg, True), with_core(cfg, False)
        kstate, pstate = state_of(kcfg, trees, "cuda"), state_of(pcfg, trees, "cuda")
        kstep, pstep = make_train_step(kcfg, kstate.models), make_train_step(pcfg, pstate.models)
        torch.cuda.synchronize()
        attention.launches = attention.bwd_launches = 0
        metrics = [kstep(kstate, b) for b in batches]
        torch.cuda.synchronize()
        fwd, bwd = attention.launches, attention.bwd_launches
        if (fwd, bwd) != (FWD_PER_STEP * TRAIN_STEPS, BWD_PER_STEP * TRAIN_STEPS):
            raise AssertionError(f"{name}: {fwd} forward and {bwd} backward launches in "
                                 f"{TRAIN_STEPS} steps")
        launches["fwd"] += fwd
        launches["bwd"] += bwd
        values = np.array([[float(m[k]) for k in METRIC_NAMES] for m in metrics])
        if not np.isfinite(values).all():
            raise AssertionError(f"{name}: non-finite metrics")
        say("8 train step", config=name, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
            fwd_launches_per_step=fwd / TRAIN_STEPS, bwd_launches_per_step=bwd / TRAIN_STEPS,
            first=dict(zip(METRIC_NAMES, values[0].tolist())),
            last=dict(zip(METRIC_NAMES, values[-1].tolist())))
        # step 1 on the plain cores, from the same start, on the same batch
        with deterministic_convs():
            plain = pstep(pstate, batches[0])
            torch.cuda.synchronize()
            if (attention.launches, attention.bwd_launches) != (fwd, bwd):
                raise AssertionError("the plain-core step launched a kernel")
            ref = state_of(kcfg, trees, "cuda")
            kernel1 = make_train_step(kcfg, ref.models)(ref, batches[0])
        errs = {k: abs(float(kernel1[k]) - float(plain[k])) for k in METRIC_NAMES}
        bad = [k for k in METRIC_NAMES if errs[k] > STEP_TOL_METRICS * (1 + abs(float(plain[k])))]
        grads, flips = gradient_check(ref, pstate, STEP_TOL_GRAD, cfg.optimizer.beta_2)
        if bad or any(grads[n] > STEP_TOL_GRAD[n] for n in grads) or any(flips.values()):
            raise AssertionError(f"{name}: kernel vs plain step 1: metrics {bad}, grads {grads}, "
                                 f"updated parameters {flips}")
        say("8 train step kernel-vs-plain", config=name, step=1, metric_errs=errs,
            max_metric_err=max(errs.values()), tol_metrics=STEP_TOL_METRICS,
            grad_norm_err=grads, tol_grads=STEP_TOL_GRAD, updated_param_mismatches=flips)
        attention.launches, attention.bwd_launches = fwd, bwd
        del ref
        runs[name] = (kstate, pstate, batches, kcfg, pcfg)
    return runs, launches


def check_train_step_card_vs_cpu(load_config, synthetic_batch, make_train_step,
                                 METRIC_NAMES) -> None:
    """Phase 8: one float32 step at batch 2, len 2 on the card (kernels, TF32
    off) and on the CPU (plain cores), from the same weights and batch."""
    cfg = load_config(None, {"shared.batch_size": 2, "io.seq_len": 2})
    trees = fake_trees(cfg, seed=1)
    batch = synthetic_batch(cfg, 2, 2, np.random.default_rng(1))
    card, cpu = state_of(cfg, trees, "cuda"), state_of(cfg, trees, "cpu")
    m_card = make_train_step(cfg, card.models)(card, batch)
    m_cpu = make_train_step(cfg, cpu.models)(cpu, batch)
    errs = {k: abs(float(m_card[k]) - float(m_cpu[k])) for k in METRIC_NAMES}
    tols = {k: CPU_TOL_BALANCED if k.endswith("_balanced") else CPU_TOL_METRICS
            for k in METRIC_NAMES}
    bad = {k: errs[k] for k in METRIC_NAMES if errs[k] > tols[k] * (1 + abs(float(m_cpu[k])))}
    grads, flips = gradient_check(card, cpu, CPU_TOL_GRAD, cfg.optimizer.beta_2)
    stats = max((a.float().cpu() - b.float()).abs().max().item()
                for a, b in zip(card.models.generator.buffers(), cpu.models.generator.buffers()))
    if bad or any(grads[n] > CPU_TOL_GRAD[n] for n in grads) or stats > 1e-3 or any(
            flips.values()):
        raise AssertionError(f"card vs CPU step: metrics {bad}, grads {grads}, G stats {stats}, "
                             f"updated parameters {flips}")
    say("8 train step card-vs-cpu", dtype="float32", batch=2, length=2, metric_errs=errs,
        tol_metrics=CPU_TOL_METRICS, tol_balanced=CPU_TOL_BALANCED, grad_norm_err=grads,
        tol_grads=CPU_TOL_GRAD, g_stats_max_abs_err=stats, updated_param_mismatches=flips)


CLI_STEPS = 6  # phase 9: two eager warm-up steps, the capture, replays


def check_train_cli(attention, train_main, infer_main) -> None:
    """Phase 9: CLI_STEPS steps of the train CLI (recommended config, batch
    16) on CUDA graphs, the export of G, served with noise z."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    g_path = OUT_DIR / "trained_g.npz"
    before = attention.bwd_launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--device", "cuda", "--steps", str(CLI_STEPS), "--export-g", str(g_path)])
    rate = [ln for ln in out.getvalue().splitlines() if "steps/s" in ln]
    if attention.bwd_launches != before + CLI_STEPS * BWD_PER_STEP or len(rate) != 1:
        raise AssertionError(f"the train CLI: {attention.bwd_launches - before} backward "
                             f"launches for {CLI_STEPS} steps:\n{out.getvalue()[-2000:]}")
    out_path = OUT_DIR / "trained_hopper.npy"
    infer_main(["--weights", str(g_path), "--word", "Hopper", "-n", "4", "--device", "cuda",
                "--out", str(out_path), "--config", str(ROOT / "configs" / "recommended.json")])
    served = np.load(out_path)
    if served.shape != (4, 32, 96, 1) or not np.isfinite(served).all() or np.abs(served).max() > 1:
        raise AssertionError(f"served the trained G: {served.shape}")
    say("9 train cli", card=card_line(), steps=CLI_STEPS, steps_per_s=rate[0],
        export=str(g_path.relative_to(ROOT)),
        served=str(out_path.relative_to(ROOT)), shape=served.shape)


def time_backward(attention, lib, gen, card: str) -> dict:
    """Phase 10: the backward kernels at the step's shapes and at large
    batches; returns {(what, dtype, batch): the printed row}. kernel_ms and
    library_ms are CUDA events around eager calls; device_ms is the kernels'
    own time on the card; plain_ms is at `plain_batch`, which bounds the
    plain version's (B, Q, K) matrices."""
    from scrabblegan_torch.kernels.bench import (backward_grids, device_ms_by_kernel,
                                                 library_backward_ms)
    stream = torch.cuda.current_stream().cuda_stream
    floor = {}
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        floor[dtype] = cuda_ms(lambda: lib.attention_bwd_floor(code, 0, stream), 200)
        say("10 time backward floor", card=card, dtype=str(dtype),
            empty_launches=4 if code == 0 else 3, ms=floor[dtype])
    out = {}
    for what, q1, k1, dtype, batches in (("D/W B1", 128, 32, torch.bfloat16, (TRAIN_BATCH, 256)),
                                         ("G B3", 512, 128, torch.float32, (TRAIN_BATCH, 256)),
                                         ("G B3", 512, 128, torch.bfloat16, (256, 1024))):
        for n in LENGTHS:
            q, k = q1 * n, k1 * n
            for batch in batches:
                ops = bwd_operands(batch, q, k, dtype, gen)
                kernel_ms = cuda_ms(lambda: attention._launch_backward(*ops), 10)
                by_kernel = device_ms_by_kernel(lambda: attention._launch_backward(*ops))
                small = max(1, min(batch, 2560 * 640 * 64 // (q * k)))
                plain_ms = cuda_ms(lambda: attention.attention_backward_reference(
                    *(t[:small] for t in ops)), 5)
                bound_ms, bound_by = core_bound(batch, q, k, dtype, backward=True)
                row = dict(
                    what=f"{what} len {n}", q=q, k=k, batch=batch, dtype=str(dtype), tf32=False,
                    kernel_ms=kernel_ms, device_ms=sum(by_kernel.values()),
                    device_ms_by_kernel=by_kernel, plain_ms=plain_ms, plain_batch=small,
                    library_ms=library_backward_ms(ops, 10), bound_ms=bound_ms,
                    bound_by=bound_by, floor_ms=floor[dtype], **backward_grids(batch, q, k))
                say("10 time backward", card=card, **row)
                out[(f"{what} len {n}", dtype, batch)] = row
                del ops
                torch.cuda.empty_cache()
    return out


def time_train_steps(runs: dict, make_train_step, card: str) -> dict:
    """Phase 10: steps/s of both configurations on the kernels and on the
    plain cores, in turns plain, kernel, kernel, plain of TIME_STEPS steps
    each (the batches in a cycle), after two warm-up steps. A CUDA event is
    recorded before each step and after the last, with one synchronise at
    the end of the turn, so each step's time is the interval between its
    events, whichever of the host and the device sets the pace. Printed per
    core: the window means of its turns, and the median and the 10th and
    90th percentiles of its per-step times. Returns {config: the kernel
    core's median ms a step}."""
    medians = {}
    for name, (kstate, pstate, batches, kcfg, pcfg) in runs.items():
        steps = {"kernel": (kstate, make_train_step(kcfg, kstate.models)),
                 "plain": (pstate, make_train_step(pcfg, pstate.models))}
        for state, step in steps.values():
            step(state, batches[0])
            step(state, batches[1])
        window = {"kernel": [], "plain": []}
        per_step = {"kernel": [], "plain": []}
        for core in ("plain", "kernel", "kernel", "plain"):
            state, step = steps[core]
            events = [torch.cuda.Event(enable_timing=True) for _ in range(TIME_STEPS + 1)]
            torch.cuda.synchronize()
            for i in range(TIME_STEPS):
                events[i].record()
                step(state, batches[i % len(batches)])
            events[-1].record()
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            window[core].append(sum(ms) / TIME_STEPS)
            per_step[core] += ms
        medians[name] = float(np.median(per_step["kernel"]))
        for core in window:
            p10, p50, p90 = np.percentile(per_step[core], [10, 50, 90]).tolist()
            say("10 time train step", card=card, config=name, core=core, batch=TRAIN_BATCH,
                tf32=False, steps_per_turn=TIME_STEPS, turns="plain, kernel, kernel, plain",
                window_ms_per_step=window[core], median_ms_per_step=p50,
                p10_p90_ms_per_step=[p10, p90], median_steps_per_s=1e3 / p50,
                mean_steps_per_s=1e3 * len(per_step[core]) / sum(per_step[core]))
    return medians


def profile_train_steps(runs: dict, make_train_step, card: str) -> None:
    """Phase 10: torch.profiler over 5 steps of the bench len-5 config on each
    core: device busy share (union of kernel intervals over the span from the
    first kernel's start to the last's end), kernels a step, and the top
    kernels by device time."""
    kstate, pstate, batches, kcfg, pcfg = runs["bench bucketed len 5"]
    for core, state, cfg in (("kernel", kstate, kcfg), ("plain", pstate, pcfg)):
        profile_steps(core, state, make_train_step(cfg, state.models), batches[:5], card)


def device_activity(prof) -> tuple[list, float, float, dict]:
    """A profile's device events, the time some kernel was running (the union
    of their intervals), the span from the first kernel's start to the last's
    end, and {kernel name: [total time, count]}; times in microseconds."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.end - e.time_range.start
        t[1] += 1
    return kernels, busy, spans[-1][1] - spans[0][0], by_name


# kernel classes of G's serving profile, by substrings of the kernel's name, first match
SERVING_CLASSES = (
    ("attention kernel", ("attention_fwd", "fused_block_fwd")),
    ("layout transforms", ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc", "nhwc2nchw")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("max pool", ("max_pool",)),
    ("conv and matmul math", ("cudnn", "xmma", "cutlass", "gemm", "conv", "wgrad", "dgrad",
                              "nvjet")),
    ("elementwise", ("elementwise", "vectorized", "CatArray", "copy", "fill")))


def profile_generator(g, feeds: dict, card: str) -> None:
    """Phase 6: torch.profiler over 3 forwards of G at batch 1024, per length
    and dataflow: device busy share and ms a forward by kernel class."""
    from torch.profiler import ProfilerActivity, profile

    forwards = 3
    for flow in ("nhwc1", "fused"):
        for n in LENGTHS:
            labels, z = feeds[n]
            with dataflow(flow), torch.inference_mode():
                g(labels, z)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(forwards):
                        g(labels, z)
                    torch.cuda.synchronize()
            kernels, busy, span, by_name = device_activity(prof)
            classes = {name: 0.0 for name, _ in SERVING_CLASSES}
            classes["other"] = 0.0
            for kernel, (t, _) in by_name.items():
                cls = next((name for name, keys in SERVING_CLASSES
                            if any(k in kernel for k in keys)), "other")
                classes[cls] += t / forwards / 1e3
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            say("6 profile generator", card=card, dataflow=flow, length=n, batch=BATCH,
                dtype="bfloat16", forwards=forwards, device_busy_share=busy / span,
                device_busy_ms_per_forward=busy / forwards / 1e3,
                kernels_per_forward=len(kernels) / forwards, ms_per_forward_by_class=classes,
                top_kernels_ms_per_forward=[(k[:90], t / forwards / 1e3, c / forwards)
                                            for k, (t, c) in top])


def attention_module():
    from scrabblegan_torch.kernels import attention
    return attention


def profile_steps(core: str, state, step, batches: list, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    step(state, batches[0])
    torch.cuda.synchronize()
    copies_before = attention_module().bwd_dout_copies
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(batches)
    dout_copies = attention_module().bwd_dout_copies - copies_before
    kernels, busy, span, by_name = device_activity(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    attn = {k: (t / n / 1e3, c / n) for k, (t, c) in by_name.items() if "attention_" in k}
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=30)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"profile_train_step_{core}.txt").write_text(table)
    say("10 profile train step", card=card, config="bench bucketed len 5", core=core,
        steps=n, wall_ms_per_step=1e3 * wall / n, device_busy_share=busy / span,
        device_busy_ms_per_step=busy / n / 1e3, kernels_per_step=len(kernels) / n,
        attention_kernels_ms_and_count_per_step=attn,
        attention_ms_per_step=sum(t for t, _ in attn.values()),
        backward_calls_that_copied_dout_per_step=dout_copies / n,
        top_kernels_ms_per_step=[(k[:90], t / n / 1e3, c / n) for k, (t, c) in top])


# ---- phases 11-14: the 'fused' attention dataflow ------------------------------

FUSED_TOL = {torch.float32: 5e-4, torch.bfloat16: 1e-1}  # tests/test_kernels.py:109-118
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
EXP_PER_CLOCK_PER_SM = 16  # special-function units, compute capability 9.0


@contextlib.contextmanager
def dataflow(name: str):
    """The attention dataflow every NonLocalBlock resolves at its next call."""
    before = os.environ.get("SCRABBLEGAN_ATTN_DATAFLOW")
    os.environ["SCRABBLEGAN_ATTN_DATAFLOW"] = name
    try:
        yield
    finally:
        if before is None:
            del os.environ["SCRABBLEGAN_ATTN_DATAFLOW"]
        else:
            os.environ["SCRABBLEGAN_ATTN_DATAFLOW"] = before


def reset_counts(*modules) -> None:
    for m in modules:
        for name in ("launches", "bwd_launches", "bwd_dout_copies"):
            if hasattr(m, name):
                setattr(m, name, 0)


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@functools.cache
def sm_clock_hz() -> float:
    """The card's largest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(bytes_moved: float, flops: float, exps: float, dtype) -> tuple[float, str]:
    """(ms, 'bytes', 'operations' or 'exponentials'): the largest of the three
    least times. The exponentials run on the special-function units, 16 a
    clock on each SM, at the largest SM clock."""
    sms = sm_count()
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
             "operations": flops / PEAK_FLOPS[dtype] * 1e3,
             "exponentials": exps / (EXP_PER_CLOCK_PER_SM * sms * sm_clock_hz()) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def core_bound(batch: int, q: int, k: int, dtype, backward: bool) -> tuple[float, str]:
    """The attention core: theta, phi, g (and dout) read, out (or the three
    grads) written; 2 (Ca + Cg) flops a (q, k) pair forward, 2 (3 Ca + 2 Cg)
    backward (scores, dA, dtheta, dphi, dg); one exponential a pair either
    way (the backward recomputes the softmax)."""
    size = torch.tensor([], dtype=dtype).element_size()
    elems = 8 * q + 8 * k + 32 * k + 32 * q
    if backward:
        elems += 8 * q + 8 * k + 32 * k
    per_pair = 2 * (3 * 8 + 2 * 32) if backward else 2 * (8 + 32)
    return bound(size * batch * elems, batch * q * k * per_pair, batch * q * k, dtype)


def fused_bound(batch: int, n: int, k: int, dtype) -> tuple[float, str]:
    """The fused block: x, phi, g and the two weights read, out written; the
    core's 80 flops and one exponential a (q, k) pair and 2 (64 x 8 + 32 x 64)
    flops a query."""
    size = torch.tensor([], dtype=dtype).element_size()
    elems = batch * (2 * 64 * n + 8 * k + 32 * k) + 64 * 8 + 32 * 64
    flops = batch * n * k * 2 * (8 + 32) + batch * n * 2 * (64 * 8 + 32 * 64)
    return bound(size * elems, flops, batch * n * k, dtype)


def fused_operands(batch: int, n: int, k: int, dtype, gen: torch.Generator):
    """x (B, 64, N), w_theta (64, 8), phiT, gT and sigma-folded w_out (32, 64),
    the scales of the JAX fused-kernel test."""
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
    return [rnd(batch, 64, n), rnd(64, 8, scale=0.2), rnd(batch, 8, k), rnd(batch, 32, k),
            rnd(32, 64, scale=0.2)]


def check_fused_kernel(fused_block, gen) -> dict:
    """Phase 11; returns the largest error against the plain version per dtype."""
    worst = {}
    cases = [(f"G B3 len {n}", 512 * n, 128 * n) for n in (1, 5, 10)]
    cases += [(f"D/W B1 len {n}", 128 * n, 32 * n) for n in (1, 5, 10)] + [("ragged", 300, 75)]
    cases += [("staging", n, k) for n, k in staging_shapes()]
    for dtype in (torch.float32, torch.bfloat16):
        worst[str(dtype)] = 0.0
        for what, n, k in cases:
            ops = fused_operands(4, n, k, dtype, gen)
            got = fused_block._launch_fused(*ops)
            ref = fused_block.fused_block_reference(*ops)
            torch.cuda.synchronize()
            err = check_close(f"fused kernel vs plain at {what} {dtype}", got, ref,
                              FUSED_TOL[dtype])
            say("11 fused-vs-plain", what=what, dtype=str(dtype), n=n, k=k, batch=4,
                max_abs_err=err, tol=FUSED_TOL[dtype])
            worst[str(dtype)] = max(worst[str(dtype)], err)
    # the autograd Function: the fused kernel forward, the composition's
    # gradient on the core's kernels; against autograd through the plain
    # composition in the same dtype
    for dtype in (torch.float32, torch.bfloat16):
        for what, n, k in [c for c in cases if c[0].startswith("D/W")] + [("ragged", 300, 75)]:
            ops = fused_operands(2, n, k, dtype, gen)
            d = torch.randn(2, 64, n, generator=gen, device="cuda").to(dtype)
            xs = [t.clone().requires_grad_() for t in ops]
            fused_block.FusedBlock.apply(*xs).backward(d)
            ys = [t.clone().requires_grad_() for t in ops]
            fused_block.fused_block_reference(*ys).backward(d)
            errs = []
            for name, x, y in zip(("x", "w_theta", "phiT", "gT", "w_out"), xs, ys):
                scale = y.grad.float().abs().max().item()
                err = (x.grad.float() - y.grad.float()).abs().max().item()
                if err > BWD_TOL[dtype] * scale:
                    raise AssertionError(f"FusedBlock grad {name} at {what} {dtype}: max abs "
                                         f"error {err} beyond {BWD_TOL[dtype]} x {scale}")
                errs.append(err / scale)
            say("11 fused-autograd-vs-plain", what=what, dtype=str(dtype), n=n, k=k,
                grad_err_rel_to_largest=errs, tol=BWD_TOL[dtype])
    return worst


def serve_fused(g, feeds: dict, images: dict, attention, fused_block) -> int:
    """Phase 12, the path: G under 'fused' at batch 1024; returns the fused
    launches."""
    with dataflow("fused"), torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts(attention, fused_block)
        fused = {n: g(*feeds[n]) for n in LENGTHS}
        torch.cuda.synchronize()
        launches = fused_block.launches
        if (launches, attention.launches) != (len(LENGTHS), 0):
            raise AssertionError(f"'fused' G: {launches} fused and {attention.launches} core "
                                 f"launches for {len(LENGTHS)} forwards")
    for n in LENGTHS:
        check_images(fused[n], BATCH, n)
        err = check_close(f"G 'fused' vs 'nhwc1' at len {n}", fused[n], images[n], G_TOL_PLAIN)
        say("12 generator fused", length=n, batch=BATCH, dtype="bfloat16",
            fused_launches_per_forward=launches / len(LENGTHS),
            max_abs_err_vs_nhwc1=err, tol=G_TOL_PLAIN)
    return launches


def time_fused(g, feeds: dict, fused_block, attention, gen, card: str) -> dict:
    """Phase 12, times: G's images/s per dataflow in turns; the fused kernel,
    its plain version and the forward core's library yardstick at B3 (the
    library's backward is timed in phase 10)."""
    per = {"nhwc1": {n: [] for n in LENGTHS}, "fused": {n: [] for n in LENGTHS}}
    with torch.inference_mode():
        for turn in ("nhwc1", "fused", "fused", "nhwc1"):
            with dataflow(turn):
                for n in LENGTHS:
                    labels, z = feeds[n]
                    per[turn][n].append(cuda_ms(lambda: g(labels, z), 10, warmup=2))
        for turn, by_len in per.items():
            for n, ms in by_len.items():
                say("12 time generator", card=card, dataflow=turn, dtype="bfloat16", length=n,
                    batch=BATCH, turns="nhwc1, fused, fused, nhwc1", ms_per_batch=ms,
                    images_per_s=[BATCH / t * 1e3 for t in ms])
        out = {}
        for n, plain_batch in ((5, BATCH), (10, BATCH // 2)):
            q, k = 512 * n, 128 * n
            ops = fused_operands(BATCH, q, k, torch.bfloat16, gen)
            kernel_ms = cuda_ms(lambda: fused_block._launch_fused(*ops), 10)
            small = [t[:plain_batch] if t.dim() == 3 else t for t in ops]
            kernel_small_ms = cuda_ms(lambda: fused_block._launch_fused(*small), 10)
            plain_ms = cuda_ms(lambda: fused_block.fused_block_reference(*small), 5)
            bound_ms, bound_by = fused_bound(BATCH, q, k, torch.bfloat16)
            say("12 time fused block", card=card, dtype="bfloat16", length=n, n=q, k=k,
                kernel_ms_batch1024=kernel_ms, kernel_ms=kernel_small_ms, plain_ms=plain_ms,
                batch_compared=plain_batch, bound_ms_batch1024=bound_ms, bound_by=bound_by)
            out[n] = (kernel_ms, plain_ms)
            del ops, small
            torch.cuda.empty_cache()
        thetaT, phiT, gT = b3_operands(BATCH, 2560, 640, torch.bfloat16, gen)
        q_, k_, v_ = (t.transpose(1, 2).unsqueeze(1).contiguous() for t in (thetaT, phiT, gT))
        out["library_fwd"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_, k_, v_, scale=1.0), 10)
        say("12 time library attention", card=card, call="F.scaled_dot_product_attention",
            dtype="bfloat16", batch=BATCH, q=2560, k=640, ms=out["library_fwd"])
        del thetaT, phiT, gT, q_, k_, v_
    return out


def check_train_step_fused(attention, fused_block, load_config, synthetic_batch,
                           make_train_step, METRIC_NAMES) -> int:
    """Phase 13; returns the fused launches of the two 10-step runs."""
    rng = np.random.default_rng(2)
    total = 0
    for name, cfg in train_configs(load_config).items():
        kcfg = with_core(cfg, True)
        trees = fake_trees(kcfg)
        length = cfg.io.seq_len or 5
        batches = [synthetic_batch(cfg, TRAIN_BATCH, length, rng) for _ in range(TRAIN_STEPS)]
        with dataflow("fused"):
            state = state_of(kcfg, trees, "cuda")
            step = make_train_step(kcfg, state.models)
            torch.cuda.synchronize()
            reset_counts(attention, fused_block)
            metrics = [step(state, b) for b in batches]
            torch.cuda.synchronize()
            counts = (fused_block.launches, attention.launches, attention.bwd_launches)
            want = (FWD_PER_STEP * TRAIN_STEPS,) * 3
            if counts != want:
                raise AssertionError(f"{name} under 'fused': (fused, core forward, core "
                                     f"backward) launches {counts}, derived {want}")
            total += counts[0]
            del state, step
            values = np.array([[float(m[k]) for k in METRIC_NAMES] for m in metrics])
            if not np.isfinite(values).all():
                raise AssertionError(f"{name} under 'fused': non-finite metrics")
            say("13 train step fused", config=name, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                launches_per_step=dict(zip(("fused", "core_fwd", "core_bwd"),
                                           [c / TRAIN_STEPS for c in counts])),
                first=dict(zip(METRIC_NAMES, values[0].tolist())),
                last=dict(zip(METRIC_NAMES, values[-1].tolist())))
            fused = state_of(kcfg, trees, "cuda")
            with deterministic_convs():
                m_fused = make_train_step(kcfg, fused.models)(fused, batches[0])
        with dataflow("nhwc1"), deterministic_convs():
            nhwc1 = state_of(kcfg, trees, "cuda")
            m_nhwc1 = make_train_step(kcfg, nhwc1.models)(nhwc1, batches[0])
        # the two balanced metrics scale by std(g_loss) over the batch (~3e-4 at
        # this state, a std of nearly equal values), which the two dataflows'
        # bf16 roundings in D and W move by ~10%: they are held as in the
        # card-vs-CPU check
        errs = {k: abs(float(m_fused[k]) - float(m_nhwc1[k])) for k in METRIC_NAMES}
        tols = {k: CPU_TOL_BALANCED if k.endswith("_balanced") else STEP_TOL_METRICS
                for k in METRIC_NAMES}
        bad = [k for k in METRIC_NAMES if errs[k] > tols[k] * (1 + abs(float(m_nhwc1[k])))]
        grads, flips = gradient_check(fused, nhwc1, STEP_TOL_GRAD, cfg.optimizer.beta_2)
        if bad or any(grads[n] > STEP_TOL_GRAD[n] for n in grads) or any(flips.values()):
            raise AssertionError(f"{name}: 'fused' vs 'nhwc1' step 1: metrics {bad}, grads "
                                 f"{grads}, updated parameters {flips}")
        say("13 train step fused-vs-nhwc1", config=name, step=1, metric_errs=errs,
            max_metric_err=max(errs.values()), tol_metrics=STEP_TOL_METRICS,
            tol_balanced=CPU_TOL_BALANCED, grad_norm_err=grads, tol_grads=STEP_TOL_GRAD,
            updated_param_mismatches=flips)
        del fused, nhwc1
        torch.cuda.empty_cache()
    return total


def check_workdir_cli(attention, fused_block, train_main, infer_main, load_config) -> int:
    """Phase 14, under 'fused': train --workdir for 3 steps, then 2 more that
    resume at step 3; infer --model-dir serves the newest export. Returns the
    train runs' fused launches: 7 a step, and one a standing-stats forward
    of G before each of the two exports (recommended config: EMA on)."""
    standing = load_config(str(ROOT / "configs" / "recommended.json")
                           ).optimizer.ema_standing_stat_batches
    want = 5 * FWD_PER_STEP + 2 * standing
    workdir = OUT_DIR / "workdir"
    shutil.rmtree(workdir, ignore_errors=True)
    logs = []
    with dataflow("fused"):
        reset_counts(attention, fused_block)
        for steps in (3, 2):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                train_main(["--device", "cuda", "--steps", str(steps),
                            "--workdir", str(workdir)])
            logs.append(out.getvalue())
        train_launches = fused_block.launches
        if ("resumed" in logs[0] or "resumed from checkpoint at step 3" not in logs[1]
                or "step 5: d_loss=" not in logs[1] or train_launches != want):
            raise AssertionError(f"train --workdir: {train_launches} fused launches, "
                                 f"derived {want}; "
                                 f"second run's log:\n{logs[1][-2000:]}")
        ckpts = sorted(p.name for p in (workdir / "checkpoints").iterdir() if p.name.isdigit())
        export = workdir / "model" / "generator" / "5"
        if ckpts != ["3", "5"] or not (export / "config.json").is_file():
            raise AssertionError(f"train --workdir: checkpoints {ckpts}, export {export}")
        out_path = OUT_DIR / "workdir_hopper.npy"
        before = fused_block.launches
        infer_main(["--model-dir", str(workdir / "model"), "--word", "Hopper", "-n", "4",
                    "--device", "cuda", "--out", str(out_path)])
        served = np.load(out_path)
        if (served.shape != (4, 32, 96, 1) or not np.isfinite(served).all()
                or np.abs(served).max() > 1 or fused_block.launches != before + 1):
            raise AssertionError(f"infer --model-dir: {served.shape}")
    say("14 workdir cli", dataflow="fused", runs="3 steps, then 2 resumed at step 3",
        checkpoints=ckpts, export=str(export.relative_to(ROOT)),
        train_fused_launches=train_launches, served=str(out_path.relative_to(ROOT)),
        shape=served.shape)
    return train_launches


# ---- phases 15-17: the data path, the epoch Trainer, evaluate and serve ------

TRAINER_EPOCHS, TRAINER_BATCHES = 2, 20  # then 1 epoch more, resumed at step 40
FETCHES = ("cpu", "item", "tolist", "__float__")  # the calls that copy a tensor to the host


class HostFetches:
    """Counts the calls of FETCHES on tensors while `on` (the Trainer's
    batch loops: its state set-up and epoch artifacts are paused)."""

    def __init__(self, loop):
        self.count, self.on = 0, False
        self._saved = []
        for name in FETCHES:
            original = getattr(torch.Tensor, name)
            self._saved.append((torch.Tensor, name, original))

            def wrapper(t, *a, _original=original, **k):
                if self.on:
                    self.count += 1
                return _original(t, *a, **k)
            setattr(torch.Tensor, name, wrapper)
        for name in ("init_state", "save_epoch_artifacts"):
            original = getattr(loop.Trainer, name)
            self._saved.append((loop.Trainer, name, original))

            def paused(trainer, *a, _original=original, **k):
                self.on = False
                try:
                    return _original(trainer, *a, **k)
                finally:
                    self.on = True
            setattr(loop.Trainer, name, paused)

    def restore(self) -> None:
        for owner, name, original in self._saved:
            setattr(owner, name, original)


def check_data(workdir: Path) -> tuple[Path, dict]:
    """Phase 15; returns the data set's root and the style image paths."""
    from scrabblegan_torch.config import load_config
    from scrabblegan_torch.data.images import read_grayscale
    from scrabblegan_torch.data.loaders import BucketedDataset, load_style_images
    from scrabblegan_torch.data.synthetic import make_synthetic_dataset

    root = workdir / "data15"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    read_dir, _, style_dir = make_synthetic_dataset(str(root), samples_per_bucket=64,
                                                    style="script")
    write_s = time.perf_counter() - t0
    pngs = sorted(root.rglob("*.png"))
    t0 = time.perf_counter()
    shapes = {read_grayscale(str(p)).shape for p in pngs}
    read_s = time.perf_counter() - t0
    if len(pngs) != 640 + 12 or any(h != 32 for h, _ in shapes):
        raise AssertionError(f"synthetic data set: {len(pngs)} PNGs, shapes {shapes}")
    cfg = load_config(None)
    t0 = time.perf_counter()
    ds = BucketedDataset(read_dir, cfg.io.input_dim, cfg.io.bucket_size)
    dataset_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, validate = load_style_images(style_dir, cfg.io.input_dim)
    style_s = time.perf_counter() - t0
    if ds.num_samples != 640 or (len(train), len(validate)) != (11, 1):
        raise AssertionError(f"loaded {ds.num_samples} words, style {len(train)}/{len(validate)}")
    say("15 data", words=ds.num_samples, buckets=len(ds.nonempty), style_images=12,
        write_s=write_s, png_read_s=read_s, pngs=len(pngs), bucketed_dataset_load_s=dataset_s,
        style_load_s=style_s, style_split=[len(train), len(validate)])
    return root, sorted(Path(style_dir).glob("*.png"))


def check_trainer(attention, fused_block, workdir: Path, eager_median_ms: float,
                  graph_median_ms: float) -> dict:
    """Phase 16: the train CLI's Trainer mode on the card with
    configs/recommended.json (padded, EMA 0.999, standing statistics, the
    gate at 64 samples, batch 16): 2 epochs of 20 batches, then 1 more that
    resumes at step 40. Returns the launches of the two runs."""
    from scrabblegan_torch.config import load_config
    from scrabblegan_torch.data.images import read_grayscale
    from scrabblegan_torch.train import loop
    from scrabblegan_torch.train import main as train_main

    cfg = load_config(str(ROOT / "configs" / "recommended.json"))
    standing = cfg.optimizer.ema_standing_stat_batches
    gate_chunks = -(-cfg.io.export_quality_samples // cfg.shared.num_gen)
    per_epoch_fwd = TRAINER_BATCHES * FWD_PER_STEP + standing + 1 + gate_chunks
    shutil.rmtree(workdir, ignore_errors=True)
    trainers = []
    train = loop.Trainer.train

    def recorded(trainer, *a, **k):
        trainers.append(trainer)
        return train(trainer, *a, **k)
    loop.Trainer.train = recorded
    fetches = HostFetches(loop)
    launches, logs = [], []
    try:
        for epochs in (TRAINER_EPOCHS, TRAINER_EPOCHS + 1):
            torch.cuda.synchronize()
            reset_counts(attention, fused_block)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = train_main(["--device", "cuda", "--synthetic", "--workdir", str(workdir),
                                 "--epochs", str(epochs),
                                 "--batches-per-epoch", str(TRAINER_BATCHES)])
            torch.cuda.synchronize()
            logs.append(out.getvalue())
            launches.append((attention.launches, attention.bwd_launches, fused_block.launches))
            if rc != 0:
                raise AssertionError(f"train exited {rc}:\n{logs[-1][-2000:]}")
            if epochs == TRAINER_EPOCHS:
                first_run_fetches = fetches.count
    finally:
        fetches.restore()
        loop.Trainer.train = train
    for run_epochs, trainer, (fwd, bwd, fused) in zip((TRAINER_EPOCHS, 1), trainers, launches):
        want = (run_epochs * per_epoch_fwd, run_epochs * TRAINER_BATCHES * BWD_PER_STEP, 0)
        if (fwd, bwd, fused) != want or len(trainer.chunk.graphs.captured) != 1:
            raise AssertionError(f"Trainer launches (fwd, bwd, fused) {(fwd, bwd, fused)}, "
                                 f"derived {want}; graphs {len(trainer.chunk.graphs.captured)}")
    resumed_at = TRAINER_EPOCHS * TRAINER_BATCHES
    if "resumed" in logs[0] or f"resumed from checkpoint at step {resumed_at}" not in logs[1]:
        raise AssertionError(f"Trainer resume:\n{logs[1][-2000:]}")
    out_dir = workdir / "output"
    rows = (out_dir / "batch_summary.txt").read_text().splitlines()
    values = np.array([[float(v) for v in r.split(";")] for r in rows[1:]])
    steps = (TRAINER_EPOCHS + 1) * TRAINER_BATCHES
    if (rows[0].count(";") != 15 or values.shape != (steps, 16) or not np.isfinite(values).all()
            or len((out_dir / "batch_summary.csv").read_text().splitlines()) != steps + 1
            or len((out_dir / "epoch_summary.txt").read_text().splitlines()) != 4):
        raise AssertionError(f"summaries: {values.shape}, finite {np.isfinite(values).all()}")
    grids = [read_grayscale(str(out_dir / f"image_at_epoch_{e:04d}.png")).shape
             for e in (1, 2, 3)]
    ckpts = sorted(int(p.name) for p in (workdir / "checkpoints").iterdir() if p.name.isdigit())
    exports = {net: sorted(p.name for p in (workdir / "model" / net).iterdir()
                           if p.name.isdigit()) for net in ("generator", "recognizer")}
    gens = workdir / "model" / "generator"
    flags = {e: json.loads((gens / f"quality_{e}.json").read_text())["flag"] for e in (1, 2, 3)}
    good = [e for e, f in flags.items() if f == "ok"]
    link = gens / "latest_good"
    if (ckpts != [TRAINER_BATCHES * e for e in (1, 2, 3)] or exports != {n: ["1", "2", "3"] for n in exports}
            or (out_dir / "biggan.gif").read_bytes()[:6] != b"GIF89a"
            or (good and os.readlink(link) != str(max(good))) or (not good and link.exists())):
        raise AssertionError(f"artifacts: checkpoints {ckpts}, exports {exports}, "
                             f"flags {flags}")
    first = trainers[0]
    warm_s = first.epoch_secs[1]
    say("16 trainer", card=card_line(), config="configs/recommended.json", batch=TRAIN_BATCH,
        epochs_then_resumed=[TRAINER_EPOCHS, 1], batches_per_epoch=TRAINER_BATCHES,
        launches_per_run_fwd_bwd_fused=launches,
        derived_fwd_per_epoch=f"{TRAINER_BATCHES} x {FWD_PER_STEP} + {standing} standing "
                              f"+ 1 grid + {gate_chunks} gate = {per_epoch_fwd}",
        fwd_per_step=FWD_PER_STEP, bwd_per_step=BWD_PER_STEP,
        graph_warmup_steps_per_run=[t.chunk.graphs.warmup_steps for t in trainers],
        graph_capture_s=[g.capture_s for t in trainers
                         for g in t.chunk.graphs.captured.values()],
        graph_pool_bytes=[g.pool_bytes for t in trainers
                          for g in t.chunk.graphs.captured.values()],
        metrics_finite=True, epoch_secs=[t.epoch_secs for t in trainers],
        warm_epoch_steps_per_s=TRAINER_BATCHES / warm_s,
        eager_step_median_ms=eager_median_ms, graph_step_median_ms=graph_median_ms,
        loop_ms_per_step=1e3 * warm_s / TRAINER_BATCHES,
        loop_host_cost_ms_per_step=1e3 * warm_s / TRAINER_BATCHES - graph_median_ms,
        host_fetches_first_run=first_run_fetches,
        host_fetches_per_step=first_run_fetches / (TRAINER_EPOCHS * TRAINER_BATCHES),
        artifact_secs=[t.artifact_secs for t in trainers], checkpoints=ckpts,
        exports=exports, gate_flags=flags, grids=grids)
    return {"fwd": sum(x[0] for x in launches), "bwd": sum(x[1] for x in launches)}


def check_evaluate_and_serve(attention, fused_block, workdir: Path, style_pngs: list,
                             gen) -> dict:
    """Phase 17: evaluate and the style-source infer on phase 16's workdir;
    then G with style z at batch 1024, len 5, bf16 under 'nhwc1' and
    'fused'. Returns the launches of each path."""
    from scrabblegan_torch.config import load_config
    from scrabblegan_torch.convert import fake_flax_variables, generator_from_flax
    from scrabblegan_torch.data.images import read_grayscale
    from scrabblegan_torch.data.loaders import load_style_images
    from scrabblegan_torch.evaluate import main as evaluate_main
    from scrabblegan_torch.infer import main as infer_main

    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts(attention, fused_block)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = evaluate_main(["--workdir", str(workdir), "--bucket", "all"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = attention.launches
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0 or len(lines) != 10 or not all(
            np.isfinite([r["rfid"], r["cer_real"], r["cer_gen"]]).all() for r in lines):
        raise AssertionError(f"evaluate: rc {rc}, {out.getvalue()[-2000:]}")
    if attention.bwd_launches or fused_block.launches or eval_launches == 0:
        raise AssertionError(f"evaluate launches {eval_launches}")
    say("17 evaluate", buckets=[r["bucket"] for r in lines], rfid=[r["rfid"] for r in lines],
        cer_real=[r["cer_real"] for r in lines], cer_gen=[r["cer_gen"] for r in lines],
        seconds=eval_s, fwd_launches=eval_launches)

    served = {}
    infer_launches = 0
    for what, extra in (("style image", ["--style-image", str(style_pngs[0])]),
                        ("blank page", [])):
        png = OUT_DIR / f"infer_style_{len(served)}.png"
        before = attention.launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            infer_main(["--model-dir", str(workdir / "model"), "--export", "auto", "--device",
                        "cuda", "--out", str(png), *extra])
        page = read_grayscale(str(png))
        n, width = 10, 16 * len("machinelearning")
        if (page.shape != (n * (32 + 4) + 4, width + 8) or "z style" not in out.getvalue()
                or attention.launches != before + 1):
            raise AssertionError(f"infer {what}: {page.shape}, {out.getvalue()[-500:]}")
        infer_launches += 1
        served[what] = page
    if np.array_equal(*served.values()):
        raise AssertionError("infer: the style image did not change the images")
    say("17 infer style", pages={k: v.shape for k, v in served.items()},
        fwd_launches=infer_launches, log=out.getvalue().strip().splitlines())

    cfg = load_config(None, {"shared.dtype": "bfloat16", "shared.trunk_dtype": "bfloat16"})
    g = generator_from_flax(fake_flax_variables(cfg, seed=3), cfg, "cuda")
    train, _ = load_style_images(str(Path(style_pngs[0]).parent), cfg.io.input_dim)
    bank = torch.from_numpy(np.stack(train)).to("cuda")
    style = bank[torch.randint(0, len(train), (BATCH,), generator=gen, device="cuda")][:, None]
    labels = torch.randint(0, 52, (BATCH, 5), generator=gen, device="cuda")
    images, counts = {}, {}
    with torch.inference_mode():
        for flow in ("nhwc1", "fused"):
            with dataflow(flow):
                torch.cuda.synchronize()
                reset_counts(attention, fused_block)
                images[flow] = g(labels, style_imgs=style)
                torch.cuda.synchronize()
                counts[flow] = (attention.launches, fused_block.launches)
    for flow in images:
        check_images(images[flow], BATCH, 5)
    if counts != {"nhwc1": (1, 0), "fused": (0, 1)}:
        raise AssertionError(f"style-z G launches (core, fused): {counts}")
    err = check_close("style-z G 'fused' vs 'nhwc1'", images["fused"], images["nhwc1"],
                      G_TOL_PLAIN)
    say("17 generator style z", batch=BATCH, length=5, dtype="bfloat16",
        launches_core_fused=counts, max_abs_err_fused_vs_nhwc1=err, tol=G_TOL_PLAIN)
    return {"evaluate": eval_launches, "infer": infer_launches, "style_nhwc1": 1,
            "style_fused": 1}


# ---- phases 18-19: the captured train step, the real-data campaign config ------

GRAPH_K = 4          # steps a call in the K = 4 comparison and timing
GRAPH_TIME_CALLS = 50  # K = 1 calls timed (phase 18)
REMAT_FWD_PER_STEP = FWD_PER_STEP + 1  # the backward recomputes G's B3 forward
IAM_WORDS, IAM_BATCHES = 300, 8  # phase 19: raw words fabricated; batches of its one epoch


def stacked(batches: list) -> dict:
    return {key: np.stack([b[key] for b in batches]) for key in batches[0]}


def all_state(state) -> list:
    """Every tensor the step body writes: parameters, buffers (BN, CBN and
    spectral-norm statistics), the optimizers' counts and moments, the EMA
    and the device step counter."""
    out = []
    for module in state.modules().values():
        out += [p.data for p in module.parameters()] + list(module.buffers())
    for s in state.opt_states.values():
        out += [s.count, *s.nu, *(s.mu or ())]
    return out + list(state.g_ema or ()) + [state.step_t]


def counts_now(attention, fused_block) -> tuple:
    return attention.launches, attention.bwd_launches, fused_block.launches


def graph_vs_eager(cfg, trees, batches, make_train_step, make_chunked_train_step,
                   METRIC_NAMES, attention, fused_block, per_step: tuple, ref_cfg=None) -> dict:
    """len(batches) steps of the chunked step (CUDA graphs) against as many
    eager steps of `ref_cfg` (default `cfg`) from the same start, under
    cuDNN's deterministic algorithms: a call of the graph's WARMUP_STEPS
    eager warm-up steps, then one call of the other k steps (the capture and
    k replays). The launch counts of each call against its steps times
    `per_step` = (core forward, core backward, fused). Returns the errors,
    the k-step call's counts and the graphs."""
    from scrabblegan_torch.train.graphs import WARMUP_STEPS

    k = len(batches) - WARMUP_STEPS
    eager, graph = state_of(ref_cfg or cfg, trees, "cuda"), state_of(cfg, trees, "cuda")
    parts = (batches[:WARMUP_STEPS], batches[WARMUP_STEPS:])
    got, counts = [], []
    with deterministic_convs():
        step = make_train_step(ref_cfg or cfg, eager.models)
        want = [step(eager, b) for b in batches]
        chunk = make_chunked_train_step(cfg, graph.models)
        for part in parts:
            torch.cuda.synchronize()
            reset_counts(attention, fused_block)
            got.append(chunk(graph, stacked(part)))
            torch.cuda.synchronize()
            counts.append(counts_now(attention, fused_block))
    derived = [tuple(len(part) * n for n in per_step) for part in parts]
    if (counts != derived or chunk.graphs.warmup_steps != WARMUP_STEPS
            or len(chunk.graphs.captured) != 1):
        raise AssertionError(f"graph calls: launches (fwd, bwd, fused) {counts}, derived "
                             f"{derived} for {WARMUP_STEPS} warm-up steps, then a capture "
                             f"and {k} replays; {len(chunk.graphs.captured)} graphs")
    counts, derived = counts[1], derived[1]
    got = torch.cat(got, dim=1).cpu().numpy()
    want = np.array([[float(m[n]) for n in METRIC_NAMES] for m in want]).T
    errs = np.abs(got - want)
    bad = [(METRIC_NAMES[j], i) for j, i in zip(*np.nonzero(
        errs > STEP_TOL_METRICS * (1 + np.abs(want))))]
    grads, flips = gradient_check(graph, eager, STEP_TOL_GRAD, cfg.optimizer.beta_2)
    if (not np.isfinite(got).all() or bad or any(grads[n] > STEP_TOL_GRAD[n] for n in grads)
            or (k == 1 and any(flips.values()))):
        raise AssertionError(f"graph vs eager, {len(batches)} steps: metrics {bad}, "
                             f"grads {grads}, "
                             f"updated parameters {flips}")
    bitwise = bool(np.array_equal(got, want)) and all(
        torch.equal(a, b) for a, b in zip(all_state(graph), all_state(eager)))
    return {"state": graph, "chunk": chunk, "counts": counts, "derived": derived,
            "max_metric_err": float(errs.max()), "grad_norm_err": grads,
            "updated_param_mismatches": flips, "bitwise": bitwise}


def time_graph_steps(state, chunk, batches) -> dict:
    """CUDA events around each call: GRAPH_TIME_CALLS calls of one step, then
    calls of GRAPH_K steps (ms a step: the call's time over K)."""
    one = [stacked([batches[i % len(batches)]]) for i in range(GRAPH_TIME_CALLS)]
    many = [stacked(batches[:GRAPH_K])] * 12
    out = {}
    for name, calls, k in (("k1", one, 1), (f"k{GRAPH_K}", many, GRAPH_K)):
        chunk(state, calls[0])
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(calls) + 1)]
        torch.cuda.synchronize()
        for i, call in enumerate(calls):
            events[i].record()
            chunk(state, call)
        events[-1].record()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) / k for a, b in zip(events, events[1:])]
        p10, p50, p90 = np.percentile(ms, [10, 50, 90]).tolist()
        out[name] = {"median_ms_per_step": p50, "p10_p90_ms_per_step": [p10, p90],
                     "mean_ms_per_step": float(np.mean(ms)), "calls": len(calls)}
    return out


GRAPH_KERNEL_NODES = (  # (a COUNTERS entry of train/graphs.py, the trace's kernel of one launch)
    (0, "attention_fwd_"), (1, "attention_bwd_reduce_kernel"), (3, "fused_block_fwd_"))


def profile_graph_steps(state, chunk, batch: dict, steps: int = 5) -> dict:
    """torch.profiler over `steps` replays: device busy share and kernel
    nodes a step, or 'not measured' if the trace holds no kernel of a graph.
    The attention kernels' nodes a replay, counted in the trace (a backward
    call ends in one reduce kernel), must equal the launches the capture
    counted, which the counters add on every replay."""
    from torch.profiler import ProfilerActivity, profile

    chunk(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            chunk(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    try:
        kernels, busy, span, by_name = device_activity(prof)
    except AssertionError:
        return {"device_busy_share": "not measured (no kernel in the trace)",
                "wall_ms_per_step": 1e3 * wall / steps}
    (captured,) = chunk.graphs.captured.values()
    traced = {}
    for index, name in GRAPH_KERNEL_NODES:
        nodes = sum(c for k, (_, c) in by_name.items() if name in k)
        traced[name] = nodes / steps
        if nodes != steps * captured.counts[index]:
            raise AssertionError(f"{steps} replays: {nodes} '{name}' kernel nodes in the trace, "
                                 f"the capture counted {captured.counts[index]} a replay")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms_per_step": 1e3 * wall / steps, "device_busy_share": busy / span,
            "traced_attention_nodes_per_replay": traced,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "kernel_nodes_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [(k[:80], t / steps / 1e3, c / steps)
                                        for k, (t, c) in top]}


def time_ctc_graph(frames: int, max_len: int, gen) -> dict:
    """One CTC call and its gradient (the step makes two: on fake and on real
    words) at the step's shapes, batch 16, as a CUDA graph: device ms and
    kernel nodes a call. First, 10 eager calls must give the same gradient
    bitwise: the padding positions all hold the blank's id, so a gradient
    added with atomics would differ from run to run."""
    from torch.profiler import ProfilerActivity, profile

    from scrabblegan_torch.ops.ctc import ctc_loss

    logits = torch.randn(TRAIN_BATCH, frames, 53, generator=gen, device="cuda",
                         requires_grad=True)
    lengths = torch.randint(1, max_len + 1, (TRAIN_BATCH,), generator=gen, device="cuda")
    labels = torch.randint(0, 52, (TRAIN_BATCH, max_len), generator=gen, device="cuda")
    labels = torch.where(torch.arange(max_len, device="cuda")[None] >= lengths[:, None], 52,
                         labels)

    def call():
        return torch.autograd.grad(ctc_loss(logits, labels, 4 * lengths - 1, lengths).sum(),
                                   logits)[0]
    first = call()
    if not all(torch.equal(first, call()) for _ in range(10)):
        raise AssertionError("the CTC's gradient differs between two calls")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    ms = cuda_ms(graph.replay, 50)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    nodes = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    return {"frames": frames, "ms_per_call": ms, "kernel_nodes_per_call": nodes or "not measured",
            "eager_grads_bitwise_over_11_calls": True}


def peak_step_memory(cfg, trees, batch, make_train_step) -> int:
    """Peak device bytes allocated over one eager step, beyond the state."""
    state = state_of(cfg, trees, "cuda")
    step = make_train_step(cfg, state.models)
    step(state, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del state, step
    torch.cuda.empty_cache()
    return peak


def check_captured_step(attention, fused_block, load_config, synthetic_batch, make_train_step,
                        make_chunked_train_step, METRIC_NAMES, step_medians: dict,
                        gen) -> dict:
    """Phase 18; returns the launches of the K = 4 replay runs (the main
    path, counts reset just before and read just after) and of the 'fused'
    replay, and {config: the median ms of a K = 1 call}."""
    from scrabblegan_torch.train.graphs import WARMUP_STEPS

    card = card_line()
    rng = np.random.default_rng(18)
    main = {"fwd": 0, "bwd": 0, "fused": 0}
    medians = {}
    for name, cfg in train_configs(load_config).items():
        kcfg = with_core(cfg, True)
        trees = fake_trees(kcfg)
        length = cfg.io.seq_len or 5
        batches = [synthetic_batch(cfg, TRAIN_BATCH, length, rng)
                   for _ in range(WARMUP_STEPS + GRAPH_K)]
        per_step = (FWD_PER_STEP, BWD_PER_STEP, 0)
        one = graph_vs_eager(kcfg, trees, batches[:WARMUP_STEPS + 1], make_train_step,
                             make_chunked_train_step, METRIC_NAMES, attention, fused_block,
                             per_step)
        del one["state"], one["chunk"]
        run = graph_vs_eager(kcfg, trees, batches, make_train_step, make_chunked_train_step,
                             METRIC_NAMES, attention, fused_block, per_step)
        state, chunk = run.pop("state"), run.pop("chunk")
        (captured,) = chunk.graphs.captured.values()
        # the main path: K = 4 replays, no capture; the counts exact under replay
        torch.cuda.synchronize()
        reset_counts(attention, fused_block)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        metrics = chunk(state, stacked(batches[WARMUP_STEPS:]))
        torch.cuda.synchronize()
        replay_peak = torch.cuda.max_memory_allocated() - base
        counts = counts_now(attention, fused_block)
        if counts != tuple(GRAPH_K * n for n in per_step) or captured.counts[:2] != per_step[:2]:
            raise AssertionError(f"{name}: {GRAPH_K} replays launched {counts}; a captured "
                                 f"step counts {captured.counts}")
        if not torch.isfinite(metrics).all():
            raise AssertionError(f"{name}: non-finite metrics under replay")
        main["fwd"] += counts[0]
        main["bwd"] += counts[1]
        times = time_graph_steps(state, chunk, batches[WARMUP_STEPS:])
        medians[name] = times["k1"]["median_ms_per_step"]
        prof = profile_graph_steps(state, chunk, stacked(batches[:1]))
        frames = 4 * (cfg.io.bucket_size if cfg.parallel.shape_mode == "padded" else length) - 1
        ctc = time_ctc_graph(frames, frames // 4 + 1, gen)
        eager_peak = peak_step_memory(kcfg, trees, batches[0], make_train_step)
        say("18 captured step", card=card, config=name, batch=TRAIN_BATCH, dataflow="nhwc1",
            k1_vs_eager={k: one[k] for k in ("max_metric_err", "grad_norm_err",
                                             "updated_param_mismatches", "bitwise")},
            k4_vs_eager={k: run[k] for k in ("max_metric_err", "grad_norm_err",
                                             "updated_param_mismatches", "bitwise")},
            tol_metrics=STEP_TOL_METRICS, tol_grads=STEP_TOL_GRAD,
            capture_call_launches_fwd_bwd_fused=run["counts"],
            warmup_steps=chunk.graphs.warmup_steps,
            replay_launches_per_step=dict(zip(("fwd", "bwd", "fused"),
                                              [c / GRAPH_K for c in counts])),
            graphs=len(chunk.graphs.captured), capture_s=captured.capture_s, pool_bytes=captured.pool_bytes,
            replay_peak_bytes_beyond_state=replay_peak,
            eager_step_peak_bytes_beyond_state=eager_peak,
            times=times, eager_median_ms_per_step_phase10=step_medians[name],
            profile=prof, ctc_graph=ctc,
            ctc_share_of_step=2 * ctc["ms_per_call"] / times["k1"]["median_ms_per_step"])
        del state, chunk, captured, run
        torch.cuda.empty_cache()

    check_shared_pool(load_config, synthetic_batch, make_train_step, make_chunked_train_step,
                      METRIC_NAMES, rng, card)

    # 'fused' and remat, on the bench config, K = 1
    cfg = train_configs(load_config)["bench bucketed len 5"]
    kcfg = with_core(cfg, True)
    trees = fake_trees(kcfg)
    batches = [synthetic_batch(cfg, TRAIN_BATCH, 5, rng) for _ in range(WARMUP_STEPS + 1)]
    with dataflow("fused"):
        fused = graph_vs_eager(kcfg, trees, batches, make_train_step, make_chunked_train_step,
                               METRIC_NAMES, attention, fused_block,
                               (FWD_PER_STEP, BWD_PER_STEP, FWD_PER_STEP))
        state, chunk = fused.pop("state"), fused.pop("chunk")
        reset_counts(attention, fused_block)
        chunk(state, stacked(batches[-1:]))
        torch.cuda.synchronize()
        fused_replay = counts_now(attention, fused_block)
        if fused_replay != (FWD_PER_STEP, BWD_PER_STEP, FWD_PER_STEP):
            raise AssertionError(f"'fused' replay launched {fused_replay}")
        main["fused"] = fused_replay[2]
        (captured,) = chunk.graphs.captured.values()
        say("18 captured step fused", card=card, config="bench bucketed len 5",
            vs_eager_fused={k: fused[k] for k in ("max_metric_err", "grad_norm_err",
                                                  "updated_param_mismatches", "bitwise")},
            replay_launches_fwd_bwd_fused=fused_replay, capture_s=captured.capture_s,
            pool_bytes=captured.pool_bytes)
        del state, chunk, captured
    rcfg = dataclasses.replace(kcfg, shared=dataclasses.replace(kcfg.shared, remat=True))
    remat = graph_vs_eager(rcfg, trees, batches, make_train_step, make_chunked_train_step,
                           METRIC_NAMES, attention, fused_block,
                           (REMAT_FWD_PER_STEP, BWD_PER_STEP, 0), ref_cfg=kcfg)
    (captured,) = remat["chunk"].graphs.captured.values()
    pool = captured.pool_bytes
    del remat["state"], remat["chunk"], captured
    torch.cuda.empty_cache()
    say("18 captured step remat", card=card, config="bench bucketed len 5",
        vs_eager_plain={k: remat[k] for k in ("max_metric_err", "grad_norm_err",
                                              "updated_param_mismatches", "bitwise")},
        launches_fwd_bwd_fused=remat["counts"], fwd_per_step=REMAT_FWD_PER_STEP,
        pool_bytes=pool,
        eager_step_peak_bytes_beyond_state={
            "plain": peak_step_memory(kcfg, trees, batches[0], make_train_step),
            "remat": peak_step_memory(rcfg, trees, batches[0], make_train_step)})
    return main, medians


def check_shared_pool(load_config, synthetic_batch, make_train_step, make_chunked_train_step,
                      METRIC_NAMES, rng, card: str) -> None:
    """Phase 18: bucketed mode with 'independent' pairing captures a graph a
    (real, fake) length pair, all in one pool. Three pairs A, B, C in turn,
    two eager warm-up steps each (A, B, C, A, B, C), then captured in turn
    (A, B, C) and replayed out of their capture order (B, A), against the
    same eleven eager steps, under cuDNN's deterministic algorithms; the
    pool bytes each capture added."""
    cfg = with_core(load_config(None, {"shared.batch_size": TRAIN_BATCH,
                                       "shared.trunk_dtype": "bfloat16",
                                       "parallel.bucket_pairing": "independent"}), True)
    # each pair's two eager warm-up steps, its capture, then replays out of order
    pairs = [(5, 5), (10, 3), (2, 8)] * 3 + [(10, 3), (5, 5)]
    batches = []
    for real, fake in pairs:
        batch = synthetic_batch(cfg, TRAIN_BATCH, real, rng)
        batch["fake_labels"] = synthetic_batch(cfg, TRAIN_BATCH, fake, rng)["fake_labels"]
        batches.append(batch)
    trees = fake_trees(cfg)
    eager, graph = state_of(cfg, trees, "cuda"), state_of(cfg, trees, "cuda")
    with deterministic_convs():
        step = make_train_step(cfg, eager.models)
        want = np.array([[float(m[n]) for n in METRIC_NAMES]
                         for m in (step(eager, b) for b in batches)])
        chunk = make_chunked_train_step(cfg, graph.models)
        reserved = [torch.cuda.memory_reserved()]
        got = []
        for b in batches:
            got.append(chunk(graph, stacked([b]))[:, 0].cpu().numpy())
            reserved.append(torch.cuda.memory_reserved())
    got = np.array(got)
    errs = np.abs(got - want)
    if (len(chunk.graphs.captured) != 3 or not np.isfinite(got).all()
            or (errs > STEP_TOL_METRICS * (1 + np.abs(want))).any()):
        raise AssertionError(f"shared pool: {len(chunk.graphs.captured)} graphs, metric "
                             f"errors {errs.max()}")
    bitwise = bool(np.array_equal(got, want)) and all(
        torch.equal(a, b) for a, b in zip(all_state(graph), all_state(eager)))
    say("18 captured step shared pool", card=card, config="bucketed, 'independent' pairing",
        batch=TRAIN_BATCH, real_fake_lengths=pairs, graphs=len(chunk.graphs.captured),
        pool_bytes_per_capture=[g.pool_bytes for g in chunk.graphs.captured.values()],
        capture_s=[g.capture_s for g in chunk.graphs.captured.values()],
        reserved_bytes_after_each_call=reserved[1:], max_metric_err=float(errs.max()),
        tol_metrics=STEP_TOL_METRICS, bitwise=bitwise)
    del eager, graph, chunk
    torch.cuda.empty_cache()


def fabricate_iam(root: Path, words: int, seed: int) -> Path:
    """A raw IAM tree: <root>/words/<form>/<line>/<id>.png, grey word images
    of random sizes, and <root>/gt/words.txt with a comment, 'err' lines and
    non-alphabetic words among alphabetic ones of 1-10 letters."""
    from scrabblegan_torch.data.images import write_grayscale

    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    lines = ["# id result graylevel components x y w h tag transcription"]
    for i in range(words):
        form = f"a{i // 100:02d}"
        line_dir = root / "words" / form / f"{form}-{i // 10 % 10:03d}"
        line_dir.mkdir(parents=True, exist_ok=True)
        wid = f"{form}-{i // 10 % 10:03d}-{i % 10:02d}"
        word = "".join(rng.choice(letters, int(rng.integers(1, 11))))
        if i % 25 == 7:
            word += "."
        h, w = int(rng.integers(24, 100)), int(rng.integers(16, 420))
        write_grayscale(str(line_dir / f"{wid}.png"),
                        rng.integers(0, 256, (h, w)).astype(np.uint8))
        lines.append(f"{wid} {'err' if i % 25 == 11 else 'ok'} 154 1 0 0 {w} {h} NN {word}")
    (root / "gt").mkdir(parents=True, exist_ok=True)
    (root / "gt" / "words.txt").write_text("\n".join(lines) + "\n")
    return root / "words"


def check_iam_campaign(attention, fused_block, data_root: Path) -> dict:
    """Phase 19: configs/iam_campaign.json (padded, EMA 0.999, 'independent'
    pairing, io.stall_timeout_s 900) through the train CLI on a raw IAM tree
    that the first run converts; style images and lexicon from phase 15.
    Cut in depth only: 1 epoch of IAM_BATCHES batches."""
    from scrabblegan_torch.config import load_config
    from scrabblegan_torch.train import loop
    from scrabblegan_torch.train import main as train_main

    config = ROOT / "configs" / "iam_campaign.json"
    cfg = load_config(str(config))
    root = OUT_DIR / "iam"
    shutil.rmtree(root, ignore_errors=True)
    raw = fabricate_iam(root / "IAM", IAM_WORDS, seed=19)
    read_dir = root / "IAM" / "words-Reading"
    workdir = root / "run"
    trainers = []
    train = loop.Trainer.train

    def recorded(trainer, *a, **k):
        trainers.append(trainer)
        return train(trainer, *a, **k)
    loop.Trainer.train = recorded
    try:
        torch.cuda.synchronize()
        reset_counts(attention, fused_block)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_main(["--device", "cuda", "--config", str(config),
                             "--workdir", str(workdir), "--epochs", "1",
                             "--batches-per-epoch", str(IAM_BATCHES),
                             "--style-dir", str(data_root / "style_imgs"),
                             "--words-file", str(data_root / "random_words.txt"),
                             "--set", f"io.raw_dir={raw}/", "--set", f"io.read_dir={read_dir}/"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now(attention, fused_block)
    finally:
        loop.Trainer.train = train
    log = out.getvalue()
    if rc != 0 or "converting dataset to GAN-Reading format" not in log:
        raise AssertionError(f"iam campaign exited {rc}:\n{log[-2000:]}")
    (trainer,) = trainers
    wd, graphs = trainer.watchdog, trainer.chunk.graphs
    converted = sum(1 for _ in read_dir.rglob("*.png"))
    heartbeat = workdir / ".heartbeat"
    gate_chunks = -(-cfg.io.export_quality_samples // cfg.shared.num_gen)
    steps = IAM_BATCHES
    derived = (steps * FWD_PER_STEP + cfg.optimizer.ema_standing_stat_batches + 1 + gate_chunks,
               steps * BWD_PER_STEP, 0)
    # one grace at the start, one a captured shape, one before the first artifacts
    if (wd is None or wd.graces != 2 + len(graphs.captured) or wd.beats < 3
            or not heartbeat.exists() or counts != derived or converted == 0):
        raise AssertionError(f"iam campaign: watchdog {wd and (wd.graces, wd.beats)}, "
                             f"graphs {len(graphs.captured)}, launches {counts} (derived "
                             f"{derived}), converted {converted}")
    rows = (workdir / "output" / "batch_summary.txt").read_text().splitlines()[1:]
    values = np.array([[float(v) for v in r.split(";")] for r in rows])
    if values.shape != (IAM_BATCHES, 16) or not np.isfinite(values).all():
        raise AssertionError(f"iam campaign summaries {values.shape}")
    say("19 iam campaign", card=card_line(), config="configs/iam_campaign.json",
        raw_words=IAM_WORDS, converted_words=converted, batches=IAM_BATCHES,
        batch=cfg.shared.batch_size, stall_timeout_s=cfg.io.stall_timeout_s,
        watchdog_beats=wd.beats, watchdog_graces=wd.graces, graphs=len(graphs.captured),
        heartbeat_age_s=time.time() - heartbeat.stat().st_mtime,
        launches_fwd_bwd_fused=counts, derived=derived, wall_s=wall,
        epoch_s=trainer.epoch_secs, artifact_secs=trainer.artifact_secs)
    return {"fwd": counts[0], "bwd": counts[1]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["SCRABBLEGAN_ATTN_DATAFLOW"] = "nhwc1"  # the 'fused' phases set it themselves
    LOG.unlink(missing_ok=True)
    from scrabblegan_torch.convert import (fake_flax_variables, generator_from_flax,
                                           save_flax_npz)
    from scrabblegan_torch.infer import main as infer_main
    from scrabblegan_torch.kernels import attention, build, fused_block
    from scrabblegan_torch.models.build import load_config, noise_config
    from scrabblegan_torch.train import main as train_main
    from scrabblegan_torch.data.synthetic import synthetic_batch
    from scrabblegan_torch.train.step import (METRIC_NAMES, make_chunked_train_step,
                                              make_train_step)

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say("1 device", name=name, nvidia_smi=card, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, max_sm_clock_mhz=sm_clock_hz() / 1e6,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)

    # 2. build
    t0 = time.perf_counter()
    lib = build.load_library()
    build_s = time.perf_counter() - t0
    tiles = (lib.attention_fwd_key_tile(), lib.attention_fwd_key_chunk(),
             lib.attention_fwd_warp_queries(), lib.fused_block_fwd_key_tile(),
             lib.fused_block_fwd_channels(), lib.attention_bwd_warps(),
             lib.attention_bwd_warp_rows(), lib.attention_bwd_keys(),
             lib.attention_bwd_query_tile(), lib.attention_bwd_stats_blocks_per_sm(),
             lib.attention_bwd_grads_blocks_per_sm(),
             lib.attention_bwd_parts(0), lib.attention_bwd_reg_parts(0),
             lib.attention_bwd_parts(1), lib.attention_bwd_reg_parts(1))
    if tiles != (attention.KEY_TILE, attention.KEY_CHUNK, attention.WARP_QUERIES,
                 attention.KEY_TILE, fused_block.KERNEL_C, attention.BWD_WARPS,
                 attention.BWD_WARP_ROWS, attention.BWD_KEYS, attention.BWD_QUERY_TILE,
                 attention.BWD_STATS_BLOCKS_PER_SM, attention.BWD_GRADS_BLOCKS_PER_SM,
                 attention.BWD_PARTS[torch.float32], attention.BWD_REG_PARTS[torch.float32],
                 attention.BWD_PARTS[torch.bfloat16], attention.BWD_REG_PARTS[torch.bfloat16]):
        raise AssertionError(f"kernel constants {tiles} differ from the CPU emulations'")
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say("2 build", seconds=build_s, ptxas=ptxas)

    # 3. kernel vs plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = check_kernel(attention, gen)

    # 11. the fused kernel vs its plain version
    fused_err = check_fused_kernel(fused_block, gen)

    # 4. the generator at full width through the kernel
    cfg = noise_config(None, {"shared.dtype": "bfloat16"})
    variables = fake_flax_variables(cfg, seed=0)
    g = generator_from_flax(variables, cfg, "cuda")
    feeds = {n: make_inputs(BATCH, n, gen) for n in LENGTHS}
    torch.cuda.synchronize()
    reset_counts(attention, fused_block)
    with torch.inference_mode():
        images = {n: g(*feeds[n]) for n in LENGTHS}
        torch.cuda.synchronize()
    main_path_launches = attention.launches
    if (main_path_launches, fused_block.launches) != (len(LENGTHS), 0):
        raise AssertionError(f"{main_path_launches} kernel launches for {len(LENGTHS)} forwards")
    for n in LENGTHS:
        check_images(images[n], BATCH, n)
    say("4 generator", batch=BATCH, lengths=LENGTHS, launches=main_path_launches,
        dtype="bfloat16", images_std={n: images[n].float().std().item() for n in LENGTHS})

    with torch.inference_mode():
        for n in LENGTHS:
            labels, z = feeds[n][0][:16], feeds[n][1][:16]
            g.attn_B3.use_kernel = False
            plain = g(labels, z).float()
            g.attn_B3.use_kernel = True
            err = check_close(f"generator kernel vs plain at len {n}", g(labels, z),
                              plain, G_TOL_PLAIN)
            say("4 generator kernel-vs-plain", length=n, batch=16, max_abs_err=err,
                tol=G_TOL_PLAIN)

        cfg32 = noise_config(None, {"shared.dtype": "float32"})
        labels, z = make_inputs(2, 3, gen)
        on_card = generator_from_flax(variables, cfg32, "cuda")(labels, z).cpu()
        on_cpu = generator_from_flax(variables, cfg32, "cpu")(labels.cpu(), z.cpu())
        err = check_close("generator on the card vs the CPU", on_card, on_cpu, G_TOL_CPU)
        say("4 generator card-vs-cpu", dtype="float32", batch=2, length=3,
            max_abs_err=err, tol=G_TOL_CPU)

        cfg_pad = noise_config(None, {"shared.dtype": "bfloat16",
                                      "parallel.shape_mode": "padded"})
        g_pad = generator_from_flax(fake_flax_variables(cfg_pad, seed=1), cfg_pad, "cuda")
        labels, z = make_inputs(BATCH, 10, gen)
        lengths = torch.randint(1, 11, (BATCH,), generator=gen, device="cuda")
        pad = torch.arange(10, device="cuda")[None, :] >= lengths[:, None]
        labels = torch.where(pad, torch.full_like(labels, 52), labels)
        before = attention.launches
        out = g_pad(labels, z, lengths)
        check_images(out, BATCH, 10)
        cols = torch.arange(160, device="cuda")[None, None, None, :]
        padded_cols = (cols >= 16 * lengths[:, None, None, None]).expand_as(out)
        if not bool((out[padded_cols] == 1).all()) or attention.launches != before + 1:
            raise AssertionError("padded mode: white-out or launch count wrong")
        say("4 generator padded", batch=BATCH, length=10,
            white_fraction=padded_cols.float().mean().item())

    # 5. serve through the CLI
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    weights = OUT_DIR / "g.npz"
    save_flax_npz(str(weights), variables)
    for word in ("machinelearning", "cab", "Hopper"):
        out_path = OUT_DIR / f"{word}.npy"
        before = attention.launches
        infer_main(["--weights", str(weights), "--word", word, "-n", "8", "--device", "cuda",
                    "--out", str(out_path), "--set", "shared.dtype=bfloat16"])
        served = np.load(out_path)
        if (served.shape != (8, 32, 16 * len(word), 1) or not np.isfinite(served).all()
                or np.abs(served).max() > 1.0 or attention.launches != before + 1):
            raise AssertionError(f"served {word!r}: {served.shape}")
        say("5 serve", word=word, npy=str(out_path.relative_to(ROOT)), shape=served.shape)

    # 6. times
    core_ms = {}
    with torch.inference_mode():
        for n, plain_batch in ((5, BATCH), (10, BATCH // 2)):
            q, k = 512 * n, 128 * n
            ops = b3_operands(BATCH, q, k, torch.bfloat16, gen)
            kernel_ms = cuda_ms(lambda: attention.nonlocal_attention_packed(*ops), 10)
            small = tuple(t[:plain_batch] for t in ops)
            kernel_small_ms = cuda_ms(lambda: attention.nonlocal_attention_packed(*small), 10)
            plain_ms = cuda_ms(lambda: attention.attention_reference(*small), 5)
            core_ms[n] = (kernel_ms, plain_ms)
            bound_ms, bound_by = core_bound(BATCH, q, k, torch.bfloat16, backward=False)
            say("6 time attention core", card=card, dtype="bfloat16", length=n, q=q, k=k,
                kernel_ms_batch1024=kernel_ms, kernel_ms=kernel_small_ms, plain_ms=plain_ms,
                batch_compared=plain_batch, bound_ms_batch1024=bound_ms, bound_by=bound_by)
            del ops, small
            # float32 operands (G's B3 in the train step) stay on the CUDA cores
            ops = b3_operands(TRAIN_BATCH, q, k, torch.float32, gen)
            fops = fused_operands(TRAIN_BATCH, q, k, torch.float32, gen)
            bound_ms, bound_by = core_bound(TRAIN_BATCH, q, k, torch.float32, backward=False)
            say("6 time attention core", card=card, dtype="float32", length=n, q=q, k=k,
                batch=TRAIN_BATCH,
                kernel_ms=cuda_ms(lambda: attention.nonlocal_attention_packed(*ops), 10),
                plain_ms=cuda_ms(lambda: attention.attention_reference(*ops), 5),
                fused_kernel_ms=cuda_ms(lambda: fused_block._launch_fused(*fops), 10),
                fused_plain_ms=cuda_ms(lambda: fused_block.fused_block_reference(*fops), 5),
                bound_ms=bound_ms, bound_by=bound_by)
            del ops, fops
        for n in LENGTHS:
            labels, z = feeds[n]
            ms = cuda_ms(lambda: g(labels, z), 10, warmup=2)
            say("6 time generator", card=card, dtype="bfloat16", length=n, batch=BATCH,
                core="kernel", ms_per_batch=ms, images_per_s=BATCH / ms * 1e3)
        labels, z = feeds[5]
        g.attn_B3.use_kernel = False
        ms = cuda_ms(lambda: g(labels, z), 10, warmup=2)
        g.attn_B3.use_kernel = True
        say("6 time generator", card=card, dtype="bfloat16", length=5, batch=BATCH,
            core="plain", ms_per_batch=ms, images_per_s=BATCH / ms * 1e3)
    profile_generator(g, feeds, card)

    # 12. G serving under 'fused', and its times
    fused_serving = serve_fused(g, feeds, images, attention, fused_block)
    fused_ms = time_fused(g, feeds, fused_block, attention, gen, card)
    del images

    # 7. the backward kernel vs the plain backward
    bwd_err = check_backward_kernel(attention, gen)

    # 8. the train step at full width; the counts are reset just before each
    # configuration's kernel-path run and read just after it
    runs, train_launches = check_train_step(attention, load_config, synthetic_batch,
                                            make_train_step, METRIC_NAMES)
    check_train_step_card_vs_cpu(load_config, synthetic_batch, make_train_step, METRIC_NAMES)

    # 13. the train step under 'fused'
    fused_train = check_train_step_fused(attention, fused_block, load_config, synthetic_batch,
                                         make_train_step, METRIC_NAMES)

    # 9. the train CLI and the served export
    check_train_cli(attention, train_main, infer_main)

    # 14. the workdir CLI under 'fused': checkpoints, resume, the export served
    fused_cli = check_workdir_cli(attention, fused_block, train_main, infer_main, load_config)

    # 10. times
    bwd_rows = time_backward(attention, lib, gen, card)
    step_medians = time_train_steps(runs, make_train_step, card)
    profile_train_steps(runs, make_train_step, card)
    del runs
    torch.cuda.empty_cache()

    # 18. the captured train step: graphs against the eager step, counts, times
    graph_launches, graph_medians = check_captured_step(attention, fused_block, load_config, synthetic_batch,
                                         make_train_step, make_chunked_train_step,
                                         METRIC_NAMES, step_medians, gen)

    # 15. the data path: the synthetic data set written, read and loaded
    data_root, style_pngs = check_data(OUT_DIR)

    # 16. the epoch Trainer through the train CLI, then resumed
    trainer_dir = OUT_DIR / "trainer"
    trainer_launches = check_trainer(attention, fused_block, trainer_dir,
                                     step_medians["recommended (padded)"],
                                     graph_medians["recommended (padded)"])

    # 17. evaluate, the style-source infer, style-z G under both dataflows
    serve_launches = check_evaluate_and_serve(attention, fused_block, trainer_dir, style_pngs,
                                              gen)

    # 19. the real-data campaign config: raw IAM converted, trained with the watchdog
    iam_launches = check_iam_campaign(attention, fused_block, data_root)

    kernel_ms, plain_ms = core_ms[5]  # the same shape: batch 1024
    bwd_row = bwd_rows[("G B3 len 5", torch.float32, TRAIN_BATCH)]
    bwd_b1 = bwd_rows[("D/W B1 len 5", torch.bfloat16, TRAIN_BATCH)]
    fused_kernel_ms, fused_plain_ms = fused_ms[5]
    rows = [
        {"name": "attention_fwd", "route": "cuda",
         "source": "scrabblegan_torch/csrc/attention_fwd.cu",
         "replaces": "scrabblegan_tpu/kernels/attention.py:111",
         "launches": graph_launches["fwd"], "eager_step_launches": train_launches["fwd"],
         "serving_launches": main_path_launches, "iam_campaign_launches": iam_launches["fwd"],
         "trainer_launches": trainer_launches["fwd"],
         "evaluate_launches": serve_launches["evaluate"],
         "infer_style_launches": serve_launches["infer"],
         "style_serving_launches": serve_launches["style_nhwc1"],
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
         "shape": "G B3 len 5, batch 1024, bf16",
         **dict(zip(("bound_ms", "bound_by"), core_bound(BATCH, 2560, 640, torch.bfloat16,
                                                         backward=False))),
         "library_ms": fused_ms["library_fwd"]},
        {"name": "attention_bwd", "route": "cuda",
         "source": "scrabblegan_torch/csrc/attention_bwd.cu",
         "replaces": "scrabblegan_tpu/kernels/attention.py:195",
         "launches": graph_launches["bwd"], "eager_step_launches": train_launches["bwd"],
         "trainer_launches": trainer_launches["bwd"],
         "iam_campaign_launches": iam_launches["bwd"],
         "max_abs_err": bwd_err,
         "shape": "G B3 len 5, batch 16, f32", "ms": bwd_row["kernel_ms"],
         **{key: bwd_row[key] for key in ("plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "device_ms", "floor_ms")},
         "d_w_b1_len_5_batch_16_bf16": {key: bwd_b1[key] for key in (
             "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
             "floor_ms")}},
        {"name": "fused_block_fwd", "route": "cuda",
         "source": "scrabblegan_torch/csrc/fused_block_fwd.cu",
         "replaces": "scrabblegan_tpu/kernels/attention.py:333",
         "launches": graph_launches["fused"], "eager_step_launches": fused_train,
         "serving_launches": fused_serving,
         "cli_launches": fused_cli, "style_serving_launches": serve_launches["style_fused"],
         "max_abs_err": max(fused_err.values()),
         "max_abs_err_by_dtype": fused_err, "ms": fused_kernel_ms, "plain_ms": fused_plain_ms,
         "shape": "G B3 len 5, batch 1024, bf16",
         **dict(zip(("bound_ms", "bound_by"), fused_bound(BATCH, 2560, 640, torch.bfloat16))),
         "library_ms": None}]
    print(json.dumps({"kernels": rows}))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "scrabblegan_tpu", "cv2", "PIL",
        "matplotlib", "imageio"))
    if loaded:
        raise AssertionError(f"JAX, the JAX package or an image library was imported: "
                             f"{loaded[:5]}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

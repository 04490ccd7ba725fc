"""Throughput harness of the port: the twin of the root bench.py.

    python -m scrabblegan_torch.bench [--device cuda]

Runs bench.py's five sections in its order and prints its JSON line on
stdout after each one, each a superset of the last (everything else goes to
stderr):
  {"metric": "word_images_per_sec_per_chip", "value": N, "unit": "images/s",
   "vs_baseline": N / 5000, "extra": {...}}

1. inference at len 5: G (noise z, bf16, batch 1024; BASELINE config 1) on
   seeded fake weights, images/s of the best of 3 timed runs of `iters`
   forwards;
2. the train step at len 5: `trainer_cfg(5)`, batch 16, seeded fake
   weights, uint8 batches, the chunked step as the Trainer runs it (CUDA
   graphs on a card, train/graphs.py), steps/s of the best of 3 windows of
   30 steps;
3. the e2e Trainer on a synthetic data set at the same config, steps/s of
   its best warm epoch (checkpoints and the gate off);
4. inference at len 10;
5. the train step at len 10.
The times are CUDA events after a warm-up (the host clock on the CPU).
Each `mfu_*` key is the share of 989 TFLOP/s, the H100 SXM's bf16 dense
peak, of the FLOPs `utils/flops.py` counts at this run's shapes (JAX's 197
TFLOP/s was a TPU v5e's peak). `extra.card` is nvidia-smi's name and power
limit. SCRABBLEGAN_BENCH_BUDGET_S (default 840) skips a later section when
the seconds left fall below its cost guard; the line printed last holds
what was measured. Numbers are printed unrounded. `run` and the section
functions take the batch and the length, so a test can run them small on
the CPU; the flags cut the depth only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BASELINE_IMAGES_PER_SEC = 5000.0  # BASELINE.json's north-star target
PEAK_FLOPS = 989e12               # H100 SXM, bf16 dense
BUDGET_S = float(os.environ.get("SCRABBLEGAN_BENCH_BUDGET_S", "840"))
COST_GUARD_S = {"train5": 60.0, "e2e": 120.0, "inf10": 30.0, "train10": 60.0}


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str | None:
    """nvidia-smi's name and power limit, or None without a card."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


class Timer:
    """Seconds of the work between `start` and `stop`: CUDA events on a card
    (after the queue drains), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.begin.elapsed_time(self.end) / 1e3
        return time.perf_counter() - self.t0


def trainer_cfg(length: int, batch: int = 16):
    """bench.py's `_trainer_cfg`: the recommended throughput configuration
    (bf16 trunks) at batch 16, words of `length` characters."""
    from scrabblegan_torch.config import load_config

    return load_config(None, {"shared.batch_size": batch, "io.seq_len": length,
                              "shared.num_gen": 4, "shared.trunk_dtype": "bfloat16"})


def fake_state(cfg, device, seed: int = 0):
    """A train state on seeded fake weights (`convert.fake_flax_variables`)."""
    from scrabblegan_torch.convert import fake_flax_variables, state_from_flax

    nets = {"g": "generator", "d": "discriminator", "r": "recognizer", "w": "style_promoter"}
    trees = {n: fake_flax_variables(cfg, seed, name) for n, name in nets.items()}
    return state_from_flax(cfg, {n: t["params"] for n, t in trees.items()},
                           {n: t.get("batch_stats", {}) for n, t in trees.items()}, device)


def bench_inference(length: int, iters: int, batch: int = 1024,
                    device: str | torch.device = "cuda") -> dict:
    """Section 1 or 4: {'images_per_sec', 'flops' (one batch's forward),
    'mfu'}."""
    from scrabblegan_torch import resolve_device
    from scrabblegan_torch.convert import fake_flax_variables, generator_from_flax
    from scrabblegan_torch.models.build import noise_config
    from scrabblegan_torch.utils.flops import matmul_flops

    device = resolve_device(device)
    cfg = noise_config(None, {"shared.batch_size": batch, "shared.dtype": "bfloat16"})
    g = generator_from_flax(fake_flax_variables(cfg, seed=0), cfg, device)
    gen = torch.Generator().manual_seed(0)
    labels = torch.zeros((batch, length), dtype=torch.long).to(device)
    z = torch.randn((batch, cfg.shared.latent_dim), generator=gen).to(device)
    with torch.no_grad():
        flops = matmul_flops(g, labels, z)
    timer = Timer(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        g(labels, z)  # the kernels' build and cuDNN's choices
        best = None
        for rep in range(3):
            timer.start()
            for _ in range(iters):
                g(labels, z)
            dt = timer.stop()
            log(f"len {length} rep {rep}: {iters} fwd in {dt:.3f}s -> "
                f"{batch * iters / dt:,.0f} img/s")
            best = dt if best is None else min(best, dt)
    images_per_sec = batch * iters / best
    mfu = images_per_sec * (flops / batch) / PEAK_FLOPS
    log(f"len {length}: {flops / batch / 1e9:.2f} GFLOP/img -> share {mfu:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"images_per_sec": images_per_sec, "flops": flops, "mfu": mfu}


def uint8_batch(batch: int, length: int, seed: int = 0) -> dict:
    """bench.py's wire batch: uint8 images, int32 labels."""
    rng = np.random.default_rng(seed)
    return {
        "real_imgs": rng.integers(0, 256, (batch, 32, 16 * length, 1)).astype(np.uint8),
        "real_labels": rng.integers(0, 52, (batch, length)).astype(np.int32),
        "style_imgs": rng.integers(0, 256, (batch, 32, 160, 1)).astype(np.uint8),
        "fake_labels": rng.integers(0, 52, (batch, length)).astype(np.int32),
    }


def bench_train_step(length: int, batch: int = 16, steps: int = 30, windows: int = 3,
                     device: str | torch.device = "cuda") -> dict:
    """Section 2 or 5: {'steps_per_sec', 'flops' (one step, forward and
    backward), 'mfu'} of the chunked step the Trainer runs, one step a call,
    each call's state the last one's. With graphs, three untimed calls
    first: a graph's two eager warm-up steps and its capture."""
    from scrabblegan_torch import resolve_device
    from scrabblegan_torch.train.step import make_chunked_train_step, make_train_step
    from scrabblegan_torch.utils.flops import matmul_flops

    device = resolve_device(device)
    cfg = trainer_cfg(length, batch)
    state = fake_state(cfg, device)
    one = uint8_batch(batch, length)
    flops = matmul_flops(make_train_step(cfg, state.models), state, one)
    chunk = make_chunked_train_step(cfg, state.models)
    stacked = {k: torch.from_numpy(v[None]) for k, v in one.items()}
    if device.type == "cuda":
        stacked = {k: v.pin_memory() for k, v in stacked.items()}
    t0 = time.perf_counter()
    for _ in range(3 if chunk.graphs is not None else 0):
        chunk(state, stacked)
    log(f"len {length}: train step build, warm-up and capture: {time.perf_counter() - t0:.1f}s")
    timer, best = Timer(device), None
    for _ in range(windows):
        timer.start()
        for _ in range(steps):
            out = chunk(state, stacked)
        float(out[0, 0])  # the last step depends on every earlier state
        dt = timer.stop()
        best = dt if best is None else min(best, dt)
    rate = steps / best
    mfu = rate * flops / PEAK_FLOPS
    log(f"len {length}: {steps} train steps in {best:.3f}s -> {rate:.2f} steps/s "
        f"(batch {batch}), {flops / 1e9:.1f} GFLOP/step, share {mfu:.4f}")
    return {"steps_per_sec": rate, "flops": flops, "mfu": mfu}


def bench_trainer_e2e(batch: int = 16, batches_per_epoch: int = 250, epochs: int = 3,
                      device: str | torch.device = "cuda", workdir: str | None = None) -> float:
    """Section 3: the Trainer's best warm epoch, steps/s (epoch 1 pays the
    build and the capture), on a synthetic data set at trainer_cfg(5), with
    no checkpoint and no gate."""
    from scrabblegan_torch.data.synthetic import make_synthetic_dataset
    from scrabblegan_torch.train.loop import Trainer

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="scrabblegan_bench_e2e.")
    try:
        cfg = trainer_cfg(5, batch)
        cfg = dataclasses.replace(cfg, io=dataclasses.replace(
            cfg.io, ckpt_every=0, export_quality_samples=0))
        read_dir, words_file, style_dir = make_synthetic_dataset(
            os.path.join(workdir, "data"), samples_per_bucket=64, bucket_size=5)
        trainer = Trainer(cfg, workdir=workdir, verbose=False, device=device)
        trainer.load_data(read_dir=read_dir, style_dir=style_dir, words_file=words_file)
        t0 = time.perf_counter()
        trainer.train(epochs=epochs, batches_per_epoch=batches_per_epoch, resume=False)
        warm = trainer.epoch_secs[1:]
        rate = batches_per_epoch / min(warm)
        log(f"e2e {epochs} epochs in {time.perf_counter() - t0:.1f}s; warm epochs "
            f"{[round(s, 2) for s in warm]}s -> best {rate:.2f} steps/s")
        return rate
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def run(device: str | torch.device = "cuda", inference_batch: int = 1024, train_batch: int = 16,
        iters: tuple[int, int] = (50, 30), train_steps: int = 30, windows: int = 3,
        e2e_batches: int = 250, e2e_epochs: int = 3) -> None:
    """The five sections in bench.py's order, the JSON line after each."""
    t_start = time.monotonic()  # the budget counts from the run's start
    device = torch.device(device)
    result = {"metric": "word_images_per_sec_per_chip", "value": None, "unit": "images/s",
              "vs_baseline": None, "extra": {
                  "card": card_line(), "peak_tflops": PEAK_FLOPS / 1e12,
                  "inference_batch": inference_batch, "train_batch": train_batch}}
    extra = result["extra"]

    def emit() -> None:
        print(json.dumps(result), flush=True)

    def skip(name: str) -> bool:
        left = BUDGET_S - (time.monotonic() - t_start)
        if left < COST_GUARD_S[name]:
            log(f"SKIP section {name}: {left:.0f}s left < cost guard {COST_GUARD_S[name]:.0f}s "
                f"(budget {BUDGET_S:.0f}s)")
            return True
        return False

    inf5 = bench_inference(5, iters[0], inference_batch, device)
    result["value"] = inf5["images_per_sec"]
    result["vs_baseline"] = inf5["images_per_sec"] / BASELINE_IMAGES_PER_SEC
    extra.update(mfu_inference_len5=inf5["mfu"], flops_inference_len5=inf5["flops"])
    emit()
    if not skip("train5"):
        tr5 = bench_train_step(5, train_batch, train_steps, windows, device)
        extra.update(train_steps_per_sec_batch16=tr5["steps_per_sec"], mfu_train_len5=tr5["mfu"],
                     flops_train_len5=tr5["flops"])
        emit()
    if not skip("e2e"):
        e2e = bench_trainer_e2e(train_batch, e2e_batches, e2e_epochs, device)
        extra["train_steps_per_sec_e2e"] = e2e
        raw = extra.get("train_steps_per_sec_batch16")
        if raw:
            extra["e2e_over_raw"] = e2e / raw
        emit()
    if not skip("inf10"):
        inf10 = bench_inference(10, iters[1], inference_batch, device)
        extra.update(images_per_sec_len10=inf10["images_per_sec"],
                     mfu_inference_len10=inf10["mfu"], flops_inference_len10=inf10["flops"])
        emit()
    if not skip("train10"):
        tr10 = bench_train_step(10, train_batch, train_steps, windows, device)
        extra.update(train_steps_per_sec_len10=tr10["steps_per_sec"], mfu_train_len10=tr10["mfu"],
                     flops_train_len10=tr10["flops"])
        emit()
    log(f"bench done in {time.monotonic() - t_start:.0f}s (budget {BUDGET_S:.0f}s)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The port's throughput harness (bench.py's twin).")
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, nargs=2, default=(50, 30), metavar=("LEN5", "LEN10"),
                   help="forwards a timed run at len 5 and len 10")
    p.add_argument("--train-steps", type=int, default=30, help="steps a timed window")
    p.add_argument("--windows", type=int, default=3, help="timed windows a train section")
    p.add_argument("--e2e-batches", type=int, default=250, help="batches an epoch")
    p.add_argument("--e2e-epochs", type=int, default=3)
    args = p.parse_args(argv)
    run(args.device, iters=tuple(args.iters), train_steps=args.train_steps,
        windows=args.windows, e2e_batches=args.e2e_batches, e2e_epochs=args.e2e_epochs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

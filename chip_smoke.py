#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (written for an H100).

Drives the port's serving path, the generator from (labels, z) to word images
at the full widths of the repo's generator (vocab 52, filter bank (32, 8192),
channels 512/256/128/64, bf16, noise z), with random weights made from a
seed, through the hand-written attention CUDA kernel. Phases, one line each:

1. device: a CUDA card is required; its name and power limit (nvidia-smi);
2. build: nvcc builds scrabblegan_torch/csrc for sm_90a; build seconds;
3. kernel vs plain core at G's B3 shapes (Q = 512L, K = 128L for L = 1, 5, 10,
   and a ragged Q = 300, K = 75), float32 within 1e-4 and bfloat16 within
   2e-2 (absolute plus relative), the tolerances of the JAX kernel's tests;
4. the generator at batch 1024, len 5 and len 10, through the kernel: one
   launch per forward; finite images in [-1, 1]; agreement with the same
   generator on the plain core at batch 16 (bf16, 2e-2) and with the CPU
   port at batch 2 (float32, 1e-3); padded mode's white-out;
5. serve: scrabblegan_torch.infer.main on an .npz of those weights;
6. times (CUDA events after a warm-up): kernel and plain core at B3, and the
   generator's images/s, each printed with the card's name and power limit.

Then one JSON line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and the exit code is
non-zero; without a card the script exits non-zero before any result.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"
BATCH = 1024
LENGTHS = (5, 10)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
G_TOL_PLAIN = 2e-2  # bf16 images, kernel vs plain core, through the layers after B3
G_TOL_CPU = 1e-3    # f32 images, card vs CPU; cuDNN may pick Winograd or FFT convs


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    """Phase 3: kernel vs plain at G's B3 shapes; returns the largest error."""
    worst = 0.0
    cases = [(512 * n, 128 * n) for n in (1, 5, 10)] + [(300, 75)]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from scrabblegan_torch.convert import (fake_flax_variables, generator_from_flax,
                                           save_flax_npz)
    from scrabblegan_torch.infer import main as infer_main
    from scrabblegan_torch.kernels import attention, build
    from scrabblegan_torch.models.build import noise_config

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say("1 device", name=name, nvidia_smi=card, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    lib = build.load_library()
    build_s = time.perf_counter() - t0
    tiles = (lib.attention_fwd_key_tile(), lib.attention_fwd_key_chunk())
    if tiles != (attention.KEY_TILE, attention.KEY_CHUNK):
        raise AssertionError(f"kernel tiles {tiles} differ from the CPU emulation's")
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say("2 build", seconds=build_s, ptxas=ptxas)

    # 3. kernel vs plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = check_kernel(attention, gen)

    # 4. the generator at full width through the kernel
    cfg = noise_config(None, {"shared.dtype": "bfloat16"})
    variables = fake_flax_variables(cfg, seed=0)
    g = generator_from_flax(variables, cfg, "cuda")
    feeds = {n: make_inputs(BATCH, n, gen) for n in LENGTHS}
    torch.cuda.synchronize()
    attention.launches = 0
    with torch.inference_mode():
        images = {n: g(*feeds[n]) for n in LENGTHS}
        torch.cuda.synchronize()
    main_path_launches = attention.launches
    if main_path_launches != len(LENGTHS):
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
            say("6 time attention core", card=card, dtype="bfloat16", length=n, q=q, k=k,
                kernel_ms_batch1024=kernel_ms, kernel_ms=kernel_small_ms, plain_ms=plain_ms,
                batch_compared=plain_batch)
            del ops, small
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

    kernel_ms, plain_ms = core_ms[5]  # the same shape: batch 1024
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "scrabblegan_torch/csrc/attention_fwd.cu",
        "replaces": "scrabblegan_tpu/kernels/attention.py:111",
        "launches": main_path_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax"))
    if loaded:
        raise AssertionError(f"JAX modules were imported: {loaded[:5]}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

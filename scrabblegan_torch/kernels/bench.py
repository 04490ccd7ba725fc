"""Build the kernels, hold them to their plain versions and time them on one
CUDA card: the quick loop for work on `csrc/`, a minute or two.

    python -m scrabblegan_torch.kernels.bench [--quick] [--no-check] [--only fwd|bwd]
                                              [--iters N] [--csrc DIR]

Prints one JSON line per result: the card (nvidia-smi's name and power
limit) and ptxas' registers and shared memory per kernel; then
- forward (`--only fwd`): the largest error of the attention forward kernel
  and of the fused-block kernel against their plain versions (float32 within
  1e-4 / 5e-4, bfloat16 within 2e-2 / 1e-1, absolute plus relative, at G's B3
  and D's B1 shapes and at shapes that stress the staging: K not a multiple
  of 8, K just past a key tile, ragged Q), and their times by CUDA events at
  G's B3 shapes (len 5 and 10; bfloat16 at batch 1024, float32 at batch 16
  and 256) beside the plain versions' and `F.scaled_dot_product_attention`'s
  (scale 1, a yardstick only);
- backward (`--only bwd`): the largest error of the backward kernels against
  the plain backward at the same shapes and at batch 1 (float32 within 2e-4,
  bfloat16 within 2e-2), two runs bitwise equal, and their times at D's and
  W's B1 (len 5 and 10; bfloat16, batch 16 and 256) and G's B3 (len 5 and
  10; float32 at batch 16 and 256, bfloat16 at 256 and 1024) with the plan
  and the grids of the two main kernels, beside the plain backward, the
  library's backward (`torch.autograd.grad` through
  `F.scaled_dot_product_attention`, a yardstick only) and the floor: as many
  empty launches as the call makes.
A kernel that disagrees raises. `--quick` checks and times bfloat16 only
(the backward also float32 at batch 16), without the plain versions and the
library calls. `--csrc DIR` builds the kernels from another copy of the
sources, so that two versions of a kernel can be timed in one call on one
card: run the script once per copy (`--no-check` times a copy that is wrong
on purpose, to see what one part of a kernel costs). To time another
checkout's kernels and wrappers with this script (an earlier commit beside
the working tree, in one call), run the file by its path with that checkout
first on the module path: `PYTHONPATH=other/checkout python3
scrabblegan_torch/kernels/bench.py --no-check`; what that tree lacks (a plan,
the floor) is left out of its lines. chip_smoke.py runs the same checks
inside the whole port; this script is for iterating on a kernel.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from scrabblegan_torch.kernels import attention, build, fused_block

CORE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FUSED_TOL = {torch.float32: 5e-4, torch.bfloat16: 1e-1}
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SHAPES = [(512, 128), (2560, 640), (5120, 1280), (128, 32), (640, 160), (1280, 320),
          (300, 75), (640, 75), (640, attention.KEY_TILE + 8), (72, attention.KEY_TILE + 1)]


def say(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def max_err(what: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    if not bool((diff <= tol + tol * ref.abs()).all()):
        raise AssertionError(f"{what}: max abs error {diff.max().item()} beyond tol {tol}")
    return diff.max().item()


def core_operands(batch, q, k, dtype, gen):
    return [torch.randn(batch, c, n, generator=gen, device="cuda").to(dtype)
            for c, n in ((8, q), (8, k), (32, k))]


def fused_operands(batch, n, k, dtype, gen):
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
    return [rnd(batch, 64, n), rnd(64, 8, scale=0.2), rnd(batch, 8, k), rnd(batch, 32, k),
            rnd(32, 64, scale=0.2)]


def check(gen, dtypes) -> None:
    for dtype in dtypes:
        for q, k in SHAPES:
            ops = core_operands(3, q, k, dtype, gen)
            err = max_err(f"core q={q} k={k} {dtype}", attention._launch_kernel(*ops),
                          attention.attention_reference(*ops), CORE_TOL[dtype])
            # channel slices of a wider, batch-strided projection, as the block passes them
            wide = torch.randn(3, 48, k, generator=gen, device="cuda").to(dtype)
            sliced = [ops[0], wide[:, :8], wide[:, 8:40]]
            err_s = max_err(f"core (sliced) q={q} k={k} {dtype}",
                            attention._launch_kernel(*sliced),
                            attention.attention_reference(*sliced), CORE_TOL[dtype])
            fops = fused_operands(3, q, k, dtype, gen)
            ferr = max_err(f"fused n={q} k={k} {dtype}", fused_block._launch_fused(*fops),
                           fused_block.fused_block_reference(*fops), FUSED_TOL[dtype])
            torch.cuda.synchronize()
            say("check", dtype=str(dtype), q=q, k=k, core_max_abs_err=max(err, err_s),
                fused_max_abs_err=ferr)


def check_backward(gen, dtypes) -> None:
    for dtype in dtypes:
        for batch, q, k in [(3, q, k) for q, k in SHAPES] + [(1, 640, 160), (1, 72, 40)]:
            ops = core_operands(batch, q, k, dtype, gen)
            ops.append(torch.randn(batch, 32, q, generator=gen, device="cuda").to(dtype))
            got = attention._launch_backward(*ops)
            again = attention._launch_backward(*ops)
            ref = attention.attention_backward_reference(*ops)
            torch.cuda.synchronize()
            errs = [max_err(f"backward {name} b={batch} q={q} k={k} {dtype}", g, r, BWD_TOL[dtype])
                    for name, g, r in zip(("dtheta", "dphi", "dg"), got, ref)]
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"backward b={batch} q={q} k={k} {dtype}: two runs differ")
            say("check backward", dtype=str(dtype), batch=batch, q=q, k=k, max_abs_err=errs,
                deterministic=True)


def device_ms_by_kernel(fn, calls: int = 5) -> dict:
    """Device milliseconds a launch by kernel name, from a profiler trace of
    `calls` calls of fn, which launches each of its kernels once: what the
    card spends, whatever the host's pace. The mean over the launches the
    trace holds (it may drop some), not their sum over `calls`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"(\w+)(<[^(]*)?\(", e.name.replace("(anonymous namespace)::", ""))
            t = total.setdefault(name.group(1) if name else e.name, [0.0, 0])
            t[0] += (e.time_range.end - e.time_range.start) / 1e3
            t[1] += 1
    return {name: t / count for name, (t, count) in total.items()}


def backward_grids(batch: int, q: int, k: int) -> dict:
    """The plan and the blocks it gives the statistics and the gradient kernel
    (nothing for a tree whose backward has no plan)."""
    if not hasattr(attention, "backward_plan"):
        return {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = attention.backward_plan(batch, q, k, sms)
    stats = -(-q // (attention.BWD_WARP_ROWS * plan["query_warps"])) * batch
    return dict(plan, stats_blocks=stats,
                grads_blocks=plan["key_tiles"] * plan["query_splits"] * batch)


def library_backward_ms(ops, iters: int) -> float:
    """`torch.autograd.grad` through F.scaled_dot_product_attention (scale 1)
    on thetaT, phiT, gT, doutT: a yardstick only, used nowhere in the port."""
    q_, k_, v_, d_ = (t.transpose(1, 2).unsqueeze(1).contiguous() for t in ops)
    q_, k_, v_ = (t.requires_grad_() for t in (q_, k_, v_))
    out = F.scaled_dot_product_attention(q_, k_, v_, scale=1.0)
    return cuda_ms(lambda: torch.autograd.grad(out, (q_, k_, v_), d_, retain_graph=True), iters)


def time_backward(gen, iters: int, card: str, quick: bool) -> None:
    lib = build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        if hasattr(lib, "attention_bwd_floor"):
            say("time backward floor", card=card, dtype=str(dtype),
                launches=4 if code == 0 else 3,
                ms=cuda_ms(lambda: lib.attention_bwd_floor(code, 0, stream), 200))
    cases = [("D/W B1", 128, 32, torch.bfloat16, (16, 256)),
             ("G B3", 512, 128, torch.float32, (16,) if quick else (16, 256)),
             ("G B3", 512, 128, torch.bfloat16, (256, 1024))]
    for what, q1, k1, dtype, batches in cases:
        for length in (5, 10):
            q, k = q1 * length, k1 * length
            for batch in batches:
                ops = core_operands(batch, q, k, dtype, gen)
                ops.append(torch.randn(batch, 32, q, generator=gen, device="cuda").to(dtype))
                row = dict(card=card, block=what, dtype=str(dtype), length=length, q=q, k=k,
                           batch=batch, **backward_grids(batch, q, k),
                           kernel_ms=cuda_ms(lambda: attention._launch_backward(*ops), iters))
                by_kernel = device_ms_by_kernel(lambda: attention._launch_backward(*ops))
                row.update(device_ms=sum(by_kernel.values()), device_ms_by_kernel=by_kernel)
                if not quick:
                    small = max(1, min(batch, 2560 * 640 * 64 // (q * k)))  # bounds the plain scores
                    row.update(plain_batch=small, plain_ms=cuda_ms(
                        lambda: attention.attention_backward_reference(
                            *(t[:small] for t in ops)), 3))
                    row["library_ms"] = library_backward_ms(ops, iters)
                say("time backward", **row)
                del ops
                torch.cuda.empty_cache()


def time_all(gen, iters: int, card: str, quick: bool) -> None:
    for dtype, batches in ((torch.bfloat16, (1024,)), (torch.float32, (16, 256))):
        if quick and dtype != torch.bfloat16:
            continue
        for length in (5, 10):
            q, k = 512 * length, 128 * length
            for batch in batches:
                ops = core_operands(batch, q, k, dtype, gen)
                fops = fused_operands(batch, q, k, dtype, gen)
                small = max(1, min(batch, 2560 * 640 * 512 // (q * k)))  # bounds the plain scores
                row = dict(
                    card=card, dtype=str(dtype), length=length, q=q, k=k, batch=batch,
                    core_ms=cuda_ms(lambda: attention._launch_kernel(*ops), iters),
                    fused_ms=cuda_ms(lambda: fused_block._launch_fused(*fops), iters))
                if quick:
                    say("time", **row)
                    continue
                row.update(
                    plain_batch=small,
                    core_plain_ms=cuda_ms(lambda: attention.attention_reference(
                        *(t[:small] for t in ops)), 3),
                    fused_plain_ms=cuda_ms(lambda: fused_block.fused_block_reference(
                        *(t[:small] if t.dim() == 3 else t for t in fops)), 3))
                qkv = [t.transpose(1, 2).unsqueeze(1).contiguous() for t in ops]
                row["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(*qkv, scale=1.0), iters)
                say("time", **row)
                del ops, fops, qkv
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--no-check", action="store_true", help="time a kernel known to be wrong")
    parser.add_argument("--only", choices=("fwd", "bwd"), default=None)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--csrc", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernels.bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.csrc is not None:
        build.CSRC = args.csrc.resolve()
    build.load_library()
    say("build", card=card, csrc=str(build.CSRC),
        ptxas=[ln.strip() for ln in build.build_log().splitlines()
               if "registers" in ln or "spill" in ln or "Compiling" in ln])
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.only != "bwd":
        if not args.no_check:
            check(gen, (torch.bfloat16,) if args.quick else (torch.bfloat16, torch.float32))
        time_all(gen, args.iters, card, args.quick)
    if args.only != "fwd":
        if not args.no_check:
            check_backward(gen, (torch.bfloat16, torch.float32))
        time_backward(gen, args.iters, card, args.quick)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

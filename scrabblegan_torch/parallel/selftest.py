"""Parity of the parallel step with one process, and a dry run of every mode.

Port of scrabblegan_tpu/parallel/selftest.py and of the repo's
`__graft_entry__.dryrun_multichip`:

    python -m scrabblegan_torch.parallel.selftest [N] [--device cuda|cpu]
        [--backend gloo|nccl]
    python -m scrabblegan_torch.parallel.selftest N --dryrun

The selftest (JAX's, at its sizes): the library defaults at full width,
length 2, batch N (one sample a rank), N data-parallel ranks over 4 steps:
at every step the metrics within rtol 2e-3, atol 2e-4 of one process's
step from the same state, and the state within 5e-3 of its result
(`shadow_steps`); after the 4 steps G's parameters within 5e-3 of an
independent one-process trajectory's; then the weak-scaling leg at 8
samples a rank, one step from the initial state. It prints each step's
largest differences, the metrics' drift from the one-process trajectory,
and `PARITY-OK`. JAX's selftest holds the free trajectory's metrics to the
bounds at every step; those part by float32 rounding amplified by lean
Adam's first updates (g / |g|) in JAX's own run at 2 devices (steps 2 and
3) and in the port's, so the port holds each step from one state to them
and prints the drift. The dry
run: one step in each of 'fsdp' (the 1-D mesh, parallel.fsdp), 'tp' ((N/2,
2), model_parallel 2) and 'fsdp+tp' (both), from one initial state and
batch, each printing `d=... g=...`; the three agree.

It runs on the card unless `--device cpu` is given, and raises when the
card is asked for and absent. It spawns its own N ranks (`spawn`, a file rendezvous, gloo by default, 8 //
N threads a rank on the CPU); under `torchrun` (`torchrun --nproc-per-node N
-m scrabblegan_torch.parallel.selftest`) it joins that group instead, N
being its size: rank 0 writes the initial state and runs the one-process
reference while the others wait, then every rank runs its part.

`run_job` is the rank side that the tests and chip_smoke.py drive too: a
job restores a state from a checkpoint, lays it out, takes steps on seeded
global batches, and reports metrics, its pieces, and the largest
differences of its gathered state to a reference checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

LENGTH = 2
METRIC_RTOL, METRIC_ATOL, PARAM_TOL = 2e-3, 2e-4, 5e-3  # scrabblegan_tpu's selftest bounds


def job_config(batch: int, overrides: dict | None = None, config: str | None = None):
    """`config` (a JSON file; None: the library defaults) at `batch`."""
    from scrabblegan_torch.config import load_config

    return load_config(config, {"shared.batch_size": batch, **(overrides or {})})


def draw_batch(cfg, seed: int, length: int = LENGTH) -> tuple[dict, torch.Tensor | None]:
    """A global batch and z: JAX's selftest batch (float32 images in [-1, 1])
    in 'bucketed' shape mode, `synthetic_batch` in 'padded'; z for noise z."""
    from scrabblegan_torch.data.synthetic import synthetic_batch, synthetic_noise

    rng = np.random.default_rng(seed)
    batch = cfg.shared.batch_size
    if cfg.parallel.shape_mode == "padded":
        return synthetic_batch(cfg, batch, length, rng), synthetic_noise(cfg, batch, rng)
    return {
        "real_imgs": rng.uniform(-1, 1, (batch, 32, 16 * length, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (batch, length)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (batch, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (batch, length)).astype(np.int32),
    }, synthetic_noise(cfg, batch, rng)


def restored(cfg, ckpt_dir: str, device):
    """A whole state restored from the newest checkpoint under ckpt_dir."""
    from scrabblegan_torch.models.build import build_models
    from scrabblegan_torch.train.checkpoint import restore_state
    from scrabblegan_torch.train.state import new_train_state

    state, _ = restore_state(ckpt_dir, new_train_state(cfg, build_models(cfg, device)))
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return state


def take_steps(cfg, state, batches: list[tuple], mesh=None) -> list[list[float]]:
    """Each (batch, z)'s step; the 16 metrics of each."""
    from scrabblegan_torch.train.step import METRIC_NAMES, make_train_step

    step = make_train_step(cfg, state.models, mesh=mesh)
    out = []
    for batch, z in batches:
        metrics = step(state, batch, z)
        out.append([float(metrics[k]) for k in METRIC_NAMES])
    return out


def whole_tensors(state) -> dict[str, torch.Tensor]:
    """net/name -> tensor of every parameter and statistic (whole state)."""
    return {f"{net}/{name}": t.detach().float().cpu()
            for net, module in state.modules().items()
            for name, t in module.state_dict().items()}


def _payload(state) -> dict:
    """A whole state's tensors in a checkpoint's layout (train/checkpoint.py)."""
    return {"models": {net: m.state_dict() for net, m in state.modules().items()},
            "opt_states": {net: {"nu": s.nu, "mu": s.mu} for net, s in state.opt_states.items()},
            "g_ema": state.g_ema}


def state_diffs(state, ref) -> dict[str, float]:
    """Differences of a whole state to `ref`, a whole state or a checkpoint
    directory (its newest checkpoint): per network the largest absolute one
    of its parameters, BN statistics, SN u and sigma, and G's EMA; and of
    Adam's moments (`_nu`, `_mu`) the largest relative to the network's
    largest moment. Adam's update is blind to a constant factor on every
    gradient; its moments are not."""
    from scrabblegan_torch.train.checkpoint import STATE_FILE, latest_step

    if isinstance(ref, str):
        path = os.path.join(ref, str(latest_step(ref)), STATE_FILE)
        payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    else:
        payload = _payload(ref)
    ref = payload["models"]
    out: dict[str, float] = {}

    def worst(key: str, got, want) -> None:  # on got's device: the state is GBs
        d = float((got.detach().float() - want.to(got.device).float()).abs().max())
        out[key] = max(out.get(key, 0.0), d)

    for net, module in state.modules().items():
        buffers = {name for name, _ in module.named_buffers()}
        for name, t in module.state_dict().items():
            kind = ("u" if name.endswith(".u") else "sigma" if name.endswith(".sigma")
                    else "stats" if name in buffers else "params")
            worst(f"{net}_{kind}", t, ref[net][name])
        for moment in ("nu", "mu"):
            got, want = getattr(state.opt_states[net], moment), payload["opt_states"][net][moment]
            if got is None:
                continue
            scale = max(float(w.float().abs().max()) for w in want) or 1.0
            out[f"{net}_{moment}"] = max(
                float((g.detach().float() - w.to(g.device).float()).abs().max())
                for g, w in zip(got, want)) / scale
    for e, w in zip(state.g_ema or (), payload["g_ema"] or ()):
        worst("g_ema", e, w)
    return out


def clone_whole(cfg, state, device):
    """A one-process copy of a whole train state (a parallel run's inside
    `unsharded`): networks, optimizer states, EMA, step and dropout seed."""
    from scrabblegan_torch.models.build import build_models
    from scrabblegan_torch.train.state import new_train_state

    copy = new_train_state(cfg, build_models(cfg, device))
    with torch.no_grad():
        for dst, src in zip(copy.modules().values(), state.modules().values()):
            dst.load_state_dict(src.state_dict())
        for net, src in state.opt_states.items():
            dst = copy.opt_states[net]
            dst.count.copy_(src.count)
            for a, b in zip(dst.nu + (dst.mu or []), src.nu + (src.mu or [])):
                a.copy_(b)
        for a, b in zip(copy.g_ema or (), state.g_ema or ()):
            a.copy_(b)
    copy.step = state.step
    copy.step_t.fill_(state.step)
    copy.dropout_seed.copy_(state.dropout_seed)
    return copy


def metric_errors(got: list[list[float]], ref: list[list[float]]) -> tuple[bool, float]:
    """(every metric within the selftest's bounds, the largest relative
    difference)."""
    ok, worst = True, 0.0
    for g_row, r_row in zip(got, ref):
        for g, r in zip(g_row, r_row):
            worst = max(worst, abs(g - r) / max(abs(r), 1e-4))
            ok &= bool(np.isclose(g, r, rtol=METRIC_RTOL, atol=METRIC_ATOL))
    return ok, worst


WITNESS_FACTOR = 2.0  # with a witness: the bounds are at least this multiple of its difference


def shadow_errors(got: dict) -> tuple[bool, dict]:
    """A `shadow_steps` report against its one-process steps: every step's
    metrics within the selftest's bounds (rtol METRIC_RTOL, atol
    METRIC_ATOL), the parameters, statistics and EMA within PARAM_TOL, and
    Adam's moments (`_nu`, `_mu`) within PARAM_TOL of their largest. With a
    witness, the metrics' rtol and the moments' bound are at least
    WITNESS_FACTOR times the witness's own difference at that step: the
    rounding that splitting the layers brings without any parallel code.
    Returns (ok, the largest differences: 'metric' relative, 'state'
    without the moments, 'moments', and the largest bounds used,
    'metric_rtol' and 'moment_bound')."""
    ok, worst = True, {"metric": 0.0, "state": 0.0, "moments": 0.0,
                       "metric_rtol": METRIC_RTOL, "moment_bound": PARAM_TOL}
    witness = "witness_diffs" in got
    for i, diffs in enumerate(got["step_diffs"]):
        got_m, ref_m = got["metrics"][i], got["shadow_metrics"][i]
        moments = max(v for k, v in diffs.items() if k.endswith(("_nu", "_mu")))
        state = max(v for k, v in diffs.items() if not k.endswith(("_nu", "_mu")))
        rtol, bound = METRIC_RTOL, PARAM_TOL
        if witness:
            _, w_metric = metric_errors([got["witness_metrics"][i]], [ref_m])
            w_moments = max(v for k, v in got["witness_diffs"][i].items()
                            if k.endswith(("_nu", "_mu")))
            rtol = max(rtol, WITNESS_FACTOR * w_metric)
            bound = max(bound, WITNESS_FACTOR * w_moments)
        ok &= all(np.isclose(g, r, rtol=rtol, atol=METRIC_ATOL) for g, r in zip(got_m, ref_m))
        ok &= state <= PARAM_TOL and moments <= bound
        _, metric = metric_errors([got_m], [ref_m])
        for key, value in (("metric", metric), ("state", state), ("moments", moments),
                           ("metric_rtol", rtol), ("moment_bound", bound)):
            worst[key] = max(worst[key], value)
    return ok, worst


def pieces(state) -> dict[str, dict]:
    """Per parameter, this rank's piece's shape and its placement."""
    layout = state.layout
    return {f"{net}/{name}": {"shape": list(p.shape), "places": [list(x) for x in pl]}
            for net in layout.names
            for name, p, pl in zip(layout.names[net], state.params(net), layout.places[net])}


def run_job(spec: dict) -> dict:
    """One rank's part of a job. spec keys: batch, overrides, init (a
    checkpoint directory), steps, seed (step i draws `draw_batch` with
    seed + i, `draw_batch`); optional: device ('cuda' unless given), config (a JSON config file), compare (a reference checkpoint directory: the
    gathered state's largest differences to it after the steps), save (a
    directory: the state after the steps), then_steps (more steps after the
    save), check_pieces (each piece against the whole initial state),
    one_process (no mesh, even in a process group), zero_init (networks of
    zeros in place of `init`), record_masks (a path: every dropout mask of
    the steps, saved as <path>.<rank>), shadow (each step against rank 0's
    one-process step from the same state: `shadow_steps`), witness (with
    shadow: [data parts, model parts], `shadow_steps`' rounding witness).
    Returns rank 0's
    report (metrics, diffs, pieces, seconds and attention launches a
    step)."""
    from scrabblegan_torch import resolve_device
    from scrabblegan_torch.models.build import build_models
    from scrabblegan_torch.parallel import prepare_state
    from scrabblegan_torch.parallel.fsdp import local_piece, unsharded
    from scrabblegan_torch.parallel.mesh import barrier, global_rank, is_rank0, mesh_for
    from scrabblegan_torch.train.checkpoint import save_state
    from scrabblegan_torch.train.state import new_train_state

    device = resolve_device(spec.get("device", "cuda"))
    if device.type == "cuda":  # jobs are compared: no TF32, cuDNN's deterministic algorithms
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    from scrabblegan_torch.kernels import attention

    cfg = job_config(spec["batch"], spec.get("overrides"), spec.get("config"))
    mesh = None if spec.get("one_process") else mesh_for(cfg, device)
    report: dict = {"mesh": None if mesh is None else mesh.shape}
    state = (new_train_state(cfg, build_models(cfg, device)) if spec.get("zero_init")
             else restored(cfg, spec["init"], device))
    whole = whole_tensors(state) if spec.get("check_pieces") else None
    if mesh is not None:
        prepare_state(cfg, mesh, state)
        report["pieces"] = pieces(state)
        if whole is not None:
            bad = [f"{net}/{name}" for net in state.layout.names
                   for name, p, pl in zip(state.layout.names[net], state.params(net),
                                          state.layout.places[net])
                   if not torch.equal(p.detach().cpu(),
                                      local_piece(whole[f"{net}/{name}"], pl, mesh))]
            report["pieces_equal_rule"] = not bad
    seed, steps, then = spec.get("seed", 0), spec["steps"], spec.get("then_steps", 0)
    batches = [draw_batch(cfg, seed + i, spec.get("length", LENGTH))
               for i in range(steps + then)]
    masks = _recording_masks() if spec.get("record_masks") else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if spec.get("shadow"):
        report.update(shadow_steps(cfg, state, batches[:steps], mesh, device,
                                   spec.get("witness")))
    else:
        attention.launches = attention.bwd_launches = 0
        t0 = time.perf_counter()
        report["metrics"] = take_steps(cfg, state, batches[:steps], mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report["s_per_step"] = (time.perf_counter() - t0) / max(1, steps)
        report["launches_per_step"] = {"fwd": attention.launches / max(1, steps),
                                       "bwd": attention.bwd_launches / max(1, steps)}
    if masks is not None:
        torch.save(masks.stop(), f"{spec['record_masks']}.{global_rank()}")
    if spec.get("compare"):
        with unsharded(state):
            if is_rank0():
                report["diffs"] = state_diffs(state, spec["compare"])
        barrier()
    if spec.get("save"):
        save_state(spec["save"], state, state.step)
    if then:
        report["then_metrics"] = take_steps(cfg, state, batches[steps:], mesh)
    return report


def shadow_steps(cfg, state, batches: list[tuple], mesh, device, witness=None) -> dict:
    """Each step twice from one state: rank 0 takes the one-process step on
    a whole copy (`clone_whole`) while the others wait, then every rank the
    parallel step; the trajectory goes on from the parallel state. Returns
    rank 0's metrics of both ('metrics', 'shadow_metrics'), the state's
    differences to the copy's after each step ('step_diffs',
    `state_diffs`), each parallel step's ms and the attention launches a
    step on rank 0. With `witness` (data parts, model parts), rank 0 also
    takes the one-process step on a second copy under `split_parts`, which
    uses no parallel code: its differences to the one-process step
    ('witness_metrics', 'witness_diffs') are the rounding that splitting
    the layers as the ranks do brings alone."""
    from scrabblegan_torch.kernels import attention
    from scrabblegan_torch.parallel.fsdp import unsharded
    from scrabblegan_torch.parallel.mesh import barrier, is_rank0

    out = {"metrics": [], "shadow_metrics": [], "step_diffs": [], "ms_per_step": []}
    if witness:
        out.update(witness_metrics=[], witness_diffs=[])
    launches = [0, 0]
    for batch in batches:
        with unsharded(state):
            shadow = clone_whole(cfg, state, device) if is_rank0() else None
            twin = clone_whole(cfg, state, device) if shadow is not None and witness else None
        if shadow is not None:
            out["shadow_metrics"] += take_steps(cfg, shadow, [batch])
        if twin is not None:
            with split_parts(*witness):
                out["witness_metrics"] += take_steps(cfg, twin, [batch])
            out["witness_diffs"].append(state_diffs(twin, shadow))
            del twin
        barrier()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        attention.launches = attention.bwd_launches = 0
        t0 = time.perf_counter()
        out["metrics"] += take_steps(cfg, state, [batch], mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["ms_per_step"].append((time.perf_counter() - t0) * 1e3)
        launches[0] += attention.launches
        launches[1] += attention.bwd_launches
        with unsharded(state):
            if shadow is not None:
                out["step_diffs"].append(state_diffs(state, shadow))
        del shadow
        barrier()
    n = max(1, len(batches))
    out["launches_per_step"] = {"fwd": launches[0] / n, "bwd": launches[1] / n}
    return out


@contextlib.contextmanager
def split_parts(data: int, model: int = 1):
    """Inside the block every conv, transposed conv and dense layer of
    torch.nn.functional runs as the parallel step's ranks run it, in one
    process: on `data` equal parts of its input along dim 0 (a dim 0 that
    `data` does not divide runs whole) and on `model` parts of its output
    channels (the kernel and the bias sliced, when `model` divides them),
    the outputs concatenated. Batch norm and the losses still see the whole
    batch, and autograd sums the parts' gradients. It computes the same
    function, so its differences to the plain step are rounding: a witness
    that uses no parallel code."""
    import torch.nn.functional as F

    out_axis = {"conv2d": (0, 1), "conv_transpose2d": (1, 1), "linear": (0, -1)}
    originals = {name: getattr(F, name) for name in out_axis}

    def in_parts(name):
        fn, (w_axis, y_axis) = originals[name], out_axis[name]

        def on_channels(x, w, b=None, *args, **kwargs):
            if model == 1 or w.shape[w_axis] % model:
                return fn(x, w, b, *args, **kwargs)
            bs = [None] * model if b is None else b.chunk(model)
            return torch.cat([fn(x, wp, bp, *args, **kwargs)
                              for wp, bp in zip(w.chunk(model, w_axis), bs)], y_axis)

        def call(x, w, b=None, *args, **kwargs):
            if x.dim() < 2 or x.shape[0] < data or x.shape[0] % data:
                return on_channels(x, w, b, *args, **kwargs)
            return torch.cat([on_channels(c, w, b, *args, **kwargs) for c in x.chunk(data)])
        return call
    for name in out_axis:
        setattr(F, name, in_parts(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(F, name, fn)


class _recording_masks:
    """Every keep mask `ops.dropout` draws until `stop()`, in order, on the
    CPU, with the arguments it was drawn with: (key, call, shape, keep_prob,
    shard, mask)."""

    def __init__(self):
        from scrabblegan_torch.ops import dropout

        self.module, self.original, self.masks = dropout, dropout.keep_mask, []

        def keep_mask(key, call, shape, keep_prob, shard=0):
            mask = self.original(key, call, shape, keep_prob, shard)
            self.masks.append((int(key), call, tuple(shape), keep_prob, shard, mask.cpu()))
            return mask
        dropout.keep_mask = keep_mask

    def stop(self) -> list[tuple]:
        self.module.keep_mask = self.original
        return self.masks


# ---- ranks ---------------------------------------------------------------------

def _rank_main(rank: int, world: int, init_file: str, backend: str, device: str,
               specs: list[dict], out_path: str) -> None:
    from scrabblegan_torch.parallel.mesh import init_distributed

    torch.set_num_threads(max(1, 8 // world))
    init_distributed(backend, torch.device(device), f"file://{init_file}", rank, world)
    try:
        reports = [run_job({**spec, "device": device}) for spec in specs]
        if rank == 0:
            Path(out_path).write_text(json.dumps(reports))
    finally:
        torch.distributed.destroy_process_group()


RANK_ARG = "--rank-of"  # the child side of `spawn`: rank, world, job file


def spawn(world: int, specs: list[dict], workdir: str, backend: str = "gloo",
          device: str = "cuda", timeout: float = 1800) -> list[dict]:
    """Run the jobs on `world` fresh ranks (one process each, this module
    with RANK_ARG, a file rendezvous under `workdir`); returns rank 0's
    reports, job by job. A rank that fails stops the others and raises with
    its output. Under torchrun this process is one of the ranks: it runs
    the jobs itself (rank 0's reports; the others' are empty)."""
    import subprocess

    if torch.distributed.is_initialized():
        reports = [run_job({**spec, "device": device}) for spec in specs]
        return reports if torch.distributed.get_rank() == 0 else [{} for _ in specs]
    os.makedirs(workdir, exist_ok=True)
    job = tempfile.mktemp(prefix=f"job.{world}.", dir=workdir)
    Path(job).write_text(json.dumps({"init_file": job + ".rendezvous", "backend": backend,
                                     "device": device, "specs": specs,
                                     "out": job + ".reports.json"}))
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    logs = [open(f"{job}.rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "scrabblegan_torch.parallel.selftest",
                               RANK_ARG, str(r), str(world), job], env=env, cwd=root,
                              stdout=log, stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        r = next((r for r, c in enumerate(codes) if c not in (0, -9)), 0)
        logs[r].seek(0)
        raise RuntimeError(f"ranks exited {codes}; rank {r}'s output:\n{logs[r].read()[-6000:]}")
    for log in logs:
        log.close()
    return json.loads(Path(job + ".reports.json").read_text())


def _rank_from_job(rank: int, world: int, job: str) -> int:
    spec = json.loads(Path(job).read_text())
    _rank_main(rank, world, spec["init_file"], spec["backend"], spec["device"],
               spec["specs"], spec["out"])
    return 0


def write_init(cfg, ckpt_dir: str, seed: int = 0, device: str = "cuda") -> None:
    """A fresh state (flax's initialisers) as checkpoint 0 under ckpt_dir."""
    from scrabblegan_torch.train.checkpoint import save_state
    from scrabblegan_torch.train.state import create_train_state

    save_state(ckpt_dir, create_train_state(cfg, seed, device), 0)


# ---- the selftest and the dry run ------------------------------------------------

def _on_rank0(fn):
    """fn() in this process, or on rank 0 alone under torchrun (the others
    wait); its result on every rank."""
    from scrabblegan_torch.parallel.mesh import barrier, broadcast_object, is_rank0

    out = fn() if is_rank0() else None
    barrier()
    return broadcast_object(out)


def selftest(n: int, workdir: str, backend: str = "gloo", device: str = "cuda") -> bool:
    init = os.path.join(workdir, "init")
    ref_dir = os.path.join(workdir, "reference")
    big = 8 * n

    def reference():
        write_init(job_config(n), init, device=device)
        one = {"init": init, "device": device, "one_process": True}
        return (run_job({**one, "batch": n, "steps": 4, "save": ref_dir}),
                run_job({**one, "batch": big, "steps": 1, "seed": 99}))
    ref, ref_big = _on_rank0(reference)
    got, got_big = spawn(n, [
        {"batch": n, "init": init, "steps": 4, "shadow": True, "compare": ref_dir},
        {"batch": big, "init": init, "steps": 1, "seed": 99}], workdir, backend, device)
    if not got:
        return True  # a rank other than 0 under torchrun: rank 0 judges
    ok = True
    for i in range(4):
        good, worst = metric_errors(got["metrics"][i:i + 1], got["shadow_metrics"][i:i + 1])
        diff = max(got["step_diffs"][i].values())
        _, drift = metric_errors(got["metrics"][i:i + 1], ref["metrics"][i:i + 1])
        print(f"step {i}: metric max rel-diff {worst:.2e}, state max diff {diff:.2e} against "
              f"one process from the same state; {drift:.2e} against the one-process "
              f"trajectory", flush=True)
        ok &= good and diff <= PARAM_TOL
    g_diff = got["diffs"]["g_params"]
    print(f"after 4 steps, against the one-process trajectory: g_param maxdiff {g_diff:.2e}; "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(got["diffs"].items())), flush=True)
    ok &= g_diff <= PARAM_TOL
    good, worst = metric_errors(got_big["metrics"], ref_big["metrics"])
    print(f"weak-scaling (batch {big}): metric max rel-diff {worst:.2e}", flush=True)
    ok &= good
    if ok:
        print("PARITY-OK", flush=True)
    return ok


DRYRUN_MODES = {"fsdp": {"parallel.fsdp": True},
                "tp": {"parallel.model_parallel": 2},
                "fsdp+tp": {"parallel.fsdp": True, "parallel.model_parallel": 2}}


def dryrun(n: int, workdir: str, backend: str = "gloo", device: str = "cuda") -> bool:
    """One step a mode on n ranks; the `__graft_entry__.dryrun_multichip`
    counterpart. Returns whether the three agree."""
    batch = max(2, n)
    modes = {"fsdp": DRYRUN_MODES["fsdp"]}
    if n >= 4 and n % 2 == 0:
        modes.update({k: DRYRUN_MODES[k] for k in ("tp", "fsdp+tp")})
    init = os.path.join(workdir, "init")
    _on_rank0(lambda: write_init(job_config(batch), init, device=device))
    t0 = time.perf_counter()
    reports = spawn(n, [{"batch": batch, "init": init, "steps": 1, "overrides": o}
                        for o in modes.values()], workdir, backend, device)
    if not reports[0]:
        return True
    seen = []
    for mode, report in zip(modes, reports):
        m = report["metrics"][0]
        d, g = m[0], m[9]  # d_loss, g_loss_final
        if not all(np.isfinite(m)):
            raise AssertionError(f"{mode}: non-finite metrics {m}")
        print(f"dryrun_multichip({n}, {mode}): OK — d={d:.3f} g={g:.3f} "
              f"(mesh {report['mesh']}, {report['s_per_step']:.1f} s a step)", flush=True)
        seen.append((round(d, 3), round(g, 3)))
    print(f"dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s", flush=True)
    return len(set(seen)) == 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == [RANK_ARG]:
        return _rank_from_job(int(argv[1]), int(argv[2]), argv[3])
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=8,
                   help="ranks to spawn (under torchrun: its world size)")
    p.add_argument("--dryrun", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--workdir", default=None, help="default: a temporary directory")
    args = p.parse_args(argv)
    from scrabblegan_torch import resolve_device

    device = resolve_device(args.device)  # raises when the card is asked for and absent
    fn = dryrun if args.dryrun else selftest
    if "WORLD_SIZE" not in os.environ:
        with tempfile.TemporaryDirectory(dir=args.workdir) as workdir:
            return 0 if fn(args.n, workdir, args.backend, device.type) else 1
    from scrabblegan_torch.parallel.mesh import broadcast_object, init_distributed

    device = init_distributed(args.backend, device)
    try:
        with tempfile.TemporaryDirectory(dir=args.workdir) as tmp:
            workdir = broadcast_object(tmp)  # rank 0's; it lives as long as rank 0's block
            ok = fn(int(os.environ["WORLD_SIZE"]), workdir, args.backend, str(device))
            torch.distributed.barrier()
        return 0 if ok else 1
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

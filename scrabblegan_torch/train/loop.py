"""The epoch Trainer: the batch loop, metric summaries, per-epoch artifacts
(sample grid, checkpoint, G and R exports, the export gate), resume and
the final GIF.

Port of scrabblegan_tpu/train/loop.py (`Trainer`). The parts:
- batches: `train/batches.py` (JAX's draws in JAX's order), K =
  `parallel.steps_per_call` batches a call (`Batches.next_chunk`, JAX's
  `next_batch`). A `_Prefetcher` thread assembles one epoch's chunks ahead
  of the loop and pins them; the chunked step copies each batch to the card
  with `non_blocking=True` on the stream the step runs on, so no other
  stream is involved and the caching host allocator keeps each pinned
  buffer until its copy is done. The thread makes exactly one epoch's
  chunks and is joined before the epoch's artifacts draw theirs, so the
  batch stream is the same with and without prefetching: JAX's synchronous
  (`prefetch_depth` 0) stream. An epoch is `batches_per_epoch // K` calls;
- the step: `train/step.py`'s `make_chunked_train_step` for every K, 1
  included: CUDA graphs on the card (the counterpart of JAX's jitted step),
  the eager body on the CPU. A call returns its K steps' 16 metrics as one
  (16, K) device tensor, and every `flush_every = max(1, min(32,
  log_every))` calls the pending blocks are fetched with one `.cpu()`, the
  newest call kept out of the fetch so the device stays a call ahead of
  the host: one host sync a block;
- the stall watchdog (`utils/watchdog.py`), when `io.stall_timeout_s` > 0,
  as JAX wires it: started before the state is built, with a grace window
  of `io.compile_grace_s` for the kernels' build and a restore, one before
  each graph's capture (JAX's grace wraps each cold compile) and one before
  the first epoch's artifacts; it beats at each metric flush and after each
  epoch's loop and artifacts, and touches <workdir>/.heartbeat;
- the divergence guard: the run stops at the flush that shows a non-finite
  g_loss_final or d_loss, before that epoch's artifacts;
- per epoch (`save_epoch_artifacts`): standing statistics once
  (`train/standing.py`), the grid of the fixed seed (`utils/viz.py`), the
  full checkpoint every `io.ckpt_every` epochs and at the last
  (`train/checkpoint.py`), G (EMA weights and standing statistics) and R
  exported as export number <epoch>, and the export gate (`eval/gate.py`).

In a parallel run (a process group up: `torchrun`, `--dist-backend`) every
rank runs the Trainer on the same global batch stream, the step keeping its
rows (train/step.py, parallel/): the state is laid out for the config's
mode after it is built or restored, the chunk runs eagerly, and rank 0
writes the summaries, the log, the grids, the checkpoints (the whole state,
gathered), the exports and the gate's files while the others wait. The
standing statistics draw from the batch stream, so every rank computes
them on the gathered state and the streams stay in step.

Known divergences from the JAX Trainer: with z_source='noise' the step's z
is drawn from a `torch.Generator` seeded with `cfg.seed + 1` where JAX
splits a `jax.random` key, so noise-mode runs see other z; the grid carries
its labels in a .txt file beside it (`utils/viz.py`).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from scrabblegan_torch import resolve_device
from scrabblegan_torch.config import Config, save_config
from scrabblegan_torch.convert import to_flax
from scrabblegan_torch.data.loaders import sample_fake_labels
from scrabblegan_torch.models.build import build_models
from scrabblegan_torch.parallel import prepare_state
from scrabblegan_torch.parallel.fsdp import unsharded
from scrabblegan_torch.parallel.mesh import barrier, is_rank0, mesh_for
from scrabblegan_torch.train import checkpoint
from scrabblegan_torch.train.batches import Batches
from scrabblegan_torch.train.metrics import SummaryWriter
from scrabblegan_torch.train.standing import serving_override
from scrabblegan_torch.train.standing import standing_stats as _standing_stats
from scrabblegan_torch.train.state import TrainState, create_train_state, new_train_state
from scrabblegan_torch.train.step import (METRIC_NAMES, make_chunked_train_step,
                                          normalize_images)
from scrabblegan_torch.utils import profiling
from scrabblegan_torch.utils.viz import make_gif, save_epoch_grid


def bucketed_regime_warning(cfg: Config, epochs: int) -> Optional[str]:
    """The warning printed for a multi-epoch run in 'bucketed' shape mode,
    the regime every bucketed arm of the JAX package's quality campaign
    collapsed in past about one epoch (docs/QUALITY.md); else None."""
    if cfg.parallel.shape_mode != "bucketed" or epochs <= 1:
        return None
    return ("=" * 72 + "\nWARNING: parallel.shape_mode='bucketed' is the "
            "measured-UNSTABLE training\nregime beyond ~1 epoch (every "
            "bucketed quality-campaign arm collapsed;\nsee docs/QUALITY.md). "
            "Use configs/recommended.json or --set\n"
            "parallel.shape_mode=padded for the stable regime.\n" + "=" * 72)


class _Prefetcher:
    """A thread that makes `count` items with `make` into a queue of `depth`
    ahead of the consumer; an error in the thread is raised by `get`.
    Traced (utils/profiling.py): span `feed.make` around each item's making
    on the thread, span `feed.wait` around each `get`, and counter
    `feed.empty` when a `get` finds the queue empty."""

    def __init__(self, make, count: int, depth: int = 2):
        self._make = make
        self._count = count
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for _ in range(self._count):
                if self._stop.is_set():
                    return
                with profiling.span("feed.make"):
                    item = self._make()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - raised on the consumer's side
            self._err = e

    def get(self):
        with profiling.span("feed.wait"):
            if self._q.empty():
                profiling.count("feed.empty")
            while True:
                if self._err is not None:
                    raise self._err
                try:
                    return self._q.get(timeout=0.25)
                except queue.Empty:
                    if not self._thread.is_alive() and self._err is None and self._q.empty():
                        raise RuntimeError("prefetcher thread exited unexpectedly")

    def close(self):
        """Stop the thread and wait for it: no draw is left in flight."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.25)


class _NoWriter:
    """The summaries of a rank other than 0: nothing is written."""

    def write_batch(self, *args) -> None:
        pass

    def end_epoch(self) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """`device` is where the networks live and the steps run: 'cuda' (the
    default) or 'cpu'."""

    def __init__(self, cfg: Config, workdir: Optional[str] = None, verbose: bool = True,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh_for(cfg, self.device)  # None in one process
        self.rank0 = is_rank0()
        self.verbose = verbose and self.rank0
        base = workdir or cfg.io.base_path
        self.workdir = base
        self.gen_path = os.path.join(base, cfg.io.gen_imgs_dir)
        self.ckpt_path = os.path.join(base, cfg.io.checkpoint_dir)
        self.model_path = os.path.join(base, cfg.io.model_dir)
        if self.rank0:
            for p in (self.gen_path, self.ckpt_path, self.model_path):
                os.makedirs(p, exist_ok=True)
            for p in (base, self.ckpt_path, self.model_path):
                save_config(cfg, os.path.join(p, "config.json"))
        barrier()
        self.batches = Batches(cfg)
        self.diverged_at = None  # (epoch_idx, batch_idx) of the first non-finite metrics
        self.epoch_secs: list[float] = []  # batch-loop wall time per epoch, artifacts excluded
        self.artifact_secs: list[dict] = []  # each save_epoch_artifacts' parts, seconds
        self._gate_extractor = None
        self.steps_per_call = max(1, int(cfg.parallel.steps_per_call))
        self.chunk = None  # the chunked step of the last `train` call
        self.watchdog = None  # the stall watchdog of the last `train` call, if on

    @property
    def dataset(self):
        return self.batches.dataset

    # ------------------------------------------------------------------ setup
    def init_state(self, resume: bool = True) -> TrainState:
        """A fresh state drawn from `cfg.seed`, or the newest checkpoint
        under the workdir when `resume` and there is one (restored into
        networks built without drawing their initial weights)."""
        if resume and checkpoint.latest_step(self.ckpt_path) is not None:
            template = new_train_state(self.cfg, build_models(self.cfg, self.device))
            state, step = checkpoint.restore_state(self.ckpt_path, template)
            if self.verbose:
                print(f"resumed from checkpoint at step {step}")
        else:
            state = create_train_state(self.cfg, self.cfg.seed, self.device)
            if self.verbose:
                from scrabblegan_torch.utils.summary import summarize_state

                print("initialized networks (model.summary() analog):")
                summarize_state(state)
        if self.mesh is not None:
            prepare_state(self.cfg, self.mesh, state)
        return state

    def load_data(self, read_dir: Optional[str] = None, style_dir: Optional[str] = None,
                  words_file: Optional[str] = None) -> None:
        self.batches.load(read_dir, style_dir, words_file)

    # ------------------------------------------------------------------ batch
    def _host_chunk(self) -> dict:
        """The next K batches, stacked, as CPU tensors, pinned when the steps
        run on a card."""
        pin = self.device.type == "cuda"
        out = {}
        for key, value in self.batches.next_chunk(self.steps_per_call).items():
            t = torch.from_numpy(value)
            out[key] = t.pin_memory() if pin else t
        return out

    # ------------------------------------------------------------------ train
    def train(self, epochs: Optional[int] = None, batches_per_epoch: Optional[int] = None,
              resume: bool = True, profile_steps: int = 0) -> TrainState:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.shared.epochs
        if batches_per_epoch is None:
            batches_per_epoch = int(cfg.io.buf_size / cfg.shared.batch_size) + 1
        warning = bucketed_regime_warning(cfg, epochs)
        if warning:
            print(warning, file=sys.stderr, flush=True)

        watchdog = None
        if cfg.io.stall_timeout_s > 0:
            from scrabblegan_torch.utils.capture import CAPTURE_LOCK
            from scrabblegan_torch.utils.watchdog import StallWatchdog, device_roundtrip_probe

            watchdog = StallWatchdog(cfg.io.stall_timeout_s,
                                     touch_file=os.path.join(self.workdir, ".heartbeat"),
                                     probe=device_roundtrip_probe(self.device, CAPTURE_LOCK)
                                     ).start()
            watchdog.grace(cfg.io.compile_grace_s)  # the kernels' build, a checkpoint restore
        self.watchdog = watchdog
        try:
            return self._train(epochs, batches_per_epoch, resume, profile_steps, watchdog)
        finally:
            if watchdog is not None:
                watchdog.stop()

    def _train(self, epochs: int, batches_per_epoch: int, resume: bool, profile_steps: int,
               watchdog) -> TrainState:
        cfg = self.cfg
        state = self.init_state(resume=resume)
        if watchdog:
            watchdog.beat()
        self.chunk = chunk = make_chunked_train_step(cfg, state.models, mesh=self.mesh)
        if watchdog and chunk.graphs is not None:
            chunk.graphs.before_capture = lambda: watchdog.grace(cfg.io.compile_grace_s)
        start_step = state.step
        start_epoch = start_step // batches_per_epoch
        writer = (SummaryWriter(self.gen_path, append=start_step > 0) if self.rank0
                  else _NoWriter())
        z_gen = torch.Generator().manual_seed(cfg.seed + 1)
        noise = cfg.shared.z_source == "noise"
        k = self.steps_per_call
        bsz, latent = cfg.shared.batch_size, cfg.shared.latent_dim

        def draw_z():
            if not noise:
                return None
            z = torch.randn((k, bsz, latent), generator=z_gen)
            return z.pin_memory() if self.device.type == "cuda" else z

        calls_per_epoch = max(1, batches_per_epoch // k)
        if self.verbose:
            where = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                     else "cpu")
            print(f"no. training samples:  {self.dataset.num_samples}")
            print(f"batch size:            {bsz}")
            print(f"no. batch_per_epoch:   {batches_per_epoch}")
            print(f"epoch size:            {epochs}")
            print(f"device:                {self.device} ({where})")
            if self.mesh is None:
                print("step path:             " + ("CUDA graphs" if chunk.graphs is not None
                                                    else "eager (CPU)"))
            else:
                print(f"step path:             eager, {self.mesh.shape} ranks over "
                      f"{self.mesh.backend}")
            if k > 1 and batches_per_epoch % k:
                print(f"steps_per_call={k}: epoch rounded to {calls_per_epoch * k} batches")
            print("training...", flush=True)

        log_every = (int(cfg.io.log_every) if cfg.io.log_every
                     else max(1, batches_per_epoch // 10))
        flush_every = max(1, min(32, log_every))
        diverged = [None]

        def flush_pending(pending):
            """One host fetch for a block of calls' (16, K) metrics, then
            each step's row to the summaries and the log."""
            if not pending:
                return
            block = torch.stack([m for (_, _, m) in pending]).cpu().numpy()
            if watchdog:
                watchdog.beat()
            for (e_idx, call_idx, _), cols in zip(pending, block):
                for i in range(k):
                    b_idx = call_idx * k + i
                    row = dict(zip(METRIC_NAMES, cols[:, i]))
                    writer.write_batch(e_idx, b_idx, row)
                    if diverged[0] is None and not (np.isfinite(row["g_loss_final"])
                                                    and np.isfinite(row["d_loss"])):
                        diverged[0] = (e_idx, b_idx)
                    if self.verbose and (b_idx + 1) % log_every == 0:
                        print(f">{e_idx + 1}, {b_idx + 1}/{calls_per_epoch * k}, "
                              f"d={row['d_loss']:.3f}, d_real={row['d_loss_real']:.3f}, "
                              f"d_fake={row['d_loss_fake']:.3f}, g_trad={row['g_loss']:.3f}, "
                              f"r_loss_fake={row['r_loss_fake']:.3f}, "
                              f"g_loss={row['g_loss_final']:.3f}, "
                              f"r={row['r_loss_real']:.3f}, s={row['s_loss_real']:.3f}",
                              flush=True)

        if profile_steps:  # traced as training runs them: nothing waits for the device
            trace_dir = os.path.join(self.gen_path, "trace")
            with profiling.trace(trace_dir):
                for _ in range(profile_steps):
                    batches = self._host_chunk()
                    with profiling.span("train.call"):
                        chunk(state, batches, draw_z())
            if self.verbose:
                snap = profiling.snapshot()
                replays = snap["replay_ms"]
                replay = (f"{float(np.median(replays)):.2f} ms a replay (median of "
                          f"{len(replays)})" if replays else "no replay")
                host_ms = 1e3 * snap["spans"]["train.call"]["seconds"] / profile_steps
                print(f"[profile] {profile_steps} calls traced to {trace_dir}; {replay}; "
                      f"{host_ms:.2f} host ms a call", flush=True)

        first_artifacts = True
        for epoch_idx in range(start_epoch, epochs):
            t0 = time.perf_counter()
            depth = cfg.parallel.prefetch_depth
            feed = (_Prefetcher(self._host_chunk, calls_per_epoch, depth) if depth > 0
                    else None)
            pending = []
            try:
                for call_idx in range(calls_per_epoch):
                    batches = feed.get() if feed else self._host_chunk()
                    pending.append((epoch_idx, call_idx, chunk(state, batches, draw_z())))
                    if len(pending) > flush_every:
                        flush_pending(pending[:-1])
                        pending = pending[-1:]
                    if diverged[0] is not None:
                        break
                flush_pending(pending)
            finally:
                if feed is not None:
                    feed.close()
            writer.end_epoch()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if watchdog:
                watchdog.beat()
            self.last_epoch_secs = time.perf_counter() - t0
            self.epoch_secs.append(self.last_epoch_secs)
            if self.verbose:
                print(f"Time for epoch {epoch_idx + 1} is {self.last_epoch_secs:.1f} sec",
                      flush=True)
            if diverged[0] is not None:
                self.diverged_at = diverged[0]
                print(f"DIVERGED: non-finite metrics at epoch {diverged[0][0] + 1} batch "
                      f"{diverged[0][1] + 1}; stopping (state not saved — last good export: "
                      f"epoch {epoch_idx})", flush=True)
                break
            if first_artifacts:
                first_artifacts = False
                if watchdog:
                    watchdog.grace(cfg.io.compile_grace_s)
            self.save_epoch_artifacts(state, epoch_idx + 1, final=epoch_idx + 1 == epochs)
            if watchdog:
                watchdog.beat()

        writer.close()
        if self.rank0:
            make_gif(self.gen_path, "biggan.gif")
        return state

    # ----------------------------------------------------------------- extras
    def save_epoch_artifacts(self, state: TrainState, epoch: int, final: bool = True) -> None:
        """Standing statistics, the epoch grid, the checkpoint (by
        `io.ckpt_every`, and always at the last epoch), the G and R exports
        numbered `epoch`, and the export gate. The wall time of each part
        (after the device finished it) is appended to `artifact_secs`."""
        cfg = self.cfg
        times: dict[str, float] = {}
        last = [time.perf_counter()]

        def lap(part: str) -> None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            times[part] = now - last[0]
            last[0] = now

        with unsharded(state):  # a parallel run: whole on every rank
            self._epoch_artifacts(state, epoch, final, lap)
        barrier()
        times["total"] = sum(times.values())
        self.artifact_secs.append(times)

    def _epoch_artifacts(self, state: TrainState, epoch: int, final: bool, lap) -> None:
        cfg = self.cfg
        serve_stats = self.standing_stats(state)  # every rank: it draws from the batch stream
        lap("standing_stats")
        ckpt_every = int(cfg.io.ckpt_every)
        if not self.rank0:
            return
        b = self.batches
        imgs = self.generate(state, b.seed_labels, b.seed_style, z=b.seed_z, stats=serve_stats)
        save_epoch_grid(imgs, b.seed_labels, self.gen_path, epoch, cfg.io.char_vec)
        lap("grid")
        if ckpt_every > 0 and (final or epoch % ckpt_every == 0):
            checkpoint.write_state(self.ckpt_path, state, state.step)  # whole here
        lap("checkpoint")
        checkpoint.save_generator(self.model_path, to_flax(
            state.models.generator, serving_override(state, serve_stats)), epoch, cfg)
        if cfg.shared.use_recognizer:
            checkpoint.save_recognizer(self.model_path, to_flax(state.models.recognizer),
                                       epoch, cfg)
        lap("exports")
        if cfg.io.export_quality_samples > 0 and self.dataset is not None:
            try:  # a metric failure never stops training
                result = self._gate_export(state, serve_stats, epoch)
                if self.verbose and result is not None:
                    print(f"export gate epoch {epoch}: {result['flag']} "
                          f"(rfid_rand {result['rfid_rand']:.2f}, floor "
                          f"{result['real_floor']:.2f}, excess {result['excess']:.2f})")
            except Exception as e:  # noqa: BLE001
                print(f"export gate failed (export kept, unflagged): {e!r}")
        lap("gate")

    def _gate_export(self, state: TrainState, serve_stats, epoch: int) -> Optional[dict]:
        """Score this epoch's export with the rfid_rand gate and annotate
        it. Everything is drawn from a private generator seeded with
        `cfg.seed + 0xE0`, and the real images come straight from the data
        set's uint8 store, so that the gate draws nothing from the train
        batch stream. The real rows are drawn with replacement, as in JAX
        (kept for parity), so the two halves `score_export` compares may
        share images."""
        from scrabblegan_torch.eval.fid import random_features
        from scrabblegan_torch.eval.gate import annotate_export, score_export

        cfg = self.cfg
        b = self.batches
        n = int(cfg.io.export_quality_samples)
        gate_rng = np.random.default_rng(cfg.seed + 0xE0)
        bucket = int(b.seed_labels.shape[1])  # the grid's length; else the fullest bucket
        if len(self.dataset.labels.get(bucket, ())) == 0:
            bucket = max(self.dataset.nonempty, key=lambda k: len(self.dataset.labels[k]))
        k = max(1, int(cfg.shared.num_gen))
        chunks = []
        for _ in range((n + k - 1) // k):
            labels = sample_fake_labels(gate_rng, b.random_words, k, bucket)
            if cfg.shared.z_source == "style":
                idx = gate_rng.integers(0, len(b.style_validate), size=k)
                cond = np.stack([b.style_validate[i] for i in idx])[..., None].astype(np.float32)
                out = self.generate(state, labels, style_imgs=cond, stats=serve_stats)
            else:
                z = gate_rng.standard_normal((k, cfg.shared.latent_dim)).astype(np.float32)
                out = self.generate(state, labels, z=z, stats=serve_stats)
            chunks.append(out)
        gen = np.concatenate(chunks, 0)[:n]
        store = self.dataset.images[bucket]
        ridx = gate_rng.integers(0, len(store), size=2 * n)
        real = (store[ridx].astype(np.float32) - 127.5) / 127.5
        if self._gate_extractor is None:
            self._gate_extractor = random_features(self.device)
        result = score_export(gen, real, extractor=self._gate_extractor)
        annotate_export(self.model_path, epoch, result)
        return result

    def _standing_batches(self):
        """(batch, z) for the standing statistics: train batches (the fake
        length pinned to the grid's in bucketed mode, one shape for all), z
        from `np_rng` for z_source='noise'."""
        cfg = self.cfg
        b = self.batches
        pin = None if cfg.parallel.shape_mode == "padded" else int(b.seed_labels.shape[1])
        while True:
            batch = b.assemble(bucket=pin, fake_bucket=pin)
            z = None
            if cfg.shared.z_source != "style":
                z = torch.from_numpy(b.np_rng.standard_normal(
                    (batch["fake_labels"].shape[0], cfg.shared.latent_dim)).astype(np.float32))
            yield batch, z

    def standing_stats(self, state: TrainState):
        """G's statistics refreshed under the EMA weights
        (`train/standing.py`), or None when the EMA is off, the count is 0
        or no data is loaded (the live statistics are then served)."""
        if self.dataset is None:
            return None
        return _standing_stats(self.cfg, state, self._standing_batches())

    def generate(self, state: TrainState, labels: np.ndarray,
                 style_imgs: Optional[np.ndarray] = None, z: Optional[np.ndarray] = None,
                 stats: Optional[dict] = None) -> np.ndarray:
        """G in eval mode (the running statistics) on the EMA weights when
        the EMA is on, `stats` in place of its statistics when given:
        (B, H, W, C) float32 images in [-1, 1]."""
        G = state.models.generator
        override = serving_override(state, stats)
        labels_t = torch.as_tensor(np.asarray(labels)).to(self.device).long()
        if self.cfg.shared.z_source == "style":
            args = (labels_t, None, None)
            kwargs = {"style_imgs": normalize_images(np.asarray(style_imgs, np.float32),
                                                     self.device)}
        else:
            args = (labels_t, torch.as_tensor(np.asarray(z, np.float32)).to(self.device), None)
            kwargs = {}
        was_training = G.training
        G.eval()
        try:
            with torch.inference_mode():
                out = functional_call(G, override, args, kwargs) if override else G(*args,
                                                                                     **kwargs)
        finally:
            G.train(was_training)
        return out.float().permute(0, 2, 3, 1).cpu().numpy()

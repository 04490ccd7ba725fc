"""The epoch Trainer: the batch loop, metric summaries, per-epoch artifacts
(sample grid, checkpoint, G and R exports, the export gate), resume and
the final GIF.

Port of scrabblegan_tpu/train/loop.py (`Trainer`). The parts:
- batches: `train/batches.py` (JAX's draws in JAX's order). A `_Prefetcher`
  thread assembles one epoch's batches ahead of the loop and pins them; the
  loop's own thread copies each to the card with `non_blocking=True` on
  the stream the step runs on, so no other stream is involved and the
  caching host allocator keeps each pinned buffer until its copy is done.
  The thread makes exactly one epoch's batches and is joined before the
  epoch's artifacts draw theirs, so the batch stream is the same with and
  without prefetching: JAX's synchronous (`prefetch_depth` 0) stream;
- the step: `train/step.py`'s `make_train_step`. Its 16 metrics are 0-d
  tensors on the device; each step stacks them into one (16,) tensor and
  every `flush_every = max(1, min(32, log_every))` steps the stacked block
  is fetched with one `.cpu()`, the newest step kept out of the fetch so
  the device stays a step ahead of the host: one host sync a block;
- the divergence guard: the run stops at the flush that shows a non-finite
  g_loss_final or d_loss, before that epoch's artifacts;
- per epoch (`save_epoch_artifacts`): standing statistics once
  (`train/standing.py`), the grid of the fixed seed (`utils/viz.py`), the
  full checkpoint every `io.ckpt_every` epochs and at the last
  (`train/checkpoint.py`), G (EMA weights and standing statistics) and R
  exported as export number <epoch>, and the export gate (`eval/gate.py`).

Known divergences from the JAX Trainer: with z_source='noise' the step's z
is drawn from a `torch.Generator` seeded with `cfg.seed + 1` where JAX
splits a `jax.random` key, so noise-mode runs see other z; the grid carries
its labels in a .txt file beside it (`utils/viz.py`). `io.stall_timeout_s`
> 0 (the watchdog, utils/watchdog.py) is not ported and raises.
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
from scrabblegan_torch.train import checkpoint
from scrabblegan_torch.train.batches import Batches
from scrabblegan_torch.train.metrics import SummaryWriter
from scrabblegan_torch.train.standing import serving_override
from scrabblegan_torch.train.standing import standing_stats as _standing_stats
from scrabblegan_torch.train.state import TrainState, create_train_state, new_train_state
from scrabblegan_torch.train.step import METRIC_NAMES, make_train_step, normalize_images
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
    ahead of the consumer; an error in the thread is raised by `get`."""

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


class Trainer:
    """`device` is where the networks live and the steps run: 'cuda' (the
    default) or 'cpu'."""

    def __init__(self, cfg: Config, workdir: Optional[str] = None, verbose: bool = True,
                 device: str | torch.device = "cuda"):
        if cfg.io.stall_timeout_s > 0:
            raise NotImplementedError("io.stall_timeout_s > 0: the stall watchdog "
                                      "(utils/watchdog.py) is not ported yet")
        self.cfg = cfg
        self.verbose = verbose
        self.device = resolve_device(device)
        base = workdir or cfg.io.base_path
        self.workdir = base
        self.gen_path = os.path.join(base, cfg.io.gen_imgs_dir)
        self.ckpt_path = os.path.join(base, cfg.io.checkpoint_dir)
        self.model_path = os.path.join(base, cfg.io.model_dir)
        for p in (self.gen_path, self.ckpt_path, self.model_path):
            os.makedirs(p, exist_ok=True)
        for p in (base, self.ckpt_path, self.model_path):
            save_config(cfg, os.path.join(p, "config.json"))
        self.batches = Batches(cfg)
        self.diverged_at = None  # (epoch_idx, batch_idx) of the first non-finite metrics
        self.epoch_secs: list[float] = []  # batch-loop wall time per epoch, artifacts excluded
        self.artifact_secs: list[dict] = []  # each save_epoch_artifacts' parts, seconds
        self._gate_extractor = None

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
            restored, step = checkpoint.restore_state(self.ckpt_path, template)
            if self.verbose:
                print(f"resumed from checkpoint at step {step}")
            return restored
        state = create_train_state(self.cfg, self.cfg.seed, self.device)
        if self.verbose:
            from scrabblegan_torch.utils.summary import summarize_state

            print("initialized networks (model.summary() analog):")
            summarize_state(state)
        return state

    def load_data(self, read_dir: Optional[str] = None, style_dir: Optional[str] = None,
                  words_file: Optional[str] = None) -> None:
        self.batches.load(read_dir, style_dir, words_file)

    # ------------------------------------------------------------------ batch
    def _host_batch(self) -> dict:
        """The next batch as CPU tensors, pinned when the steps run on a card."""
        pin = self.device.type == "cuda"
        out = {}
        for key, value in self.batches.assemble().items():
            t = torch.from_numpy(value)
            out[key] = t.pin_memory() if pin else t
        return out

    def _to_device(self, batch: dict) -> dict:
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

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

        state = self.init_state(resume=resume)
        step_fn = make_train_step(cfg, state.models)
        start_step = state.step
        start_epoch = start_step // batches_per_epoch
        writer = SummaryWriter(self.gen_path, append=start_step > 0)
        z_gen = torch.Generator().manual_seed(cfg.seed + 1)
        noise = cfg.shared.z_source == "noise"
        bsz, latent = cfg.shared.batch_size, cfg.shared.latent_dim

        def draw_z():
            if not noise:
                return None
            return torch.randn((bsz, latent), generator=z_gen).to(self.device, non_blocking=True)

        if self.verbose:
            where = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                     else "cpu")
            print(f"no. training samples:  {self.dataset.num_samples}")
            print(f"batch size:            {bsz}")
            print(f"no. batch_per_epoch:   {batches_per_epoch}")
            print(f"epoch size:            {epochs}")
            print(f"device:                {self.device} ({where})")
            print("training...", flush=True)

        log_every = (int(cfg.io.log_every) if cfg.io.log_every
                     else max(1, batches_per_epoch // 10))
        flush_every = max(1, min(32, log_every))
        diverged = [None]

        def flush_pending(pending):
            """One host fetch for a block of steps' stacked metrics, then
            each step's row to the summaries and the log."""
            if not pending:
                return
            block = torch.stack([m for (_, _, m) in pending]).cpu().numpy()
            for (e_idx, b_idx, _), vec in zip(pending, block):
                row = dict(zip(METRIC_NAMES, vec))
                writer.write_batch(e_idx, b_idx, row)
                if diverged[0] is None and not (np.isfinite(row["g_loss_final"])
                                                and np.isfinite(row["d_loss"])):
                    diverged[0] = (e_idx, b_idx)
                if self.verbose and (b_idx + 1) % log_every == 0:
                    print(f">{e_idx + 1}, {b_idx + 1}/{batches_per_epoch}, "
                          f"d={row['d_loss']:.3f}, d_real={row['d_loss_real']:.3f}, "
                          f"d_fake={row['d_loss_fake']:.3f}, g_trad={row['g_loss']:.3f}, "
                          f"r_loss_fake={row['r_loss_fake']:.3f}, "
                          f"g_loss={row['g_loss_final']:.3f}, "
                          f"r={row['r_loss_real']:.3f}, s={row['s_loss_real']:.3f}",
                          flush=True)

        if profile_steps:
            from scrabblegan_torch.utils import profiling

            trace_dir = os.path.join(self.gen_path, "trace")
            timer = profiling.StepTimer(warmup=min(2, max(0, profile_steps - 1)))
            with profiling.trace(trace_dir):
                for _ in range(profile_steps):
                    batch = self._to_device(self._host_batch())
                    with profiling.annotate("train_step"):
                        metrics = step_fn(state, batch, draw_z())
                    timer.tick(metrics)
            if self.verbose:
                print(f"[profile] {profile_steps} steps traced to {trace_dir}; "
                      f"{timer.steps_per_sec:.2f} steps/s")

        for epoch_idx in range(start_epoch, epochs):
            t0 = time.perf_counter()
            depth = cfg.parallel.prefetch_depth
            feed = (_Prefetcher(self._host_batch, batches_per_epoch, depth) if depth > 0
                    else None)
            pending = []
            try:
                for b_idx in range(batches_per_epoch):
                    batch = self._to_device(feed.get() if feed else self._host_batch())
                    metrics = step_fn(state, batch, draw_z())
                    pending.append((epoch_idx, b_idx,
                                    torch.stack([metrics[k] for k in METRIC_NAMES])))
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
            self.save_epoch_artifacts(state, epoch_idx + 1, final=epoch_idx + 1 == epochs)

        writer.close()
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

        serve_stats = self.standing_stats(state)
        lap("standing_stats")
        b = self.batches
        imgs = self.generate(state, b.seed_labels, b.seed_style, z=b.seed_z, stats=serve_stats)
        save_epoch_grid(imgs, b.seed_labels, self.gen_path, epoch, cfg.io.char_vec)
        lap("grid")
        ckpt_every = int(cfg.io.ckpt_every)
        if ckpt_every > 0 and (final or epoch % ckpt_every == 0):
            checkpoint.save_state(self.ckpt_path, state, state.step)
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
        times["total"] = sum(times.values())
        self.artifact_secs.append(times)

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

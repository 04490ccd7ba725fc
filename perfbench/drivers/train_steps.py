"""Train steps: the captured four-network step fed by the Trainer's batch loop.

Set-up writes a seeded data set (perfbench/datagen.py) under $TMPDIR, loads
it with the Trainer's assembler (`train.batches.Batches`), builds the four
networks with seeded weights, and makes the Trainer's step
(`train.step.make_chunked_train_step`: CUDA graphs on a card). A
`train.loop._Prefetcher` thread assembles and pins `parallel.steps_per_call`
batches a call, `parallel.prefetch_depth` calls ahead, as `Trainer._train`
does. The window runs calls until its seconds are up, fetching the pending
metric blocks every min(32, log_every) calls as the Trainer does, and ends
in a synchronise; the rate is every step completed over the window's
seconds.

Two runs of `compare_steps` steps go through that same feed and call, and
are compared with the reference:
- start: set-up's first steps from the seeded weights (two eager warm-up
  steps and the capture, on a card), the state after the first read back
  before the second is called;
- steady: the steps right after the window, replays in the window's own
  flow: the state (parameters, statistics, second moments, G's EMA, the step
  number) is copied to pinned host memory, the steps are called back to
  back with no wait on the host, the state after the first and after the
  last is copied behind them on the stream, and all is read at the end.
  The reference starts from that copy of the program's state.
Each keeps its batches as the feed handed them over, each step's losses,
the parameters and second moments after its first step, and the parameters
and G's EMA after its last.

The comparison runs the reference's steps from the same state on the same
batches, in float32 with TF32 off, and a witness: the same reference at the
precisions the configuration states (bfloat16 trunks; float32 with cuDNN's
TF32, as PyTorch's defaults leave it). It reads, for each run ('' for the
start, 'steady.' for the steady steps), of G, D, R and W at the start and of
G and R after the window (past the start, most of D's and W's hinge terms
lie beyond their margin, and a term within rounding of it switches its
sample's whole gradient on or off: their steady gradients part from the
reference's by one sample on sound runs, and the witness's do too):
- each network's gradient gap: its first step's gradient, signed,
  || g_p - g_ref || / || g_ref || over the network's leaves. The program's
  gradient is worked out from its own update: with beta_1 = 0, lean Adam
  moves p by -lr * g / (sqrt(nu / (1 - b2^t)) + eps), so g = -dp *
  (sqrt(nu / (1 - b2^t)) + eps) / lr from the parameters before and after
  the step and the second moment after it;
- grad.g, grad.d, grad.r, grad.w: the program's gradient gap beyond the
  witness's, as a share of the witness's: max(0, gap_p - gap_w) / gap_w,
  the error the program adds to what the stated precision costs a plain
  implementation (0 for a program as exact as the witness or more);
- change: the norm of each leaf's change over the steps, |norm_p -
  norm_ref| / max(norm_ref, the group's median change), read at the median
  leaf of the group (each network read, and G's EMA) that reads highest.
Leaves whose reference gradient is under a thousandth of the network's
median leaf's (biases ahead of a train-mode batch norm) move by round-off
alone and are left out of both. The step losses and the raw gaps are kept
as details only.

Traffic parameters: kind, length_weights, style_images, noise_sd,
compare_steps, warm_calls, trace_units. The configuration's `dataset_rows`
sets the data set's size.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import common, datagen, trace, weights, work
from perfbench.reference.step import run_steps

LOSSES = {"d": "d_loss", "s": "s_loss", "r": "r_loss_real",
          "g": "g_loss_final"}  # the four terms the step's backward sums
ROUNDOFF_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median's
WITNESS_FLOOR = 1e-3  # a witness's gap under this counts as this (float32 without TF32)
EPS = 1e-8  # lean Adam's epsilon
NETS = {"": "gdrw", "steady.": "gr"}  # the networks each compared run reads (see the text)


class Driver:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        self.cfg_file, self.traffic, self.seed = cfg_file, traffic, seed
        self.device = torch.device(device)
        self.tmp = None
        self.runs = {}  # prefix -> what the program did in that compared run
        self._ref = {}  # prefix -> the reference's readings
        self._witness = {}  # prefix -> the witness's gradient gaps

    def setup(self) -> None:
        from scrabblegan_torch.models.build import build_models
        from scrabblegan_torch.train.batches import Batches
        from scrabblegan_torch.train.loop import _Prefetcher
        from scrabblegan_torch.train.state import new_train_state
        from scrabblegan_torch.train.step import make_chunked_train_step

        cfg = self.cfg = common.port_config(self.cfg_file, seed=self.seed)
        self.k = max(1, int(cfg.parallel.steps_per_call))
        if self.k != 1:
            raise ValueError("the comparison reads the state after step 1: steps_per_call 1")
        t = self.traffic
        self.tmp = tempfile.mkdtemp(prefix="perfbench-data-")
        read_dir, words, style_dir = datagen.write_dataset(
            self.tmp, self.seed, self.cfg_file["dataset_rows"], t["length_weights"],
            t["style_images"], t["noise_sd"])
        self.batches = Batches(cfg)
        self.batches.load(read_dir, style_dir, words)
        models = build_models(cfg, self.device)
        self.modules = dict(zip("gdrw", (m for _, m in models.items())))
        self.leaves = {net: weights.specs(m) for net, m in self.modules.items()}
        tensors = weights.make(self.leaves, self.seed, self.device)
        for net, module in self.modules.items():
            weights.load(module, tensors[net])
        host_weights = {net: {k: v.cpu() for k, v in d.items()} for net, d in tensors.items()}
        del tensors
        self.dropout_seed = self.seed % (2 ** 62)
        self.state = new_train_state(cfg, models)
        self.state.dropout_seed.fill_(self.dropout_seed)
        self.chunk = make_chunked_train_step(cfg, models)
        pin = self.pin = self.device.type == "cuda"

        def host_chunk():
            return {key: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                    for key, v in self.batches.next_chunk(self.k).items()}

        self.feed = _Prefetcher(host_chunk, 1 << 40, cfg.parallel.prefetch_depth)
        log_every = cfg.io.log_every or max(1, (int(cfg.io.buf_size / cfg.shared.batch_size) + 1)
                                            // 10)
        self.flush_every = max(1, min(32, int(log_every)))
        self.runs[""] = self._compared_steps(
            {"before": host_weights, "nu0": None, "ema0": None, "step0": 0}, wait=True)
        for _ in range(t["warm_calls"]):
            self.chunk(self.state, self.feed.get())
        common.sync(self.device)

    # ------------------------------------------------------ the program's runs
    def _named(self, net: str, what: str) -> list:
        """(name, tensor) pairs of one network's state: 'weights' (every
        floating tensor of its state_dict), 'params', 'nu' or 'ema'."""
        module = self.modules[net]
        if what == "weights":
            return [(k, v) for k, v in module.state_dict().items() if v.is_floating_point()]
        names = [k for k, _ in module.named_parameters()]
        if what == "params":
            return list(zip(names, module.parameters()))
        return list(zip(names, self.state.opt_states[net].nu if what == "nu"
                        else self.state.g_ema))

    def _copy(self, what: str, nets: str = "gdrw", wait: bool = False) -> dict:
        """{net: {name: host copy}} of `what` (see `_named`). Unless `wait`,
        the copies go to one pinned buffer behind the work queued on the
        stream, and are read only after a synchronise."""
        pairs = {net: self._named(net, what) for net in nets}
        if wait or not self.pin:
            return {net: {k: v.detach().float().cpu().clone() for k, v in p}
                    for net, p in pairs.items()}
        total = sum(v.numel() for p in pairs.values() for _, v in p)
        flat = torch.empty(total, dtype=torch.float32, pin_memory=True)
        out, at = {}, 0
        for net, p in pairs.items():
            out[net] = {}
            for k, v in p:
                dst = flat[at: at + v.numel()].view(v.shape)
                dst.copy_(v.detach(), non_blocking=True)
                out[net][k], at = dst, at + v.numel()
        return out

    def _compared_steps(self, run: dict, wait: bool) -> dict:
        """`compare_steps` calls through the feed from the state that `run`
        describes; with `wait`, the state after the first step is read back
        before the second is called, else nothing waits until the last."""
        from scrabblegan_torch.train.step import METRIC_NAMES

        run["batches"], metrics = [], []
        for i in range(self.traffic["compare_steps"]):
            batch = self.feed.get()
            run["batches"].append({k: v[0].numpy().copy() for k, v in batch.items()})
            metrics.append(self.chunk(self.state, batch))
            if i == 0:
                run["p1"], run["nu1"] = self._copy("params", wait=wait), self._copy("nu", wait=wait)
        run["params"] = self._copy("params", wait=wait)
        run["ema"] = (None if self.state.g_ema is None else
                      self._copy("ema", "g", wait=wait)["g"])
        common.sync(self.device)
        run["losses"] = [dict(zip(METRIC_NAMES, m[:, 0].tolist())) for m in metrics]
        return run

    def window(self, seconds: float, spans: common.Spans) -> dict:
        pending, steps, nonfinite = [], 0, 0
        common.sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with spans("feed.get"):
                batch = self.feed.get()
            with spans("step"):
                pending.append(self.chunk(self.state, batch))
            steps += self.k
            if len(pending) > self.flush_every:
                with spans("flush"):
                    nonfinite += self._flush(pending[:-1])
                pending = pending[-1:]
        with spans("flush"):
            nonfinite += self._flush(pending)
        common.sync(self.device)
        elapsed = time.perf_counter() - t0
        self.attempted, self.nonfinite, self.window_steps = steps, nonfinite, steps
        start = {"before": self._copy("weights"), "nu0": self._copy("nu"),
                 "ema0": None if self.state.g_ema is None else self._copy("ema", "g")["g"],
                 "step0": int(self.state.step)}
        self.runs["steady."] = self._compared_steps(start, wait=False)
        return {"steps_per_s": steps / elapsed, "window_s": elapsed}

    @staticmethod
    def _flush(pending: list) -> int:
        """One host fetch of the pending (16, K) metric blocks; the count of
        steps with a non-finite metric."""
        if not pending:
            return 0
        block = torch.stack(pending).cpu().numpy()
        return int((~np.isfinite(block)).any(axis=1).sum())

    def traced(self, spans: common.Spans) -> trace.Slice:
        units = self.traffic["trace_units"]
        pending = []
        with trace.profiled(self.device) as prof:
            for _ in range(units):
                with spans("feed.get"):
                    batch = self.feed.get()
                with spans("step"):
                    pending.append(self.chunk(self.state, batch))
            with spans("flush"):
                self._flush(pending)
        return trace.reduce(prof, units * self.k)

    def free(self) -> None:
        self.feed.close()
        del self.state, self.chunk, self.modules
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    # ---------------------------------------------------------- reference
    def reference(self, prefix: str, prec: dict | None = None, rows: int | None = None,
                  tf32_convs: bool = False) -> dict:
        """The reference's readings over a compared run's batches from its
        starting state, in float32 with TF32 off unless `prec` says
        otherwise; `tf32_convs` lets cuDNN use TF32 for float32
        convolutions, as PyTorch's defaults do. `rows` keeps the first rows
        of each batch only (a fault: half the batch left out). The readings
        stay on the device."""
        run = self.runs[prefix]
        batches = [{k: v[:rows] for k, v in b.items()} for b in run["batches"]]
        t = {net: {k: v.to(self.device) for k, v in d.items()} for net, d in run["before"].items()}
        start = {"nu": run["nu0"], "ema": run["ema0"], "step": run["step0"]}
        with common.exact_float32():
            torch.backends.cudnn.allow_tf32 = tf32_convs
            return run_steps(self.cfg_file, t, batches, self.dropout_seed, prec, self.device,
                             start)

    def configured(self) -> dict:
        """Each network's precision as the configuration states it."""
        s = self.cfg_file["shared"]
        main, trunk = s["dtype"], s["trunk_dtype"] or s["dtype"]
        return {"g": main, "style": trunk, "d": trunk, "w": trunk, "r": main, "lstm": "float32"}

    def _program_grads(self, prefix: str) -> dict:
        """The program's first-step gradients, worked out from its update
        (see the module's text), in float64 on the device."""
        o, run = self.cfg_file["optimizer"], self.runs[prefix]
        correction = 1.0 - o["beta_2"] ** (run["step0"] + 1)
        dev = self.device
        return {net: {k: -(p1.to(dev).double() - run["before"][net][k].to(dev).double())
                      * ((run["nu1"][net][k].to(dev).double() / correction).sqrt() + EPS)
                      / o[f"{net}_lr"] for k, p1 in run["p1"][net].items()}
                for net in NETS[prefix]}

    def _gaps(self, prefix: str, produced: dict) -> tuple[dict, dict]:
        """Each network's gradient gap and each group's change gap of
        `produced` ('grad1', 'params', 'ema') against the float32
        reference's, in the compared run `prefix` (see the module's text)."""
        if prefix not in self._ref:
            self._ref[prefix] = self.reference(prefix)
        ref, run, dev = self._ref[prefix], self.runs[prefix], self.device
        grads, changes = {}, {}
        for net in NETS[prefix]:
            g_r = {k: v.double() for k, v in ref["grad1"][net].items()}
            norm_r = {k: float(v.norm()) for k, v in g_r.items()}
            med = float(np.median(list(norm_r.values())))
            moved = [k for k in g_r if norm_r[k] >= ROUNDOFF_LEAF * med]
            grads[net] = (sum(float((produced["grad1"][net][k].to(dev).double() - g_r[k])
                                    .square().sum()) for k in moved)
                          / sum(norm_r[k] ** 2 for k in moved)) ** 0.5
            groups = [(net, produced["params"][net], ref["params"][net],
                       run["before"][net])]
            if net == "g" and ref["ema"] is not None:
                groups.append(("ema", produced["ema"], ref["ema"],
                               run["ema0"] or run["before"]["g"]))
            for group, after_p, after_r, before in groups:
                p0 = {k: before[k].to(dev).double() for k in moved}
                d_ref = {k: float((after_r[k].double() - p0[k]).norm()) for k in moved}
                med_d = float(np.median(list(d_ref.values())))
                changes[group] = float(np.median([
                    abs(float((after_p[k].to(dev).double() - p0[k]).norm()) - d_ref[k])
                    / max(d_ref[k], med_d) for k in moved]))
        return grads, changes

    def _compare(self, produce=None) -> tuple[dict, list]:
        """{number: reading} of both compared runs, of the program's steps or
        of `produce(prefix)`'s readings in their place; one unit a run."""
        numbers, units, self.details = {}, [], {}
        for prefix, run in self.runs.items():
            if prefix not in self._witness:
                self._witness[prefix] = self._gaps(
                    prefix, self.reference(prefix, self.configured(), tf32_convs=True))[0]
            witness = self._witness[prefix]
            produced = (produce(prefix) if produce else
                        {"grad1": self._program_grads(prefix), "params": run["params"],
                         "ema": run["ema"]})
            grads, changes = self._gaps(prefix, produced)
            unit = {f"{prefix}grad.{net}": max(0.0, gap - witness[net])
                    / max(witness[net], WITNESS_FLOOR) for net, gap in grads.items()}
            unit[f"{prefix}change"] = max(changes.values())
            numbers.update(unit)
            units.append(unit)
            losses = produced.get("losses", run["losses"])
            self.details[prefix or "start"] = {
                "losses": [{name: abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
                            for name, k in LOSSES.items()}
                           for p, r in zip(losses, self._ref[prefix]["losses"])],
                "grad_gaps": grads, "witness_grad_gaps": witness, "changes": changes}
        return numbers, units

    def compare(self) -> tuple[dict, list]:
        return self._compare()

    def control(self) -> tuple[dict, list]:
        """The reference's steps in the program's place, each network one
        precision below the configuration's."""
        low = {net: common.lower_precision(p) for net, p in self.configured().items()}
        return self._compare(lambda prefix: self.reference(prefix, low))

    def half_batch(self) -> tuple[dict, list]:
        """Fault: the reference in the program's place with half of each batch
        left out, the means taken over the rest."""
        rows = next(iter(self.runs[""]["batches"][0].values())).shape[0] // 2
        return self._compare(lambda prefix: self.reference(prefix, rows=rows))

    def work(self) -> dict:
        s, io = self.cfg_file["shared"], self.cfg_file["io"]
        flops = work.train_step_flops(self.cfg_file, self.leaves, s["batch_size"],
                                      io["bucket_size"], io["input_dim"][1])
        return {"flops_per_step": flops}

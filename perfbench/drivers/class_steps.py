"""Class steps: BigGAN's captured G + D step fed by the program's class feed.

The class-conditional counterpart of perfbench/drivers/train_steps.py, read
the same way. Set-up writes a seeded set of `dataset_rows` class-labelled
RGB images (uint8, the configuration's resolution, labels uniform over its
classes; each class a colour under a coarse random pattern and pixel noise)
as an .npz under $TMPDIR, loads it with the program's reader
(`data.classes.load_classes`), builds G and D with seeded weights
(perfbench/weights.py), and makes the program's step
(`train.step.make_chunked_train_step`: CUDA graphs on a card) and its feed
(`train.classes.class_feed`: `train.batches.ClassBatches` behind the
prefetching thread, pinned chunks, `parallel.prefetch_depth` calls ahead;
fake labels uniform over the classes and z ~ N(0, I) drawn by the feed from
the seed). The window runs calls until its seconds are up, fetching the
pending metric blocks every `flush_every` calls; the rate is every step
completed over the window's seconds.

Two runs of `compare_steps` steps are compared with the reference
(perfbench/reference/biggan.py), as train_steps.py compares its runs: the
start (set-up's first steps from the seeded weights: the eager warm-up
steps) and the steady steps right after the window (replays, from a copy
of the program's state). The reference runs in float32 with TF32 off,
each block recomputed in its backward so that batch 256 fits; the witness
is the same reference in bfloat16 (the configuration's precision). The
numbers: grad.g and grad.d (the program's first-step gradient gap beyond
the witness's, as a share of the witness's), steady.grad.g and
steady.grad.d, and change and steady.change (the median leaf's change gap,
G, D and G's EMA each a group of its own), with train_steps.py's
definitions. In each run a few of D's 2 x 256 hinge terms lie within
rounding of their kink (|1 - D(x, y)| or |1 + D(G(z), y)| under
KINK_ROUNDING times the witness's largest logit error), and one on the
other side in the program than in the reference switches its sample's
share of D's gradient on or off. So D's gap, the program's and the
witness's alike, is the least over each choice of side for the at most
MAX_KINKS of those terms nearest the kink of the distance to the
reference's gradient with those terms switched (each term's gradient from
a pass of its one image, `reference.biggan.logit_grads`).

Readings for the limits (perfbench/control.py reads `control`; the fault
is `half_batch`): the reference one precision lower (fp8) in the program's
place, and the reference with half of each batch left out.

Traffic parameters: kind, compare_steps, warm_calls, trace_units,
flush_every. The configuration's `dataset_rows` sets the data set's size.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import common, trace, weights, work_biggan
from perfbench.reference.biggan import logit_grads, run_steps
from perfbench.reference.step import to_images

ROUNDOFF_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median's
WITNESS_FLOOR = 1e-3  # a witness's gap under this counts as this
EPS = 1e-8  # lean Adam's epsilon
NETS = "gd"  # the networks each compared run reads
MAX_KINKS = 6  # D's hinge terms nearest their kink that may fall on either side
KINK_ROUNDING = 3.0  # within rounding of the kink: under this many witness logit errors


def write_images(path: str, rows: int, resolution: int, classes: int, seed: int) -> None:
    """The cell's data set as an .npz: images (rows, R, R, 3) uint8, labels."""
    rng = np.random.default_rng([seed % (2 ** 63), 11])
    labels = rng.integers(0, classes, rows, dtype=np.int64)
    colours = rng.integers(40, 216, (classes, 3), dtype=np.int16)
    cells = rng.integers(-40, 40, (rows, resolution // 16, resolution // 16, 3), dtype=np.int16)
    images = np.repeat(np.repeat(cells, 16, axis=1), 16, axis=2) + colours[labels][:, None, None]
    images += rng.integers(-24, 24, images.shape, dtype=np.int16)
    np.savez(path, images=np.clip(images, 0, 255).astype(np.uint8), labels=labels)


class Driver:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        self.cfg_file, self.traffic, self.seed = cfg_file, traffic, seed
        self.device = torch.device(device)
        self.tmp = None
        self.runs = {}
        self._ref = {}
        self._witness = {}
        self._witness_first = {}  # prefix -> the witness's first-step images and logits
        self._switches = {}  # prefix -> D's gradient changes of switching terms at the kink
        self.launches = {}

    def setup(self) -> None:
        from scrabblegan_torch.config import BigGANConfig
        from scrabblegan_torch.data.classes import load_classes
        from scrabblegan_torch.models.build import build_models
        from scrabblegan_torch.train.classes import class_feed
        from scrabblegan_torch.train.state import new_train_state
        from scrabblegan_torch.train.step import make_chunked_train_step

        cfg = self.cfg = common.port_config(self.cfg_file, seed=self.seed)
        spec = self.spec = BigGANConfig(**{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in self.cfg_file["biggan"].items()})
        if int(cfg.parallel.steps_per_call) != 1:
            raise ValueError("the comparison reads the state after step 1: steps_per_call 1")
        t = self.traffic
        self.tmp = tempfile.mkdtemp(prefix="perfbench-classes-")
        path = os.path.join(self.tmp, "classes.npz")
        write_images(path, self.cfg_file["dataset_rows"], spec.resolution, spec.n_classes,
                     self.seed)
        images, labels = load_classes(path)
        models = build_models(cfg, self.device, spec)
        self.modules = dict(zip("gd", (m for _, m in models.items())))
        self.leaves = {net: weights.specs(m) for net, m in self.modules.items()}
        tensors = weights.make(self.leaves, self.seed, self.device)
        for net, module in self.modules.items():
            weights.load(module, tensors[net])
        host_weights = {net: {k: v.cpu() for k, v in d.items()} for net, d in tensors.items()}
        del tensors
        self.state = new_train_state(cfg, models)
        self.chunk = make_chunked_train_step(cfg, models)
        self.pin = self.device.type == "cuda"
        self.feed = class_feed(cfg, spec, images, labels, cfg.shared.batch_size, self.seed,
                               1 << 40, self.device)
        self.flush_every = t["flush_every"]
        self.runs[""] = self._compared_steps(
            {"before": host_weights, "nu0": None, "ema0": None, "step0": 0}, wait=True)
        for _ in range(t["warm_calls"]):
            self.chunk(self.state, self.feed.get())
        common.sync(self.device)

    # ------------------------------------------------------ the program's runs
    def _named(self, net: str, what: str) -> list:
        module = self.modules[net]
        if what == "weights":
            return [(k, v) for k, v in module.state_dict().items() if v.is_floating_point()]
        names = [k for k, _ in module.named_parameters()]
        if what == "params":
            return list(zip(names, module.parameters()))
        return list(zip(names, self.state.opt_states[net].nu if what == "nu"
                        else self.state.g_ema))

    def _copy(self, what: str, nets: str = "gd", wait: bool = False) -> dict:
        """{net: {name: host copy}}; unless `wait`, copied into one pinned
        buffer behind the queued work and read only after a synchronise."""
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
        from scrabblegan_torch.train.step import METRIC_NAMES

        run["batches"], metrics = [], []
        for i in range(self.traffic["compare_steps"]):
            batch = self.feed.get()
            run["batches"].append({k: v[0].numpy().copy() for k, v in batch.items()})
            metrics.append(self.chunk(self.state, batch))
            if i == 0:
                run["p1"], run["nu1"] = self._copy("params", wait=wait), self._copy("nu", wait=wait)
        run["params"] = self._copy("params", wait=wait)
        run["ema"] = self._copy("ema", "g", wait=wait)["g"]
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
            steps += 1
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
                 "ema0": self._copy("ema", "g")["g"], "step0": int(self.state.step)}
        self.runs["steady."] = self._compared_steps(start, wait=False)
        return {"steps_per_s": steps / elapsed, "window_s": elapsed}

    @staticmethod
    def _flush(pending: list) -> int:
        if not pending:
            return 0
        block = torch.stack(pending).cpu().numpy()
        return int((~np.isfinite(block)).any(axis=1).sum())

    def traced(self, spans: common.Spans) -> trace.Slice:
        units = self.traffic["trace_units"]
        before = _width_launches()
        pending = []
        with trace.profiled(self.device) as prof:
            for _ in range(units):
                with spans("feed.get"):
                    batch = self.feed.get()
                with spans("step"):
                    pending.append(self.chunk(self.state, batch))
            with spans("flush"):
                self._flush(pending)
        after = _width_launches()
        self.launches = {k: (after[k] - before.get(k, 0)) / units for k in after}
        return trace.reduce(prof, units)

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
        starting state (see train_steps.py `reference`)."""
        run = self.runs[prefix]
        batches = [{k: v[:rows] for k, v in b.items()} for b in run["batches"]]
        t = {net: {k: v.to(self.device) for k, v in d.items()} for net, d in run["before"].items()}
        start = {"nu": run["nu0"], "ema": run["ema0"], "step": run["step0"]}
        with common.exact_float32():
            torch.backends.cudnn.allow_tf32 = tf32_convs
            return run_steps(self.cfg_file, t, batches, prec, self.device, start,
                             checkpoint=self.device.type == "cuda")

    def configured(self) -> dict:
        s = self.cfg_file["shared"]
        return {"g": s["dtype"], "d": s["trunk_dtype"] or s["dtype"]}

    def _program_grads(self, prefix: str) -> dict:
        o, run = self.cfg_file["optimizer"], self.runs[prefix]
        correction = 1.0 - o["beta_2"] ** (run["step0"] + 1)
        dev = self.device
        return {net: {k: -(p1.to(dev).double() - run["before"][net][k].to(dev).double())
                      * ((run["nu1"][net][k].to(dev).double() / correction).sqrt() + EPS)
                      / o[f"{net}_lr"] for k, p1 in run["p1"][net].items()}
                for net in NETS}

    def _gaps(self, prefix: str, produced: dict) -> tuple[dict, dict]:
        if prefix not in self._ref:
            self._ref[prefix] = self.reference(prefix)
        ref, run, dev = self._ref[prefix], self.runs[prefix], self.device
        grads, changes = {}, {}
        for net in NETS:
            g_r = {k: v.double() for k, v in ref["grad1"][net].items()}
            norm_r = {k: float(v.norm()) for k, v in g_r.items()}
            med = float(np.median(list(norm_r.values())))
            moved = [k for k in g_r if norm_r[k] >= ROUNDOFF_LEAF * med]
            diff = {k: produced["grad1"][net][k].to(dev).double() - g_r[k] for k in moved}
            switches = self._kink_switches(prefix) if net == "d" else []
            grads[net] = (_least_square_gap(diff, switches)
                          / sum(norm_r[k] ** 2 for k in moved)) ** 0.5
            groups = [(net, produced["params"][net], ref["params"][net], run["before"][net])]
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
        numbers, units, self.details = {}, [], {}
        for prefix, run in self.runs.items():
            if prefix not in self._witness:
                witness = self.reference(prefix, self.configured(), tf32_convs=True)
                self._witness_first[prefix] = witness["first"]
                self._witness[prefix] = self._gaps(prefix, witness)[0]
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
                "losses": [{k: abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
                            for k in ("d_loss", "g_loss")}
                           for p, r in zip(losses, self._ref[prefix]["losses"])],
                "grad_gaps": grads, "witness_grad_gaps": witness, "changes": changes,
                "kink_terms": len(self._switches.get(prefix, []))}
        return numbers, units

    def _kink_switches(self, prefix: str) -> list[dict]:
        """The changes of the reference's first-step D gradient from switching
        each hinge term within rounding of its kink to its other side (see
        the module's text), {name: tensor} each, on the device."""
        if prefix in self._switches:
            return self._switches[prefix]
        ref, wit = self._ref[prefix]["first"], self._witness_first[prefix]
        tau = max(1e-3, KINK_ROUNDING * max(float((wit[k] - ref[k]).abs().max())
                                            for k in ("d_real", "d_fake")))
        batch, run = self.runs[prefix]["batches"][0], self.runs[prefix]
        terms = []  # (distance to the kink, image, label, sign of the switch)
        for kind, margin, sign in (("real", 1.0 - ref["d_real"], -1.0),
                                   ("fake", 1.0 + ref["d_fake"], 1.0)):
            for i in torch.nonzero(margin.abs() < tau).flatten().tolist():
                active = float(margin[i]) > 0
                image = (to_images(batch["real_imgs"][i:i + 1], self.device)[0] if kind == "real"
                         else ref["gen"][i])
                label = batch[f"{kind}_labels"][i]
                terms.append((abs(float(margin[i])), image, label,
                              sign * (-1.0 if active else 1.0)))
        terms = sorted(terms, key=lambda term: term[0])[:MAX_KINKS]
        rows = len(batch["fake_labels"])
        switches = []
        if terms:
            d_start = {k: v.to(self.device) for k, v in run["before"]["d"].items()}
            labels = torch.as_tensor([int(t[2]) for t in terms], device=self.device)
            with common.exact_float32():
                grads = logit_grads(self.cfg_file, d_start, [t[1] for t in terms], labels)
            switches = [{k: g.double() * (t[3] / rows) for k, g in grad.items()}
                        for t, grad in zip(terms, grads)]
        self._switches[prefix] = switches
        return switches

    def compare(self) -> tuple[dict, list]:
        return self._compare()

    def control(self) -> tuple[dict, list]:
        """The reference's steps in the program's place, one precision below
        the configuration's."""
        low = {net: common.lower_precision(p) for net, p in self.configured().items()}
        return self._compare(lambda prefix: self.reference(prefix, low))

    def half_batch(self) -> tuple[dict, list]:
        """Fault: the reference in the program's place with half of each batch
        left out."""
        rows = next(iter(self.runs[""]["batches"][0].values())).shape[0] // 2
        return self._compare(lambda prefix: self.reference(prefix, rows=rows))

    def work(self) -> dict:
        """The reference's FLOPs a step, and the attention kernels' least
        time a step (perfbench/work_biggan.py) over the launches the traced
        slice counted by width."""
        batch = self.cfg_file["shared"]["batch_size"]
        flops = work_biggan.train_step_flops(self.cfg_file, self.leaves, batch)
        roof = work_biggan.attention_roof_s(self.cfg_file, batch, self.launches)
        return {"flops_per_step": flops, **roof}


def _width_launches() -> dict:
    """The program's attention launches by width so far; {} for a program
    without the count."""
    try:
        from scrabblegan_torch.kernels import attention
    except ImportError:
        return {}
    return dict(getattr(attention, "width_launches", {}))


def _least_square_gap(diff: dict, switches: list[dict]) -> float:
    """min over subsets S of switches of sum_k ||diff[k] - sum_{s in S} s[k]||^2
    over diff's leaves (the leaves a switch lacks count as zero)."""
    keys = list(diff)
    vv = sum(float(diff[k].square().sum()) for k in keys)
    dots = [sum(float((diff[k] * s[k]).sum()) for k in keys if k in s) for s in switches]
    gram = [[sum(float((a[k] * b[k]).sum()) for k in keys if k in a and k in b)
             for b in switches] for a in switches]
    best = vv
    for mask in range(1, 1 << len(switches)):
        chosen = [i for i in range(len(switches)) if mask >> i & 1]
        value = vv - 2 * sum(dots[i] for i in chosen) + sum(gram[i][j] for i in chosen
                                                              for j in chosen)
        best = min(best, value)
    return max(best, 0.0)

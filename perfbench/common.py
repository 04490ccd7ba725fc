"""Plumbing shared by the harness's drivers: files found by name, the
program's config, spans, a seeded sample of a window's answers, the
reference's precision, and the checks that no JAX module was loaded."""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "scrabblegan_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, its configuration's entry, the configuration file) of a
    workload named in BENCHMARK.json."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, entry, load_json(ROOT / entry["file"])


def traffic_file(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits_file(workload: str) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{workload}.json")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def port_config(cfg_file: dict, overrides: dict | None = None, seed: int = 0):
    """The program's Config from a configuration file's sections, plus dotted
    overrides and the run's seed."""
    import dataclasses

    from scrabblegan_torch.config import Config, apply_overrides

    sections = {k: cfg_file[k] for k in ("optimizer", "shared", "io", "parallel")}
    cfg = apply_overrides(Config(), {f"{sec}.{key}": value for sec, values in sections.items()
                                     for key, value in values.items()})
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return dataclasses.replace(cfg, seed=seed)


class Spans:
    """Wall seconds and counts by name, around the harness's calls into the
    program; each span is also a named range in a profiler trace."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1


class Sample:
    """A uniform sample of `k` of the items offered, drawn from the seed:
    each offer gets a seeded priority and the k lowest are kept."""

    def __init__(self, k: int, seed: int, stream: int = 0):
        self.k = k
        self.rng = np.random.default_rng([seed % (2 ** 63), stream])
        self._heap: list = []
        self.offered = 0

    def offer(self, item) -> None:
        p = float(self.rng.random())
        entry = (-p, self.offered, item)
        self.offered += 1
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, entry)
        elif -self._heap[0][0] > p:
            heapq.heapreplace(self._heap, entry)

    def items(self) -> list:
        return [item for _, _, item in sorted(self._heap, key=lambda e: e[1])]

    def map(self, fn) -> None:
        self._heap = [(p, i, fn(item)) for p, i, item in self._heap]


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and cuDNN while the reference runs; the
    flags are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lower_precision(prec: str) -> str:
    """The nearest precision below a stated one, the control's."""
    return {"float32": "bfloat16", "bfloat16": "fp8"}[prec]


def rel_l2(produced: torch.Tensor, reference: torch.Tensor) -> list[float]:
    """||produced - reference|| / ||reference|| of each image (row), float64."""
    p, r = produced.double().flatten(1), reference.double().flatten(1)
    return (torch.linalg.vector_norm(p - r, dim=1) / torch.linalg.vector_norm(r, dim=1)).tolist()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

"""The benchmark of the PyTorch and CUDA port (`scrabblegan_torch`).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the workload in BENCHMARK.json, its configuration file
(perfbench/configs/), its traffic mix (perfbench/traffic/<name>.json, whose
`kind` names a driver in perfbench/drivers/) and its limits
(perfbench/limits/<workload>.json); loads and warms up the program (set-up),
measures for --seconds, and with --trace 1 then profiles a short slice and
reads the cell's per-layer metrics (perfbench/metrics/<name>.py). After the
window the program's state is freed and what it produced is compared with
the plain reference (perfbench/reference/); each number compared is printed
beside its limit on stderr and, under "checks", in the result: the JSON
object on the last line of stdout.

Exits non-zero with no result when no card (or fewer than the cell asks
for) is present, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import common  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metric_reader(name: str):
    path = common.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, workload: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def device_info(count: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


class Run:
    """What the metric readers see: the driver, the window's end-to-end
    values, its spans, the traced slice and the work counts."""

    def __init__(self, driver, e2e, spans, slice_, work):
        self.driver, self.e2e, self.spans, self.slice, self.work = driver, e2e, spans, slice_, work


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            adjust=None, also: tuple = ()) -> dict:
    """One run of a cell on `device`; returns the result object. `adjust`
    (tests only) may change the configuration file and the traffic before
    the run: fn(cfg_file, traffic). `also` names further readings of the
    driver to take after the comparison (perfbench/control.py's: the control
    and the faults), listed with the comparison's under 'readings'."""
    bench = common.manifest()
    cell, _entry, cfg_file = common.find_cell(bench, workload)
    traffic = common.traffic_file(cell["traffic"])
    limits = common.limits_file(workload)
    if adjust is not None:
        adjust(cfg_file, traffic)
    device = torch.device(device)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}").Driver(
        cfg_file, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    setup_s = common.process_age_s()
    spans = common.Spans()
    e2e = driver.window(seconds, spans)
    e2e["setup_s"] = setup_s
    slice_ = driver.traced(common.Spans()) if trace else None
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    driver.free()
    readings = []
    for name in ("compare", *also):
        t0 = time.perf_counter()
        reading = getattr(driver, name)()
        readings.append({"reading": name, "numbers": reading[0], "per_unit": reading[1],
                         "details": getattr(driver, "details", None),
                         "seconds": time.perf_counter() - t0})
    numbers, per_unit = readings[0]["numbers"], readings[0]["per_unit"]
    failed = sum(1 for unit in per_unit if any(unit[k] > limits[k] for k in unit if k in limits))
    failed += getattr(driver, "nonfinite", 0)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(math.isfinite(v) and v <= limits[k]
                                  for k, v in numbers.items())
    e2e_names = {m["name"] for m in bench["end_to_end"] if applies(m, workload, set())}
    metrics = {}
    if trace:
        run = Run(driver, e2e, spans, slice_, driver.work())
        for m in bench["per_layer"]:
            if applies(m, workload, e2e_names):
                value = metric_reader(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] in e2e_names}
    info = (device_info(cell["chips"]) if device.type == "cuda"
            else {"platform": "cpu", "kind": "cpu", "count": 1})
    info["memory_peak_bytes"] = memory_peak
    if slice_ is not None:
        info["busy_s"], info["window_s"] = slice_.busy_s, slice_.window_s
    result = {"correct": bool(correct), "attempted": driver.attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if slice_ is not None:
        result["breakdown"] = slice_.breakdown()
    if also:
        result["readings"] = readings
    result["checks"] = checks  # last: each number compared beside its limit
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    chips = common.find_cell(common.manifest(), args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s); found {count}",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = common.forbidden_modules()
    if found:
        print(f"perfbench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

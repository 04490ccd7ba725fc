"""The traced slice of a run: torch.profiler over a few units at the end of
the window, reduced to what the per-layer metrics read.

From the profiler's raw events: the slice's wall window (the
'perfbench.slice' range), every device operation inside it (kernels, copies,
sets), the seconds in which one ran (the union of their intervals), kernel
launches, device time by kernel name and by class, and the idle gaps between
device work, each named by the innermost host range on the harness's thread
that was open at the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re

import torch

SLICE = "perfbench.slice"
MIN_GAP_NAMED_S = 20e-6  # shorter idle gaps are counted together, unnamed
CLASSES = (  # first match wins
    ("attention kernel", r"attention_\w*kernel|fused_block_\w*kernel"),
    ("layout transform", r"nchwToNhwc|nhwcToNchw"),
    ("batch norm", r"batch_norm"),
    ("LSTM", r"LSTM_|RNN"),
    ("conv and matmul", r"xmma|implicit_gemm|gemm|gemv|nvjet|cutlass|splitKreduce|fft|conv"),
    ("pooling", r"pool"),
    ("reduction", r"reduce_kernel|softmax"),
    ("copy or set", r"^Memcpy|^Memset|memcpy|copy_kernel|CatArray"),
    ("elementwise", r"elementwise|multi_tensor_apply"),
)


@dataclasses.dataclass
class Slice:
    units: int
    window_s: float
    busy_s: float
    kernels: int
    kernel_s: dict[str, float]
    classes: list[tuple[str, float]]
    idle_gaps: list[tuple[str, float]]

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.classes[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def op_class(name: str) -> str:
    for cls, pattern in CLASSES:
        if re.search(pattern, name):
            return cls
    return "other"


@contextlib.contextmanager
def profiled(device):
    """Profile the block (CPU and, on a card, CUDA); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(SLICE):
            yield prof
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)


def reduce(prof, units: int) -> Slice:
    events = prof.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == SLICE)
    ws, we, main = window.start_ns(), window.end_ns(), window.start_thread_id()
    device, host = [], []
    ranges = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CPU
              and _annotation(e)}
    for e in events:
        if (e.device_type() == torch.autograd.DeviceType.CUDA and not _annotation(e)
                and e.name() not in ranges):
            s, t = max(e.start_ns(), ws), min(e.end_ns(), we)
            if t > s:
                device.append((s, t, e.name()))
        elif e.start_thread_id() == main and not e.is_async() and e.name() != SLICE:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    device.sort()
    kernel_s: dict[str, float] = {}
    kernels = 0
    for s, t, name in device:
        kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    busy = 0
    gaps = []
    cursor = ws
    for s, t, _ in device:
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if we > cursor:
        gaps.append((cursor, we))
    classes: dict[str, float] = {}
    for name, sec in kernel_s.items():
        cls = op_class(name)
        classes[cls] = classes.get(cls, 0.0) + sec
    return Slice(units=units, window_s=(we - ws) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
                 kernel_s=kernel_s,
                 classes=sorted(classes.items(), key=lambda kv: -kv[1]),
                 idle_gaps=_name_gaps(gaps, host))


def _annotation(e) -> bool:
    """A host range mirrored on the device's timeline, not device work."""
    kind = getattr(e, "activity_type", None)
    return e.is_user_annotation() or (kind is not None and "annotation" in str(kind()).lower())


def _name_gaps(gaps: list[tuple[int, int]], host: list[tuple[int, int, str]]
               ) -> list[tuple[str, float]]:
    """Idle seconds by the innermost host range open at each gap's middle."""
    host.sort()
    starts = [s for s, _, _ in host]
    totals: dict[str, float] = {}
    for s, t in gaps:
        sec = (t - s) * 1e-9
        if sec < MIN_GAP_NAMED_S:
            name = f"gaps under {MIN_GAP_NAMED_S * 1e6:.0f} us"
        else:
            mid = (s + t) // 2
            name = "no host range"
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(-1, last - 400), -1):
                hs, ht, hname = host[i]
                if hs <= mid <= ht:
                    name = hname
                    break
        totals[name] = totals.get(name, 0.0) + sec
    return sorted(totals.items(), key=lambda kv: -kv[1])

"""In-process stall watchdog for long training runs.

Port of scrabblegan_tpu/utils/watchdog.py. A run can block for good inside
a device wait (a hung kernel, a lost device) with the GIL released, where no
Python-level recovery is possible; the one safe self-heal is a supervised
process exit. The watchdog dumps every thread's stack and exits with
`STALL_EXIT_CODE` (86) when no progress was reported for `timeout_s`; an
outer supervisor restarts the run, which resumes from its last checkpoint
(`io.ckpt_every`).

    wd = StallWatchdog(timeout_s=900, touch_file="run/.heartbeat").start()
    wd.beat()         # after every unit of observable progress
    wd.grace(600)     # before a known long block without progress
    wd.stop()

`grace(s)` defers firing as if the next beat were due `s` from now: the
Trainer announces one before each first capture of a batch shape as a CUDA
graph (warm-up steps and the capture) and before its first epoch
artifacts. While a grace window is open, a configured `probe` (a small
device round trip, run on a throwaway thread) checks every `timeout_s / 2`
that the device still answers; a probe that hangs past `probe_timeout_s`,
or raises, fires the watchdog inside the window instead of after it.

`touch_file` is touched on every poll while the watchdog considers the
process healthy, so a file-activity supervisor can keep a tight window:
liveness is the heartbeat's mtime, progress is this watchdog, and hard
interpreter death is the process exit.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

STALL_EXIT_CODE = 86


class StallWatchdog:
    def __init__(self, timeout_s: float, label: str = "train",
                 touch_file: str | None = None,
                 probe: Optional[Callable[[], object]] = None,
                 probe_timeout_s: float | None = None):
        if timeout_s <= 0:
            raise ValueError("timeout_s must be positive")
        self.timeout_s = float(timeout_s)
        self.label = label
        self.touch_file = touch_file
        self.probe = probe  # fired only inside grace windows; small and synchronous
        self.probe_timeout_s = float(probe_timeout_s or timeout_s)
        self.probe_interval_s = self.timeout_s / 2.0
        self.beats = 0
        self.graces = 0
        self._last_beat = time.monotonic()
        self._grace_until = 0.0
        self._last_probe = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        self.beats += 1
        self._last_beat = time.monotonic()
        self._grace_until = 0.0  # progress observed: the long block is over

    def grace(self, seconds: float) -> None:
        """Announce a block without progress: the next possible fire time
        becomes now + seconds + timeout_s; a beat afterwards restores the
        normal cadence. The probe runs while the window is open."""
        self.graces += 1
        now = time.monotonic()
        self._last_beat = max(self._last_beat, now + float(seconds))
        self._grace_until = max(self._grace_until, now + float(seconds))
        self._last_probe = now  # the first probe one interval into the window

    def _touch(self) -> None:
        if not self.touch_file:
            return
        try:
            with open(self.touch_file, "a"):
                pass
            os.utime(self.touch_file, None)
        except OSError:
            pass

    def start(self) -> "StallWatchdog":
        self.beat()
        self._thread = threading.Thread(target=self._run, name=f"stall-watchdog-{self.label}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _fire(self, why: str, idle: float) -> None:
        sys.stderr.write(f"\n[watchdog:{self.label}] {why} ({idle:.0f}s): dumping stacks and "
                         f"exiting {STALL_EXIT_CODE} for a supervised retry\n")
        sys.stderr.flush()
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
        os._exit(STALL_EXIT_CODE)

    def _probe_once(self) -> bool:
        """The probe on a throwaway thread: True iff it returned within
        probe_timeout_s. A hung probe leaks one daemon thread, and fires the
        watchdog anyway."""
        done = threading.Event()
        err: list = []

        def run():
            try:
                self.probe()
            except Exception as e:  # noqa: BLE001 - a raising probe is a dead device
                err.append(e)
            done.set()

        threading.Thread(target=run, daemon=True, name=f"watchdog-probe-{self.label}").start()
        ok = done.wait(self.probe_timeout_s)
        if ok and err:
            sys.stderr.write(f"[watchdog:{self.label}] liveness probe raised {err[0]!r}: "
                             "treating as device failure\n")
            return False
        return ok

    def _run(self) -> None:
        poll = max(0.05, min(5.0, self.timeout_s / 4))
        self._touch()
        while not self._stop.wait(poll):
            now = time.monotonic()
            if (self.probe is not None and now < self._grace_until
                    and now - self._last_probe >= self.probe_interval_s):
                self._last_probe = now
                if not self._probe_once():
                    self._fire("device liveness probe failed during announced grace window",
                               time.monotonic() - self._last_probe)
                if self._stop.is_set():
                    break
            idle = time.monotonic() - self._last_beat
            if idle <= self.timeout_s:
                # touched only on healthy polls: the heartbeat's mtime is the
                # last time the watchdog saw progress
                self._touch()
            else:
                self._fire(f"no progress for {idle:.0f}s (> {self.timeout_s:.0f}s)", idle)


def device_roundtrip_probe(device, lock: Optional[threading.Lock] = None
                           ) -> Callable[[], object]:
    """A liveness probe for `device`: on a card, a synchronisation and one
    element's round trip to the host; on the CPU, one element. `lock`, if
    given, is held around it (utils/capture.py `CAPTURE_LOCK`: no
    device-wide synchronisation while a CUDA graph is being captured)."""
    import torch

    device = torch.device(device)

    def probe():
        with lock if lock is not None else contextlib.nullcontext():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return float(torch.ones(1, device=device).cpu()[0])

    return probe

"""The port's stall watchdog (`scrabblegan_torch.utils.watchdog`), as
tests/test_watchdog.py holds the JAX package's: beats keep it alive, a stall
exits the process with code 86 and a stack dump (in a subprocess), grace
windows defer firing and a beat ends them, the heartbeat file is touched,
and inside a grace window a hung or raising liveness probe fires it early
while a healthy one holds the grace. Plus the port's probe (a device round
trip, here on the CPU, held under a lock) and the Trainer's wiring."""

import inspect
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from scrabblegan_torch.utils.watchdog import (STALL_EXIT_CODE, StallWatchdog,
                                              device_roundtrip_probe)

ROOT = str(Path(__file__).resolve().parents[1])


def run_child(body: str, timeout: float = 30) -> subprocess.CompletedProcess:
    code = ("import sys, time\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from scrabblegan_torch.utils.watchdog import StallWatchdog\n" + body)
    return subprocess.run([sys.executable, "-c", code], timeout=timeout,
                          capture_output=True, text=True)


def test_beats_keep_it_alive_and_stop_works():
    wd = StallWatchdog(timeout_s=0.4).start()
    for _ in range(4):
        time.sleep(0.15)
        wd.beat()
    wd.stop()
    time.sleep(0.6)  # it would have fired by now had stop() not taken
    assert wd.beats == 5  # start() beats once


def test_stall_exits_process_with_code_86():
    proc = run_child("StallWatchdog(timeout_s=0.3).start()\ntime.sleep(10)\n")
    assert proc.returncode == STALL_EXIT_CODE == 86
    assert "no progress" in proc.stderr and "Thread" in proc.stderr  # the stack dump


def test_grace_defers_then_restores_firing():
    proc = run_child("wd = StallWatchdog(timeout_s=0.3).start()\nwd.grace(1.5)\n"
                     "time.sleep(1.0)\nprint('alive-after-timeout', flush=True)\n"
                     "time.sleep(10)\n")
    assert "alive-after-timeout" in proc.stdout
    assert proc.returncode == STALL_EXIT_CODE


def test_beat_supersedes_grace():
    wd = StallWatchdog(timeout_s=5.0)
    wd.grace(1000.0)
    wd.beat()
    assert wd._last_beat <= time.monotonic() and wd._grace_until == 0.0
    assert wd.graces == 1


def test_touch_file_heartbeat(tmp_path):
    hb = tmp_path / ".heartbeat"
    wd = StallWatchdog(timeout_s=1.0, touch_file=str(hb)).start()
    try:
        deadline = time.time() + 5
        while not hb.exists() and time.time() < deadline:
            time.sleep(0.05)
        assert hb.exists()
        m0 = hb.stat().st_mtime_ns
        time.sleep(0.6)  # the poll cadence is timeout / 4
        assert hb.stat().st_mtime_ns > m0
    finally:
        wd.stop()


def test_rejects_nonpositive_timeout():
    with pytest.raises(ValueError):
        StallWatchdog(timeout_s=0)


def test_hung_probe_fires_fast_inside_grace():
    t0 = time.time()
    proc = run_child("wd = StallWatchdog(timeout_s=0.4, probe=lambda: time.sleep(999)).start()\n"
                     "wd.grace(300.0)\ntime.sleep(30)\n")
    assert proc.returncode == STALL_EXIT_CODE
    assert "liveness probe failed" in proc.stderr
    assert time.time() - t0 < 15


def test_raising_probe_counts_as_dead():
    proc = run_child("def probe():\n    raise RuntimeError('device gone')\n"
                     "wd = StallWatchdog(timeout_s=0.4, probe=probe).start()\n"
                     "wd.grace(300.0)\ntime.sleep(30)\n")
    assert proc.returncode == STALL_EXIT_CODE
    assert "treating as device failure" in proc.stderr


def test_healthy_probe_holds_grace():
    proc = run_child("wd = StallWatchdog(timeout_s=0.4, probe=lambda: 1.0).start()\n"
                     "wd.grace(2.0)\ntime.sleep(1.8)\nwd.beat(); wd.stop()\n"
                     "print('capture-survived', flush=True)\n")
    assert proc.returncode == 0 and "capture-survived" in proc.stdout


def test_device_roundtrip_probe_waits_for_the_capture_lock():
    lock = threading.Lock()
    probe = device_roundtrip_probe("cpu", lock)
    assert probe() == 1.0
    done = threading.Event()
    with lock:  # a capture in progress: the probe waits for it
        threading.Thread(target=lambda: (probe(), done.set()), daemon=True).start()
        assert not done.wait(0.3)
    assert done.wait(5)


def test_trainer_wires_it():
    from scrabblegan_torch.train import loop

    src = inspect.getsource(loop.Trainer.train) + inspect.getsource(loop.Trainer._train)
    assert "stall_timeout_s" in src and "watchdog.beat()" in src
    assert "compile_grace_s" in src and "graphs.before_capture" in src  # a grace a capture
    assert ".heartbeat" in src and "device_roundtrip_probe" in src and "CAPTURE_LOCK" in src

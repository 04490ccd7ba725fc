"""The program's own tracer (`scrabblegan_torch.utils.profiling`) as the
per-layer metrics read it: its snapshot once the traced slice is over. The
program traces while the slice's profiler session runs, so its spans,
counters and timed replays are the slice's; its `once` spans (set-up) and
its phase marks (every replay's) are recorded whether it traces or not.
A program without the tracer gives None, and so does every reader."""

from __future__ import annotations


def snapshot() -> dict | None:
    try:
        from scrabblegan_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else None


def span_seconds(names: tuple[str, ...]) -> float | None:
    """Total seconds of the spans named, or None if none was recorded."""
    snap = snapshot()
    if snap is None:
        return None
    found = [snap["spans"][n]["seconds"] for n in names if n in snap.get("spans", {})]
    return sum(found) if found else None


def phase_ms(match) -> float | None:
    """Device ms of the newest replay's phases whose names `match(name)`
    accepts, or None if there are none."""
    snap = snapshot()
    if snap is None:
        return None
    found = [ms for name, ms in snap.get("phase_ms", {}).items() if match(name)]
    return sum(found) if found else None


def per_unit_ms(run, names: tuple[str, ...]) -> float | None:
    """Milliseconds of the spans named per unit of the traced slice."""
    seconds = span_seconds(names)
    if seconds is None or run.slice is None or not run.slice.units:
        return None
    return 1e3 * seconds / run.slice.units

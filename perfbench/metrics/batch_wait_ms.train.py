"""Host milliseconds a step spent waiting for its batch: the harness's span
around the Trainer feed's `get()` over the whole window, per step."""

MOVES = "steps_per_s"


def read(run):
    steps = run.driver.window_steps
    if not steps:
        return None
    return 1e3 * run.spans.seconds.get("feed.get", 0.0) / steps

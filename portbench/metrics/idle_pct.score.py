"""Share of the traced window in which no kernel, copy or memset runs on the
device (the union of their intervals on the profiler's timeline)."""


def read(run):
    s = run.raw.get("summary")
    if not s:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])

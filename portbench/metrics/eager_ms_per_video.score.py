"""Device ms per video of ATen's elementwise and other kernels (`trace.kind_of`
-> elementwise_and_other)."""


def read(run):
    s = run.raw.get("summary")
    if not s:
        return None
    ms = 1e3 * s["by_kind"].get("elementwise_and_other", 0.0)
    return ms / run.raw["videos"] if ms else None

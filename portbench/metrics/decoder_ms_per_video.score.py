"""Device ms per video of the kernels launched inside the decoder's prefill
(`models/internlm2`)."""


def read(run):
    s = run.raw.get("summary")
    if not s:
        return None
    ms = 1e3 * s["by_module"].get("language_model", 0.0)
    return ms / run.raw["videos"] if ms else None

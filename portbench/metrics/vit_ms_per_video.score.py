"""Device ms per video of the kernels launched inside the vision tower and
mlp1 (`models/vit`, `extract_feature`'s projector)."""


def read(run):
    s = run.raw.get("summary")
    if not s:
        return None
    ms = 1e3 * (s["by_module"].get("vision_model", 0.0) + s["by_module"].get("mlp1", 0.0))
    return ms / run.raw["videos"] if ms else None

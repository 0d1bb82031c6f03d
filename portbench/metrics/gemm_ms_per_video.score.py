"""Device ms per video of the dense GEMMs (cuBLAS; `trace.kind_of` -> gemm)."""


def read(run):
    s = run.raw.get("summary")
    if not s:
        return None
    ms = 1e3 * s["by_kind"].get("gemm", 0.0)
    return ms / run.raw["videos"] if ms else None

"""Real videos per batch the service's worker launched in the window
(`cli/serve._Stats`: jobs over batches)."""


def read(run):
    d = run.raw.get("service")
    return d["jobs"] / d["batches"] if d and d["batches"] else None

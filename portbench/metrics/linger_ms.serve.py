"""ms per batch the service's worker lingered for its batch to fill after its
first job (`cli/serve._Stats.linger_s` over batches)."""


def read(run):
    d = run.raw.get("service")
    return 1e3 * d["linger_s"] / d["batches"] if d and d["batches"] else None

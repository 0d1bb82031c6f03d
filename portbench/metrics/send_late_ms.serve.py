"""95th percentile of how late the open loop's client threads called
`submit` after each request's send time (the generator's own lag)."""

import statistics


def read(run):
    late = sorted(run.raw["lateness_s"])
    return 1e3 * statistics.quantiles(late, n=100, method="inclusive")[94]

"""95th percentile of every request due in the window, from its scheduled
send time to the return of `submit`; a failed request counts as infinitely
late (and makes the run not correct)."""

import statistics


def read(run):
    lat = sorted(run.raw["latency_s"])
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]

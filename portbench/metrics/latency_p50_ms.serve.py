"""Median latency of the requests due in the window, the steadier statistic
beside the 95th percentile."""

import statistics


def read(run):
    return 1e3 * statistics.median(run.raw["latency_s"])

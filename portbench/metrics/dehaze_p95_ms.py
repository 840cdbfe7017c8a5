"""The 95th percentile of the latency of every request of the window, by the
host clock."""

import statistics


def read(run):
    if len(run.latencies_ms) < 20:
        return None
    return statistics.quantiles(run.latencies_ms, n=100)[94]

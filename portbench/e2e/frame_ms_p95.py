"""The 95th percentile of the frames' latency, one call to its image on
the host, over every frame of the window (statistics.quantiles, inclusive
method)."""

import statistics


def read(window) -> float:
    ms = [(b - a) * 1e3 for a, b in window.frames]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]

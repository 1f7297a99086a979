"""latency_p95_ms: the 95th percentile, by nearest rank, of every request
due in the window, each timed from the moment it was due to be sent until
its audio is on the host; a request that failed or never came counts as
infinitely late. Host clock."""

from benchmark.traffic import percentile


def read(run):
    lat = run.record.get("latency_ms")
    if not lat:
        return None
    return percentile(lat, 95)

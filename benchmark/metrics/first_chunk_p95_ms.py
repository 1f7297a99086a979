"""first_chunk_p95_ms: the 95th percentile, by nearest rank, over every
stream started in the window, of the time from the stream_synthesize call
until its first chunk is on the host, the wait for the engine's lock
included; a stream that failed counts as infinitely late. Host clock."""

from benchmark.traffic import percentile


def read(run):
    first = run.record.get("first_chunk_ms")
    if not first:
        return None
    return percentile(first, 95)

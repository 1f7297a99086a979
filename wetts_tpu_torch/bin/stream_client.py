"""Streaming client: first-chunk / per-chunk latency and RTF measurement.

Equivalent of the reference's Triton streaming client metrics
(runtime/cpu_triton_stream/client/stream_client.py:107-163): connects to the
HTTP /stream endpoint (chunked 16-bit PCM) and reports first-chunk latency,
per-chunk latencies (p50/p99), and overall RTF.

The port's own copy of `wetts_tpu/bin/stream_client.py`
(the PyTorch package imports nothing of the JAX one).
"""

from __future__ import annotations

import argparse
import http.client
import time
import urllib.parse

import numpy as np


def stream_once(host: str, port: int, text: str, speaker: str | None,
                sample_rate: int):
    conn = http.client.HTTPConnection(host, port, timeout=300)
    params = {"text": text}
    if speaker:
        params["name"] = speaker
    t0 = time.perf_counter()
    conn.request("GET", "/stream?" + urllib.parse.urlencode(params))
    resp = conn.getresponse()
    chunk_times = []
    total_samples = 0
    while True:
        data = resp.read(65536)
        if not data:
            break
        chunk_times.append(time.perf_counter() - t0)
        total_samples += len(data) // 2
    conn.close()
    wall = time.perf_counter() - t0
    return chunk_times, total_samples, wall


def main():
    p = argparse.ArgumentParser(description="streaming TTS client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--text", required=True)
    p.add_argument("--speaker", default=None)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--runs", type=int, default=5)
    args = p.parse_args()

    first, rtfs, all_chunks = [], [], []
    for i in range(args.runs):
        chunk_times, samples, wall = stream_once(
            args.host, args.port, args.text, args.speaker, args.sample_rate)
        if not chunk_times:
            print("no audio received")
            return
        audio_s = samples / args.sample_rate
        first.append(chunk_times[0])
        rtfs.append(wall / max(audio_s, 1e-9))
        all_chunks.extend(np.diff([0.0] + chunk_times))
        print(f"run {i}: first-chunk {chunk_times[0]*1000:.1f} ms, "
              f"{audio_s:.2f}s audio, RTF {wall / max(audio_s, 1e-9):.4f}")
    chunks = np.array(all_chunks)
    print(f"first-chunk latency: mean {np.mean(first)*1000:.1f} ms "
          f"(min {np.min(first)*1000:.1f})")
    print(f"chunk latency p50 {np.percentile(chunks, 50)*1000:.1f} ms, "
          f"p99 {np.percentile(chunks, 99)*1000:.1f} ms")
    print(f"RTF: mean {np.mean(rtfs):.4f}")


if __name__ == "__main__":
    main()

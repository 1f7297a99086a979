"""Independent users in an open loop: raw-phone requests sent to the port's
`DynamicBatcher` (`submit`) at the mix's Poisson times, whatever the system
has finished; its dispatcher batches them into `synthesize_ids_batch`
calls. Each request is timed from the moment it was due until its audio is
on the host (the future's result is set by the dispatcher after the copy).

Traffic keys: `phones`, `rate_per_s`, `pool` (requests and gaps drawn; the
window takes those due within it), `order`, `max_batch` and `max_delay_s`
(the batcher's, as the server builds it), `probe` (the first requests, on
which set-up calibrates the length scale), `warm_calls` (calls of a
separate draw, of every batch size from 1 to max_batch in turn, and one
more of the pool's longest requests), `warm_s` (then the open loop itself
on a separate draw), `check_calls`.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import calls as C
from benchmark import harness, traffic
from benchmark.harness import LATE_WAIT_S, Tracer, sync
from benchmark.system import build_reference, build_system, sub_seed


def setup(run) -> dict:
    from wetts_tpu_torch.serving.batcher import DynamicBatcher

    cfg, mix = run.cfg, run.mix
    rng = np.random.default_rng(sub_seed(run.seed, 2))
    requests = traffic.phone_requests(mix, rng, cfg["num_phones"],
                                      cfg["num_speakers"])
    # the length scale calibrated on the cell's own first requests
    probe = [(r["ids"], r["sid"]) for r in requests[: mix["probe"]]]
    weights, engine, run.record["length_scale"] = build_system(
        cfg, run.seed, run.device, probe=probe)
    due = traffic.arrival_times(mix, rng)
    warm_rng = np.random.default_rng(sub_seed(run.seed, 3))
    warm = traffic.phone_requests(dict(mix, pool=mix["max_batch"] * mix[
        "warm_calls"]), warm_rng, cfg["num_phones"], cfg["num_speakers"])
    lo = 0
    for k in range(mix["warm_calls"]):
        size = k % mix["max_batch"] + 1
        batch = warm[lo: lo + size]
        lo += size
        engine.synthesize_ids_batch([r["ids"] for r in batch],
                                    [r["sid"] for r in batch])
    longest = sorted(requests, key=lambda r: -len(r["ids"]))[
        : mix["max_batch"]]
    engine.synthesize_ids_batch([r["ids"] for r in longest],
                                [r["sid"] for r in longest])
    sync(run.device)
    tracer = Tracer(run.trace)
    recorder = C.CallRecorder(engine, tracer)
    batcher = DynamicBatcher(engine, max_batch=mix["max_batch"],
                             max_delay_s=mix["max_delay_s"])
    # the open loop itself for `warm_s`, on a separate draw at the mix's
    # rate: every batch size and frame bucket the window will form, with
    # the batcher's and the sender's threads as the window runs them
    warm_rng = np.random.default_rng(sub_seed(run.seed, 5))
    offer(batcher, traffic.phone_requests(mix, warm_rng, cfg["num_phones"],
                                          cfg["num_speakers"]),
          traffic.arrival_times(mix, warm_rng), mix["warm_s"],
          tracer.span)
    return {"engine": engine, "weights": weights, "tracer": tracer,
            "requests": requests, "due": due, "recorder": recorder,
            "batcher": batcher}


def offer(batcher, requests, due, seconds: float, span):
    """Send the requests due within `seconds` at their times; wait for each
    answer until LATE_WAIT_S past the close. Returns (t0, answers, the
    host time each answer came, the sender's worst lateness in s)."""
    n = int(np.searchsorted(due, seconds))
    if n > len(requests):
        raise ValueError("the mix's pool holds fewer requests than the "
                         "window asks for")
    done_at = [None] * n
    futures = []
    t0 = time.perf_counter()
    late = 0.0
    for k in range(n):
        wait = due[k] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - t0 - due[k])
        req = requests[k]
        with span("submit"):
            fut = batcher.submit(req["ids"], req["sid"])
        fut.add_done_callback(
            lambda _f, k=k: done_at.__setitem__(k, time.perf_counter()))
        futures.append(fut)
    deadline = t0 + seconds + LATE_WAIT_S
    answers = []
    for fut in futures:
        try:
            answers.append(fut.result(
                timeout=max(0.0, deadline - time.perf_counter())))
        except Exception:  # noqa: BLE001 - any failure is a missed request
            answers.append(None)
    return t0, answers, done_at, late


def window(run, state) -> None:
    engine, recorder, batcher = (state["engine"], state["recorder"],
                                 state["batcher"])
    due = state["due"]
    engine.stage_times.reset()
    first_batch = len(batcher.batch_sizes)
    recorder.recording = True
    t0, answers, done_at, late = offer(batcher, state["requests"], due,
                                       run.seconds, state["tracer"].span)
    run.window_s = run.seconds
    with engine.lock:  # no call in flight
        recorder.recording = False
    run.record.update(
        calls=recorder.calls, attempted=len(answers),
        failed=sum(a is None for a in answers),
        latency_ms=[1e3 * (d - t0 - due[k]) if d is not None and
                    answers[k] is not None else float("inf")
                    for k, d in enumerate(done_at)],
        answers=answers, sender_late_ms=1e3 * late,
        batch_sizes=list(batcher.batch_sizes[first_batch:]),
        stage_times=engine.stage_times.report())


def trace(run, state) -> None:
    """The schedule again from its start, TRACE_SLICE_S under the
    profiler; a request that fails there fails the run too."""
    tracer = state["tracer"]
    tracer.start()
    _, answers, _, _ = offer(state["batcher"], state["requests"],
                             state["due"], harness.TRACE_SLICE_S,
                             tracer.span)
    with state["engine"].lock:  # no call in flight
        tracer.stop()
    run.trace_data = tracer.data()
    run.record["failed"] += sum(a is None for a in answers)


def check(run, state, control: bool = False):
    """The window's sampled calls against the reference; with `control`,
    the control's answers on the same calls in the program's place."""
    calls, answers = run.record["calls"], run.record["answers"]
    # the k-th call holds the next batch_sizes[k] requests in send order
    # (the batcher's queue is first in, first out); each answer the user
    # got must be the row the call returned
    misrouted, lo = 0, 0
    for call in calls:
        for row, ids in enumerate(call["ids"]):
            if lo >= len(answers):
                break
            got = answers[lo]
            if (got is None or ids != state["requests"][lo]["ids"]
                    or got is not call["audio"][row]):
                misrouted += 1
            lo += 1
    rng = np.random.default_rng(sub_seed(run.seed, 4))
    picked = C.sample_calls(calls, run.mix["check_calls"], rng)
    weights = state["weights"]
    C.free_program(state)
    model = build_reference(run.cfg, run.device, weights)
    control_answers = (C.control_answers(run, model, calls, picked)
                       if control else None)
    numbers = C.compare_calls(run, model, calls, picked, control_answers)
    numbers["calls_compared"] = len(picked)
    numbers["misrouted"] = misrouted + max(0, len(answers) - lo)
    numbers["sender_late_ms"] = run.record["sender_late_ms"]
    lat = run.record["latency_ms"]
    q = max(1, len(lat) // 4)
    numbers["quarter_p50_ms"] = [traffic.percentile(lat[i * q:(i + 1) * q],
                                                    50) for i in range(4)]
    return numbers

"""One caller in a closed loop on `SynthesisEngine.synthesize_ids_batch`:
each call is the next `batch` raw-phone requests of the schedule, sent when
the previous call has returned its audio to the host.

Traffic keys: `phones` (the length distribution, the `sil` head counted),
`batch`, `pool` (requests drawn; the window cycles through them), `probe`
(the first requests, on which set-up calibrates the length scale),
`warm_calls` (calls of a separate draw of the same mix, run before the
window, and one more of the pool's longest requests), `check_calls` (calls
replayed through the reference after the window: the longest, and a sample
drawn from the seed as the window's calls come, whose answers alone the
window holds).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import calls as C
from benchmark import harness, traffic
from benchmark.harness import Tracer, sync
from benchmark.system import build_reference, build_system, sub_seed


def batches_of(requests, size: int):
    return [requests[lo: lo + size] for lo in range(0, len(requests), size)]


def setup(run) -> dict:
    cfg, mix = run.cfg, run.mix
    rng = np.random.default_rng(sub_seed(run.seed, 2))
    requests = traffic.phone_requests(mix, rng, cfg["num_phones"],
                                      cfg["num_speakers"])
    # the length scale calibrated on the cell's own first requests
    probe = [(r["ids"], r["sid"]) for r in requests[: mix["probe"]]]
    weights, engine, run.record["length_scale"] = build_system(
        cfg, run.seed, run.device, probe=probe)
    warm_rng = np.random.default_rng(sub_seed(run.seed, 3))
    warm = batches_of(traffic.phone_requests(
        dict(mix, pool=mix["batch"] * mix["warm_calls"]), warm_rng,
        cfg["num_phones"], cfg["num_speakers"]), mix["batch"])
    warm.append(sorted(requests, key=lambda r: -len(r["ids"]))[
        : mix["batch"]])
    for batch in warm:
        engine.synthesize_ids_batch([r["ids"] for r in batch],
                                    [r["sid"] for r in batch])
    sync(run.device)
    tracer = Tracer(run.trace)
    state = {"engine": engine, "weights": weights, "tracer": tracer,
             "batches": batches_of(requests, mix["batch"]),
             "recorder": C.CallRecorder(engine, tracer, keep=(
                 mix["check_calls"],
                 np.random.default_rng(sub_seed(run.seed, 4))))}
    run.record["decoder_shapes"] = []
    C.record_decoder_shapes(engine, tracer, run.record["decoder_shapes"])
    return state


def drive(engine, batches, seconds: float) -> float:
    """Call the engine on the schedule's batches in turn for `seconds`;
    returns the wall seconds taken."""
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        batch = batches[k % len(batches)]
        engine.synthesize_ids_batch([r["ids"] for r in batch],
                                    [r["sid"] for r in batch])
        k += 1
    return time.perf_counter() - t0


def window(run, state) -> None:
    engine, recorder = state["engine"], state["recorder"]
    engine.stage_times.reset()
    recorder.recording = True
    run.window_s = drive(engine, state["batches"], run.seconds)
    recorder.recording = False
    run.record["calls"] = recorder.calls
    run.record["picked"] = recorder.picked()
    run.record["attempted"] = sum(len(c["ids"]) for c in recorder.calls)
    hop = engine.hop
    run.record["frames_per_phone"] = sum(
        sum(c["samples"]) // hop for c in recorder.calls) / max(1, sum(
            len(i) for c in recorder.calls for i in c["ids"]))
    run.record["stage_times"] = engine.stage_times.report()


def trace(run, state) -> None:
    """The same schedule from its start, TRACE_SLICE_S under the
    profiler."""
    tracer = state["tracer"]
    tracer.start()
    drive(state["engine"], state["batches"], harness.TRACE_SLICE_S)
    tracer.stop()
    run.trace_data = tracer.data()


def check(run, state, control: bool = False):
    """The window's sampled calls against the reference; with `control`,
    the control's answers on the same calls in the program's place."""
    calls, picked = run.record["calls"], run.record["picked"]
    weights = state["weights"]
    C.free_program(state)
    model = build_reference(run.cfg, run.device, weights)
    answers = (C.control_answers(run, model, calls, picked) if control
               else None)
    numbers = C.compare_calls(run, model, calls, picked, answers)
    numbers["calls_compared"] = len(picked)
    numbers["frames_per_phone"] = run.record["frames_per_phone"]
    numbers["length_scale"] = run.record["length_scale"]
    return numbers

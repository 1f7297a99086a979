"""Every cell's run, on the CPU at small widths, skipping only the harness's
look for a chip: `correct` comes out true as the program stands, and false
with the timed path broken underneath: an answer altered where it is
produced (one sample of the decoder's output), half of a batch's answers
left out, and, in the stream cell, a phone dropped by the text frontend.
Each run holds the cell's own limits (benchmark/limits/<cell>.json). The
VITS2 batch, serve and stream cells are not in BENCHMARK.json yet (PERF.md,
Open questions); their entries are the ones a later benchmark change adds,
with their metrics."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.calls import load_limits
from benchmark.run import execute
from benchmark.tests.tiny import (
    tiny_batch_mix,
    tiny_config,
    tiny_serve_mix,
    tiny_stream_mix,
)

CELLS = {
    "vits_v1.batch": ("vits_v1", tiny_batch_mix, 1.0),
    "vits2_vocos_v1.batch": ("vits2_vocos_v1", tiny_batch_mix, 1.0),
    "vits_v1.serve": ("vits_v1", tiny_serve_mix, 1.0),
    "vits_v1.stream": ("vits_v1", tiny_stream_mix, 1.5),
}


DEFERRED = {
    "vits2_vocos_v1.batch": (
        {"name": "vits2_vocos_v1.batch", "config": "vits2_vocos_v1",
         "traffic": "batch_long", "chips": 1},
        [{"name": "audio_s_per_s", "unit": "audio-s/s"},
         {"name": "setup_s", "unit": "s"}],
        [{"name": "mfu", "unit": "%"},
         {"name": "encode_flow_ms.batch", "unit": "ms"},
         {"name": "decode_ms.batch", "unit": "ms"},
         {"name": "device_idle.batch", "unit": "%"}]),
    "vits_v1.serve": (
        {"name": "vits_v1.serve", "config": "vits_v1",
         "traffic": "serve_open", "chips": 1},
        [{"name": "latency_p95_ms", "unit": "ms"},
         {"name": "setup_s", "unit": "s"}],
        [{"name": "encode_flow_ms.serve", "unit": "ms"},
         {"name": "batch_size_mean.serve", "unit": "requests"},
         {"name": "device_idle.serve", "unit": "%"}]),
    "vits_v1.stream": (
        {"name": "vits_v1.stream", "config": "vits_v1",
         "traffic": "stream_zh4", "chips": 1},
        [{"name": "first_chunk_p95_ms", "unit": "ms"},
         {"name": "setup_s", "unit": "s"}],
        [{"name": "frontend_ms.stream", "unit": "ms"},
         {"name": "device_idle.stream", "unit": "%"}]),
}


def run_cell(name: str, seed: int = 31, trace: bool = False):
    config, mix, seconds = CELLS[name]
    bench = harness.load_benchmark()
    if name in DEFERRED:
        cell, e2e, per_layer = DEFERRED[name]
        metrics = per_layer if trace else e2e
    else:
        cell = {w["name"]: w for w in bench["workloads"]}[name]
        metrics = harness.cell_metrics(bench, name, trace)
    return execute(name, cell, tiny_config(config, 476), mix(), metrics,
                   seed, seconds, trace, torch.device("cpu"),
                   time.perf_counter(), load_limits(name))


def alter_one_sample(monkeypatch):
    from wetts_tpu_torch.models.synthesizer import Synthesizer

    decode = Synthesizer.decode

    def altered(self, *args, **kwargs):
        out = decode(self, *args, **kwargs).clone()
        out[0, 0, 0] += 0.01  # the first sample: inside every trim
        return out

    monkeypatch.setattr(Synthesizer, "decode", altered)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    result = run_cell(name)
    assert result["correct"], result["checked"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_altered_answer_is_caught(name, monkeypatch):
    alter_one_sample(monkeypatch)
    result = run_cell(name)
    assert not result["correct"]
    assert result["checked"]["audio_max_abs"]["value"] >= 0.005


def test_dropped_phone_is_caught(monkeypatch):
    from wetts_tpu_torch.text.frontend import G2pProsody

    compute = G2pProsody.compute
    monkeypatch.setattr(G2pProsody, "compute",
                        lambda self, text: compute(self, text)[1:])
    result = run_cell("vits_v1.stream")
    assert not result["correct"]
    assert result["checked"]["ids_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", ["vits_v1.batch", "vits2_vocos_v1.batch"])
def test_half_batch_left_out_is_caught(name, monkeypatch):
    from wetts_tpu_torch.serving.engine import SynthesisEngine

    synthesize = SynthesisEngine.synthesize_ids_batch

    def half(self, ids_list, sids):
        audios = synthesize(self, ids_list, sids)
        return audios[: len(audios) // 2]

    monkeypatch.setattr(SynthesisEngine, "synthesize_ids_batch", half)
    result = run_cell(name)
    assert not result["correct"]
    assert result["checked"]["len_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_reads_spans_from_the_window(name, monkeypatch):
    """With --trace 1 the window runs untraced and a slice follows under
    the profiler: span and counter metrics come from the window (the CPU
    has no device operations to read), and `correct` means what it means
    untraced."""
    monkeypatch.setattr(harness, "TRACE_SLICE_S", 0.5)
    result = run_cell(name, trace=True)
    assert result["correct"], result["checked"]
    assert result["device"]["window_s"] >= 0.5
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = set(result["metrics"])
    assert names & {"encode_flow_ms.batch", "encode_flow_ms.serve",
                    "frontend_ms.stream"}
    assert "setup_s" not in names


@pytest.mark.parametrize("n_calls", [3, 40])
def test_recorder_holds_only_the_checked_answers(n_calls):
    """A batch window holds the answers of the calls that the check
    compares, the longest among them, drawn from the seed; every other call
    keeps its lengths alone."""
    import numpy as np

    from benchmark import calls as C

    lengths = np.random.default_rng(0).integers(1, 100, n_calls)

    class Engine:
        generator = torch.Generator()

        def synthesize_ids_batch(self, ids_list, sids):
            return [np.zeros(len(i), np.float32) for i in ids_list]

    def window(seed):
        engine = Engine()
        recorder = C.CallRecorder(engine, harness.Tracer(False),
                                  keep=(5, np.random.default_rng(seed)))
        recorder.recording = True
        for n in lengths:
            engine.synthesize_ids_batch([[0] * int(n)], [0])
        return recorder

    recorder = window(1)
    picked = recorder.picked()
    assert [k for k, c in enumerate(recorder.calls) if "audio" in c] == picked
    assert [c["samples"][0] for c in recorder.calls] == list(lengths)
    assert int(np.argmax(lengths)) in picked
    assert len(picked) == min(n_calls, 5) or (
        n_calls > 5 and len(picked) == 4)
    assert window(1).picked() == picked
    if n_calls > 5:
        assert any(window(s).picked() != picked for s in (2, 3, 4))

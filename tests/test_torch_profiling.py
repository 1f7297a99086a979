"""The port's StageTimes: host-clock stages that are also user annotations
on torch.profiler's timeline while a profiler records, and counts and
totals over every observation since `reset()`.

(`tests/test_profiling.py` covers the JAX package's StageTimes.)
"""

import copy
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.serving.engine import SynthesisEngine
from wetts_tpu_torch.utils.profiling import StageTimes

CFG = {
    "train": {"segment_size": 2048},
    "data": {"filter_length": 256, "hop_length": 64, "win_length": 256,
             "sampling_rate": 8000},
    "model": {
        "inter_channels": 16, "hidden_channels": 16,
        "filter_channels": 32, "n_heads": 2, "n_layers": 1,
        "kernel_size": 3, "p_dropout": 0.1, "resblock": "2",
        "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
        "upsample_rates": [4, 4, 2, 2], "upsample_initial_channel": 32,
        "upsample_kernel_sizes": [8, 8, 4, 4], "gin_channels": 8,
    },
    "num_phones": 16, "num_speakers": 2}
PHONES = {"sil": 0, "a": 1, "b": 2, "c": 3}


def annotations(prof, prefix="wetts."):
    """The host-side user annotations whose names start with `prefix`, in
    order of their start."""
    evs = [ev for ev in prof.profiler.kineto_results.events()
           if ev.is_user_annotation() and ev.name().startswith(prefix)
           and ev.device_type().name != "CUDA"]
    return [ev.name() for ev in sorted(evs, key=lambda e: e.start_ns())]


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    model = Synthesizer(Config.from_dict(copy.deepcopy(CFG)))
    return SynthesisEngine(Config.from_dict(copy.deepcopy(CFG)), model,
                           PHONES, {"spk0": 0, "spk1": 1}, device="cpu")


@pytest.mark.parametrize("profiled", [True, False])
def test_stage_is_a_span_only_under_the_profiler(profiled):
    st = StageTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if profiled:
            with st.stage("encode"):
                time.sleep(0.002)
    if not profiled:
        with st.stage("encode"):
            time.sleep(0.002)
    assert annotations(prof) == (["wetts.encode"] if profiled else [])
    rep = st.report()["encode"]
    assert rep["n"] == 1 and rep["total_s"] >= 0.002


def test_stage_records_and_closes_its_span_on_error():
    st = StageTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with st.stage("flow"):
                raise ValueError("boom")
        with st.stage("decode"):
            pass
    assert annotations(prof) == ["wetts.flow", "wetts.decode"]
    assert st.report()["flow"]["n"] == 1


def test_batch_call_spans_encode_flow_decode_in_order(engine):
    ids = [[0, 1, 2, 3, 1], [0, 2, 3]]
    engine.synthesize_ids_batch(ids, [0, 1])  # warm, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        audio = engine.synthesize_ids_batch(ids, [0, 1])
    assert len(audio) == 2 and all(a.size > 0 for a in audio)
    assert annotations(prof) == ["wetts.encode", "wetts.flow",
                                 "wetts.decode"]


def test_stream_times_chunk_wait(engine):
    engine.stage_times.reset()
    chunks = list(engine.stream_synthesize("a b c a b c", "spk1"))
    rep = engine.stage_times.report()
    assert chunks and "chunk_wait" in rep and "decode_chunk" not in rep
    assert rep["chunk_wait"]["n"] >= 1


def test_counts_and_totals_outlive_the_bound():
    st = StageTimes(maxlen=4)
    for k in range(1, 11):  # 1 .. 10 ms
        st.add("decode", k * 1e-3)
    rep = st.report()["decode"]
    assert rep["n"] == 10
    assert rep["total_s"] == pytest.approx(55e-3)
    assert rep["mean_ms"] == pytest.approx(5.5)
    # the percentiles come from the last four observations, 7 .. 10 ms
    assert rep["p50_ms"] == pytest.approx(9.0)
    assert rep["p99_ms"] == pytest.approx(10.0)
    assert st.percentile("decode", 0) == pytest.approx(7e-3)
    st.reset()
    assert st.report() == {}
    st.add("decode", 2e-3)
    assert st.report()["decode"]["n"] == 1

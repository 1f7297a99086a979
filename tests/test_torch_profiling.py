"""The port's StageTimes: host-clock stages that are also user annotations
on torch.profiler's timeline while a profiler records, and counts and
totals over every observation since `reset()`; device stages (the host
clock on the CPU) and counters; the engine's decode counted, and the Vocos
decoder's backbone and iSTFT as device stages, with the same audio, and
its decodes counted in `vocos_fused`.

(`tests/test_profiling.py` covers the JAX package's StageTimes.) Imports
nothing of JAX; the one card test runs as

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import contextlib
import copy
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.serving.engine import FRAME_BUCKETS, SynthesisEngine
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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# VITS2 with Vocos (SDP, pre_conv transformer flows, iSTFT n_fft 1024 / hop
# 256) at tiny widths
TINY_VOCOS = {"inter_channels": 16, "hidden_channels": 16,
              "filter_channels": 32, "n_heads": 2, "n_layers": 1,
              "gin_channels": 8, "vocos_channels": 16,
              "vocos_h_channels": 32, "vocos_num_layers": 2}
BATCH = ([[0, 1, 2, 3, 1, 2], [0, 2, 3], [0, 3, 3, 1]], [0, 1, 0])


def annotations(prof, prefix="wetts."):
    """The host-side user annotations whose names start with `prefix`, in
    order of their start."""
    evs = [ev for ev in prof.profiler.kineto_results.events()
           if ev.is_user_annotation() and ev.name().startswith(prefix)
           and ev.device_type().name != "CUDA"]
    return [ev.name() for ev in sorted(evs, key=lambda e: e.start_ns())]


def vocos_config() -> Config:
    with open(os.path.join(ROOT, "examples", "baker", "configs",
                           "vits2_vocos_v1.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY_VOCOS)
    cfg.update(num_phones=16, num_speakers=2)
    return Config.from_dict(cfg)


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    model = Synthesizer(Config.from_dict(copy.deepcopy(CFG)))
    return SynthesisEngine(Config.from_dict(copy.deepcopy(CFG)), model,
                           PHONES, {"spk0": 0, "spk1": 1}, device="cpu")


def make_vocos_engine(device="cpu", seed=3) -> SynthesisEngine:
    torch.manual_seed(0)
    cfg = vocos_config()
    return SynthesisEngine(cfg, Synthesizer(cfg), PHONES,
                           {"spk0": 0, "spk1": 1}, length_scale=3.0,
                           seed=seed, device=device)


@pytest.fixture(scope="module")
def vocos_engine():
    return make_vocos_engine()


@contextlib.contextmanager
def decoder_inputs(engine):
    """The decoder's input shape [rows, C, frames] of every decode inside
    the block."""
    shapes = []
    hook = engine.model.dec.register_forward_pre_hook(
        lambda _m, a: shapes.append(tuple(a[0].shape)))
    try:
        yield shapes
    finally:
        hook.remove()


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


def test_device_stage_on_the_cpu_is_a_host_clock_stage():
    st = StageTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.device_stage("vocos", torch.device("cpu")):
            time.sleep(0.002)
        with st.device_stage("istft", torch.device("cpu")):
            pass
    assert annotations(prof) == ["wetts.vocos", "wetts.istft"]
    rep = st.report()
    assert rep["vocos"]["n"] == 1 and rep["vocos"]["total_s"] >= 0.002
    assert rep["istft"]["n"] == 1
    assert not st._pending


def test_counters_count_report_and_reset():
    st = StageTimes()
    st.count("decode_rows", 8)
    st.count("decode_rows", 3)
    st.count("decode_frames", 8 * 160)
    with st.stage("decode"):
        pass
    rep = st.report()
    assert rep["decode_rows"]["n"] == 2 and rep["decode_rows"]["count"] == 11
    assert rep["decode_frames"] == {
        "n": 1, "count": 1280, "total_s": 0.0, "mean_ms": 0.0,
        "p50_ms": 0.0, "p99_ms": 0.0}
    # a counter carries every key of a stage, so readers of every entry's
    # times (seed_work.py, chip_smoke.py) read it as a stage of no time
    assert set(rep["decode"]) <= set(rep["decode_rows"])
    assert "count" not in rep["decode"]
    assert "decode_rows: 11(x2)" in st.summary()
    assert "decode: " in st.summary()
    st.reset()
    assert st.report() == {}
    st.count("decode_rows", 1)
    assert st.report()["decode_rows"]["count"] == 1


def test_vocos_engine_stages_and_counts_every_decode(vocos_engine):
    engine = vocos_engine
    engine.synthesize_ids_batch(*BATCH)  # warm
    engine.stage_times.reset()
    with decoder_inputs(engine) as shapes:
        for _ in range(2):
            engine.synthesize_ids_batch(*BATCH)
    rep = engine.stage_times.report()
    assert len(shapes) == 2
    for name in ("decode", "vocos", "istft", "decode_rows",
                 "decode_frames"):
        assert rep[name]["n"] == 2, name
    rows = len(BATCH[0])
    assert all(b == rows for b, _, _ in shapes)
    assert rep["decode_rows"]["count"] == 2 * rows
    # rows x the frame bucket the decoder ran at
    assert rep["decode_frames"]["count"] == sum(b * t for b, _, t in shapes)
    assert shapes[0][2] in FRAME_BUCKETS
    # the two device stages lie inside the host's decode stage
    assert (rep["vocos"]["total_s"] + rep["istft"]["total_s"]
            <= rep["decode"]["total_s"])
    # streaming decodes are counted as well, one count per stacked decode
    engine.stage_times.reset()
    with decoder_inputs(engine) as shapes:
        chunks = list(engine.stream_synthesize("a b c a b c a b", "spk1",
                                               block=8, pad=2))
    rep = engine.stage_times.report()
    assert chunks and rep["decode_rows"]["n"] == len(shapes) >= 1
    assert rep["vocos"]["n"] == rep["istft"]["n"] == len(shapes)
    assert rep["decode_rows"]["count"] == sum(b for b, _, _ in shapes)
    assert rep["decode_frames"]["count"] == sum(b * t for b, _, t in shapes)


def test_vocos_decodes_count_vocos_fused(vocos_engine):
    """Every Vocos decode counts `vocos_fused` beside `decode_rows`, batch
    and streamed: 0 on the CPU, which keeps the decoder's modules."""
    engine = vocos_engine
    engine.stage_times.reset()
    engine.synthesize_ids_batch(*BATCH)
    chunks = list(engine.stream_synthesize("a b c a b c a b", "spk1",
                                           block=8, pad=2))
    rep = engine.stage_times.report()
    assert chunks and rep["decode_rows"]["n"] >= 2
    assert rep["vocos_fused"]["n"] == rep["decode_rows"]["n"]
    assert rep["vocos_fused"]["count"] == 0
    assert "count" in rep["vocos_fused"] and "vocos_fused: 0(x" in (
        engine.stage_times.summary())


def test_vocos_audio_is_bit_equal_with_and_without_stages():
    """Two engines from one model and one generator seed, one with its
    decoder's stages, one without: the same audio, bit for bit; and the
    decoder alone with a StageTimes and without."""
    timed, plain = make_vocos_engine(), make_vocos_engine()
    plain.model.load_state_dict(timed.model.state_dict())
    no_stages = plain.model.decode

    def untimed(z, g=None, sid=None, precision="f32", stages=None):
        return no_stages(z, g, sid, precision)

    plain.model.decode = untimed
    for _ in range(2):
        got = timed.synthesize_ids_batch(*BATCH)
        want = plain.synthesize_ids_batch(*BATCH)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert "vocos" in timed.stage_times.report()
    assert "vocos" not in plain.stage_times.report()
    z = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(1))
    g = torch.randn(2, 1, 8, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        st = StageTimes()
        a = timed.model.decode(z, g, stages=st)
        b = timed.model.decode(z, g)
    assert torch.equal(a, b) and st.report()["istft"]["n"] == 1


def test_hifigan_decode_gains_only_the_counts(engine):
    """VITS-base: the engine's stages are encode, flow and decode as
    before, beside the two counters; the audio is the decoder's own."""
    engine.stage_times.reset()
    with decoder_inputs(engine) as shapes:
        got = engine.synthesize_ids_batch(*BATCH)
    rep = engine.stage_times.report()
    assert {k for k, v in rep.items() if "count" not in v} == {
        "encode", "flow", "decode"}
    assert set(rep) - {"encode", "flow", "decode"} == {
        "decode_rows", "decode_frames"}
    (b, _, t), = shapes
    assert rep["decode_rows"]["count"] == b == len(BATCH[0])
    assert rep["decode_frames"]["count"] == b * t
    # the decoder given the engine's StageTimes adds no stage
    z = torch.randn(2, 24, 16, generator=torch.Generator().manual_seed(1))
    st = StageTimes()
    with torch.inference_mode():
        a = engine.model.decode(z, sid=torch.tensor([0, 1]), stages=st)
        want = engine.model.decode(z, sid=torch.tensor([0, 1]))
    assert torch.equal(a, want) and st.report() == {}
    assert len(got) == len(BATCH[0])


@pytest.mark.cuda
def test_vocos_device_stages_on_the_card():
    """VITS2-Vocos at its published widths on a card, f32 with TF32 off:
    the two event-timed stages are positive, and together shorter than
    the host's `decode` stage of the same call, which ends in the audio's
    copy to the host; the decoder's audio is bit-equal with its stages and
    without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stages' CUDA events")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = Config.from_json(os.path.join(
            ROOT, "examples", "baker", "configs", "vits2_vocos_v1.json"))
        cfg.num_phones, cfg.num_speakers = 16, 2
        torch.manual_seed(0)
        engine = SynthesisEngine(cfg, Synthesizer(cfg), PHONES,
                                 {"spk0": 0, "spk1": 1}, length_scale=5.0,
                                 device="cuda")
        ids = [[0] + [1 + k % 3 for k in range(n)] for n in (40, 90, 60)]
        sids = [0, 1, 0]
        engine.synthesize_ids_batch(ids, sids)
        for _ in range(3):
            engine.stage_times.reset()
            engine.synthesize_ids_batch(ids, sids)
            rep = engine.stage_times.report()
            vocos, istft = rep["vocos"]["total_s"], rep["istft"]["total_s"]
            assert rep["vocos"]["n"] == rep["istft"]["n"] == 1
            assert vocos > 0 and istft > 0
            assert vocos + istft < rep["decode"]["total_s"]
            assert not engine.stage_times._pending
        gen = torch.Generator(device="cuda").manual_seed(1)
        z = torch.randn(8, 704, 192, device="cuda", generator=gen)
        g = torch.randn(8, 1, 256, device="cuda", generator=gen)
        st = StageTimes()
        with torch.inference_mode():
            timed = engine.model.decode(z, g, stages=st)
            plain = engine.model.decode(z, g)
        assert torch.equal(timed, plain)
        assert st.report()["vocos"]["n"] == 1
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved

"""The benchmark's plain reference against the port (`wetts_tpu_torch`) on
the CPU, at small widths, with the weights the benchmark draws handed to
both: the only place where the two meet.

The engine's batch entry and its stream, the frontend's BERT scorer and its
phone ids: the reference, given the engine's generator state before a call,
reproduces the call's noise, its realized lengths and its audio.
"""

import numpy as np
import pytest
import torch

from benchmark.drivers import closed_stream as S
from benchmark.reference import serving as ref_serving
from benchmark.reference.text import bert as ref_bert
from benchmark.system import build_reference, build_system, make_weights
from benchmark.tests.tiny import tiny_config, tiny_stream_mix
from benchmark import traffic

CPU = torch.device("cpu")
# f32 on the CPU: the same operations in the same order, up to the
# convolution algorithm chosen for another batch size
AUDIO_TOL = 1e-5


def scales(cfg, length_scale):
    a = cfg["assumed"]
    return a["noise_scale"], length_scale, a["noise_scale_w"]


@pytest.mark.parametrize("name", ["vits_v1", "vits2_vocos_v1"])
def test_batch_matches_port(name):
    cfg = tiny_config(name)
    weights, engine, ls = build_system(cfg, 20260001, CPU)
    rng = np.random.default_rng(3)
    ids = [[0] + [int(i) for i in rng.integers(1, cfg["num_phones"], n)]
           for n in (5, 17, 11)]
    sids = [0, 1, 1]
    state = engine.generator.get_state()
    got = engine.synthesize_ids_batch(ids, sids)
    after = engine.generator.get_state()
    model = build_reference(cfg, CPU, weights)
    gen = torch.Generator().set_state(state)
    want = ref_serving.synthesize(model, ids, sids, scales(cfg, ls), gen,
                                  CPU)
    assert torch.equal(gen.get_state(), after)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        assert float(np.max(np.abs(g - w))) < AUDIO_TOL


@pytest.mark.parametrize("name", ["vits_v1", "vits2_vocos_v1"])
def test_weights_load_into_both(name):
    """Every reference parameter exists in the port with its shape, and the
    calibrated length scale gives the configured frames per phone."""
    from benchmark.system import build_program_model

    cfg = tiny_config(name)
    ref = build_reference(cfg, CPU)
    weights = make_weights({k: v.shape for k, v in ref.state_dict().items()},
                           7, CPU)
    port = build_program_model(cfg, weights, CPU)
    port_sd = port.state_dict()
    for k, v in weights.items():
        assert torch.equal(port_sd[k], v), k
    assert all(torch.isfinite(v).all() for v in weights.values())


def test_bert_scorer_matches_port():
    from wetts_tpu_torch.frontend.scorer import FrontendScorer
    from wetts_tpu_torch.models.bert_frontend import BertConfig, FrontendModel

    geometry = tiny_stream_mix()["bert"]
    ref = S.reference_bert({str(i): i for i in range(30)}, CPU, geometry)
    weights = make_weights({k: v.shape for k, v in ref.state_dict().items()},
                           11, CPU, stream=7)
    ref.load_state_dict(weights)
    port = FrontendModel(30, S.N_PROSODY, BertConfig(**geometry))
    port.load_state_dict(weights, strict=True)
    ids = np.array([1, 57, 300, 12, 9, 2])
    for a, b in zip(FrontendScorer(port)(ids), ref_bert.Scorer(ref)(ids)):
        assert a.shape == b.shape
        assert float(np.max(np.abs(a - b))) < 1e-6


@pytest.fixture(scope="module")
def stream_system():
    mix = tiny_stream_mix()
    cfg = tiny_config("vits_v1", 476)
    vocab, pinyin2id, lexicon = S.tables()
    ref = S.reference_bert(pinyin2id, CPU, mix["bert"])
    bert_weights = make_weights(
        {k: v.shape for k, v in ref.state_dict().items()}, 5, CPU, stream=7)
    frontend = S.program_frontend(bert_weights, vocab, pinyin2id, CPU,
                                  mix["bert"])
    weights, engine, ls = build_system(cfg, 5, CPU, frontend=frontend)
    ref_frontend = S.reference_frontend(
        ref_bert.Scorer(S.reference_bert(pinyin2id, CPU, mix["bert"],
                                         bert_weights)), vocab, pinyin2id)
    hanzi = [w for w in lexicon.words() if len(w) == 1]
    texts = traffic.text_requests(dict(mix, pool=6),
                                  np.random.default_rng(9), hanzi)
    texts.append("他说：“Hello，2024年的第1天很好。”谢谢！")
    return cfg, weights, engine, ls, ref_frontend, texts, mix


def test_frontend_ids_match_port(stream_system):
    from benchmark.system import phone_table

    _, _, engine, _, ref_frontend, texts, _ = stream_system
    from wetts_tpu_torch.serving.engine import MAX_CLAUSE_LEN
    from wetts_tpu_torch.text.segmenter import sentence_segment as port_seg

    phones = phone_table()
    for text in texts:
        port = [engine.text_to_phone_ids(s)[: S.TEXT_CAP]
                for s in port_seg(text, MAX_CLAUSE_LEN) or [text]]
        port = [p for p in port if p]
        assert S.reference_ids(ref_frontend, phones, text) == port


def test_stream_matches_port(stream_system):
    from benchmark.system import phone_table

    cfg, weights, engine, ls, ref_frontend, texts, mix = stream_system
    model = build_reference(cfg, CPU, weights)
    phones = phone_table()
    for text in texts[:3]:
        state = engine.generator.get_state()
        got = list(engine.stream_synthesize(text, "spk1", mix["block"],
                                            mix["pad"]))
        gen = torch.Generator().set_state(state)
        ids = S.reference_ids(ref_frontend, phones, text)
        want = []
        for lo in range(0, len(ids), S.GROUP):
            want += ref_serving.stream_chunks(
                model, ids[lo: lo + S.GROUP], 1, scales(cfg, ls), gen, CPU,
                mix["block"], mix["pad"])
        assert torch.equal(gen.get_state(), engine.generator.get_state())
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert float(np.max(np.abs(g - w))) < AUDIO_TOL

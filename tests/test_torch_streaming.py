"""Streaming synthesis, `/stream` and the dynamic batcher of the port against
the JAX package.

- the chunk math (`get_chunks`, `chunk_schedule`, `depad_audio`) equal to
  the JAX module's on seeded latents: t < block, t = 1, exact multiples of
  block, reflect-padded tails;
- `stream_synthesize` chunk by chunk against the JAX engine's, both paths
  (`stream_batch_tail` True and False), block 8 / pad 2 as in
  tests/test_serving.py, at scales (0, 1, 0), where synthesis is
  deterministic: equal chunk counts and sizes, samples within atol 2e-4 (the
  port's parity tolerance); raw phones, and text through G2pProsody with
  the fixed numpy scorer of tests/test_text_frontend.py;
- `/stream` of the port's TtsServer as the JAX server serves it: one HTTP
  chunk of int16 PCM per streamed chunk, exactly the engine's chunks
  clipped and scaled by 32767, a terminating empty chunk, 400 without
  text, and a client that leaves mid-stream does not stop the server;
- DynamicBatcher against the JAX one: buckets, concurrent requests equal to
  the unbatched engine within 2e-4, an error reaching every caller, and
  shutdown failing the queued requests.

Both engines get the same seeded random weights (tests/test_torch_engine.py's
config; chip_smoke.random_init_ on the port model, carried to the JAX one by
the JAX package's own `convert_synthesizer`, which is much quicker than a
flax init); one module-scoped JAX engine serves every test, its paths
chosen per call through its `stream_batch_tail` and `frontend` attributes.
"""

import copy
import http.client
import threading
import urllib.parse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import random_init_
from test_torch_engine import CFG, PHONES, SCALES, SPEAKERS
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.serving import batcher as jax_batcher
from wetts_tpu.serving import streaming as jax_streaming
from wetts_tpu.serving.engine import SynthesisEngine as JaxEngine
from wetts_tpu.text.frontend import G2pProsody as JaxG2pProsody
from wetts_tpu.text.g2p_en import G2pEn as JaxG2pEn
from wetts_tpu.text.lexicon import Lexicon as JaxLexicon
from wetts_tpu.text.tn import TextNormalizer as JaxTextNormalizer
from wetts_tpu.utils.convert import convert_synthesizer
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.serving import batcher, streaming
from wetts_tpu_torch.serving.engine import MAX_BATCH, SynthesisEngine
from wetts_tpu_torch.serving.server import TtsServer
from wetts_tpu_torch.text.frontend import CLS, SEP, UNK, G2pProsody
from wetts_tpu_torch.text.g2p_en import G2pEn
from wetts_tpu_torch.text.lexicon import Lexicon

ATOL = 2e-4
BLOCK, PAD = 8, 2
# 3 clauses, 2-4 chunks each (9 and 6 in all): the JAX engine compiles one
# encode and one tail stack (its 8-row bucket) for both
RAW_TEXT = ("a b c a b c a b c a b c a b c. c b a c b a c b a c b a c b. "
            "b b c a b c a c b a c b a c.")
FRONTEND_TEXT = "你好世界，hello。世界你好。你好"
# the frontend's phones, on the engine's 16 phone ids (OW1 is left out, so
# that one phone of `hello` is skipped as OOV)
FRONTEND_PHONES = {
    "sil": 0, "n": 1, "i2": 2, "h": 3, "ao3": 4, "sh": 5, "iii4": 6, "j": 7,
    "ie4": 8, "#0": 9, "#1": 10, "#3": 11, "#4": 12, "HH": 13, "AH0": 14,
    "L": 15}


def _scorer(ids):
    """tests/test_text_frontend.py's fixed scorer: hao3 over hao4, rank #1."""
    t = len(ids)
    poly = np.zeros((t, 2), np.float32)
    poly[:, 0] = 0.9
    pros = np.zeros((t, 5), np.float32)
    pros[:, 1] = 1.0
    return poly, pros


def _tables(tmp):
    lex = tmp / "lexicon.txt"
    lex.write_text(
        "你好 ni3 hao3\n你 ni3\n好 hao3,hao4\n世界 shi4 jie4\n<UNK> unk\n",
        encoding="utf8")
    cmu = tmp / "cmudict.txt"
    cmu.write_text("hello HH AH0 L OW1\nworld W ER1 L D\n", encoding="utf8")
    vocab = {CLS: 0, SEP: 1, UNK: 2, "你": 3, "好": 4, "世": 5, "界": 6}
    pinyin2phones = {"ni3": ["n", "i3"], "ni2": ["n", "i2"],
                     "hao3": ["h", "ao3"], "hao4": ["h", "ao4"],
                     "shi4": ["sh", "iii4"], "jie4": ["j", "ie4"]}
    return str(lex), str(cmu), vocab, {"hao3": 0, "hao4": 1}, pinyin2phones


class _JaxFrontend:
    """The JAX G2pProsody with TN in front: the JAX package's G2pProsody has
    no `normalize`, which the port's adds."""

    def __init__(self, g2p):
        self.g2p, self.tn = g2p, JaxTextNormalizer()

    def normalize(self, text):
        return self.tn.normalize(text)

    def compute(self, text):
        return self.g2p.compute(text)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    cfg = Config.from_dict(copy.deepcopy(CFG))
    model = random_init_(Synthesizer(cfg), 0).eval()
    jax_cfg = JaxConfig.from_dict(copy.deepcopy(CFG))
    params = convert_synthesizer(
        {k: v.numpy() for k, v in model.state_dict().items()}, jax_cfg)
    jax_engine = JaxEngine(jax_cfg,
                           {"params": jax.tree.map(jnp.asarray, params)},
                           PHONES, SPEAKERS, on_device_bucketing=False,
                           **SCALES)
    port = SynthesisEngine(cfg, model, PHONES, SPEAKERS, device="cpu",
                           **SCALES)
    lex, cmu, vocab, pinyin2id, pinyin2phones = _tables(
        tmp_path_factory.mktemp("frontend"))
    frontends = (
        _JaxFrontend(JaxG2pProsody(_scorer, vocab, JaxLexicon(lex), pinyin2id,
                                   pinyin2phones, JaxG2pEn(cmu))),
        G2pProsody(_scorer, vocab, Lexicon(lex), pinyin2id, pinyin2phones,
                   G2pEn(cmu)))
    return jax_engine, port, frontends


def _configure(engines, tail: bool, frontend: bool):
    jax_engine, port, frontends = engines
    for engine, fe in zip((jax_engine, port), frontends):
        engine.stream_batch_tail = tail
        engine.frontend = fe if frontend else None
        engine.phone2id = FRONTEND_PHONES if frontend else PHONES
    return jax_engine, port


# ---- the chunk math ------------------------------------------------------

@pytest.mark.parametrize("t,block,pad", [
    (1, 8, 2), (5, 8, 2), (8, 8, 2), (16, 8, 2), (17, 8, 2), (40, 40, 10),
    (121, 40, 10), (9, 8, 3), (3, 4, 2)])
def test_chunk_math_matches_jax(t, block, pad):
    rng = np.random.default_rng(t * 100 + block)
    z = rng.standard_normal((2, t, 3)).astype(np.float32)
    for fixed in (False, True):
        want = jax_streaming.get_chunks(z, block, pad, fixed_shape=fixed)
        got = streaming.get_chunks(z, block, pad, fixed_shape=fixed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.chunk_id, g.chunk_num, g.valid_frames, g.pad_end) == \
                (w.chunk_id, w.chunk_num, w.valid_frames, w.pad_end)
            np.testing.assert_array_equal(g.data, w.data)
            audio = rng.standard_normal((2, g.data.shape[1] * 4))
            np.testing.assert_array_equal(
                streaming.depad_audio(audio, g, block, pad, 4),
                jax_streaming.depad_audio(audio, w, block, pad, 4))
    sched = streaming.chunk_schedule(t, block, pad)
    want = jax_streaming.chunk_schedule(t, block, pad)
    assert len(sched) == len(want)
    for (gc, gi), (wc, wi) in zip(sched, want):
        np.testing.assert_array_equal(gi, wi)
        assert (gc.chunk_id, gc.chunk_num, gc.valid_frames, gc.pad_end) == \
            (wc.chunk_id, wc.chunk_num, wc.valid_frames, wc.pad_end)
    # the gathered fixed-shape windows are get_chunks' fixed-shape chunks
    for (_, idx), chunk in zip(sched, streaming.get_chunks(
            z, block, pad, fixed_shape=True)):
        np.testing.assert_array_equal(z[:, idx], chunk.data)


def test_stream_decode_matches_jax():
    rng = np.random.default_rng(7)
    z = rng.standard_normal((1, 29, 3)).astype(np.float32)

    def decode(c):  # any fixed per-frame map: 4 samples a frame
        return np.repeat(np.tanh(c.sum(-1)), 4, axis=1)

    got = list(streaming.stream_decode(z, decode, 8, 2, 4))
    want = list(jax_streaming.stream_decode(z, decode, 8, 2, 4))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(g.shape[1] for g in got) == 29 * 4


# ---- stream_synthesize ---------------------------------------------------

def _assert_same_chunks(got, want):
    assert len(got) == len(want) and len(got) >= 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize("tail", [True, False])
@pytest.mark.parametrize("frontend", [False, True])
def test_stream_matches_jax_engine(engines, tail, frontend):
    jax_engine, port = _configure(engines, tail, frontend)
    text = FRONTEND_TEXT if frontend else RAW_TEXT
    want = list(jax_engine.stream_synthesize(text, "spk0", BLOCK, PAD))
    got = list(port.stream_synthesize(text, "spk0", BLOCK, PAD))
    _assert_same_chunks(got, want)
    # the chunks add up to each clause's frames times the hop
    total = sum(g.size for g in got)
    assert total % port.hop == 0
    if frontend:
        assert port.text_to_phone_ids("你好世界") == \
            jax_engine.text_to_phone_ids("你好世界")


def test_stream_batched_tail_equals_per_chunk(engines, monkeypatch):
    """The port's two paths against each other: more clauses than MAX_BATCH
    (two encodes), and stacks of at most 3 rows, so that the tail takes
    several stacks at this small size."""
    from wetts_tpu_torch.serving import engine as engine_module

    monkeypatch.setattr(engine_module, "STREAM_TAIL_MAX", 3)
    _, port = _configure(engines, True, False)
    text = ". ".join(["a b c a b c a b c a b c"] * (MAX_BATCH + 2)) + "."
    batched = list(port.stream_synthesize(text, "spk1", BLOCK, PAD))
    port.stream_batch_tail = False
    per_chunk = list(port.stream_synthesize(text, "spk1", BLOCK, PAD))
    assert len(batched) > MAX_BATCH + 2 + 3
    _assert_same_chunks(batched, per_chunk)
    # one clause alone: the tail may be empty
    for text in ("a", "a b c a b c a b"):
        port.stream_batch_tail = True
        got = list(port.stream_synthesize(text, "spk0", BLOCK, PAD))
        port.stream_batch_tail = False
        want = list(port.stream_synthesize(text, "spk0", BLOCK, PAD))
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=ATOL)


def test_stream_totals_equal_synthesis_lengths(engines):
    """Each clause's streamed samples sum to y_len * hop: the streamed
    total equals the whole-utterance synthesis' length."""
    _, port = _configure(engines, True, False)
    for text in (RAW_TEXT, "a b c a b c a b c a b c"):
        streamed = sum(c.size for c in port.stream_synthesize(
            text, "spk0", streaming.DEFAULT_BLOCK, streaming.DEFAULT_PAD))
        assert streamed == port.synthesize(text, "spk0").size


# ---- /stream ---------------------------------------------------------------

def _read_stream(port_number: int, text: str, name: str = "spk0"):
    """GET /stream and undo the chunked transfer by hand: the PCM of each
    HTTP chunk, in order, up to the terminating empty one."""
    conn = http.client.HTTPConnection("127.0.0.1", port_number, timeout=120)
    query = urllib.parse.urlencode({"text": text, "name": name})
    conn.request("GET", "/stream?" + query)
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Transfer-Encoding") == "chunked"
    resp.chunked = False  # read the framing ourselves
    chunks = []
    while True:
        size = int(resp.fp.readline().strip(), 16)
        data = resp.fp.read(size)
        assert resp.fp.read(2) == b"\r\n"
        if size == 0:
            break
        chunks.append(np.frombuffer(data, np.int16))
    conn.close()
    return chunks


def test_stream_route(engines):
    _, port = _configure(engines, True, False)
    server = TtsServer(port, host="127.0.0.1", port=0)
    server.start_background()
    try:
        got = _read_stream(server.port, RAW_TEXT)
        want = [(np.clip(c, -1, 1) * 32767.0).astype(np.int16)
                for c in port.stream_synthesize(RAW_TEXT, "spk0")]
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)  # 2 bytes a sample
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.request("GET", "/stream")
        assert conn.getresponse().status == 400  # missing text
        conn.close()
    finally:
        server.shutdown()


class _LongStream:
    """An engine whose stream outlasts any socket buffer (100 MB of PCM),
    holding its lock as the engine's generator does."""

    sample_rate = 8000

    def __init__(self):
        self.lock, self.closed = threading.RLock(), threading.Event()

    def stream_synthesize(self, text, name):
        with self.lock:
            try:
                for _ in range(400):
                    yield np.zeros(1 << 17, np.float32)
            finally:
                self.closed.set()


def test_stream_route_survives_a_client_that_leaves():
    """A client that leaves mid-stream: the handler's write fails, the
    generator is closed in the handler's thread, the engine's lock is free
    again and the server goes on serving."""
    engine = _LongStream()
    server = TtsServer(engine, host="127.0.0.1", port=0)
    server.start_background()
    try:
        for _ in range(2):
            engine.closed.clear()
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            conn.request("GET", "/stream?text=a")
            resp = conn.getresponse()
            assert resp.status == 200 and len(resp.read(64)) == 64
            resp.close()  # mid-stream
            conn.close()
            assert engine.closed.wait(60)
            assert engine.lock.acquire(timeout=60)
            engine.lock.release()
    finally:
        server.shutdown()


# ---- the batcher -----------------------------------------------------------

def test_max_batch_matches_jax():
    """MAX_BATCH is the JAX batcher's largest bucket, and the dispatcher
    gathers at most max_batch queued requests a batch (the JAX batcher pads
    a batch to a bucket; the port's engine takes it as it comes)."""
    assert MAX_BATCH == jax_batcher.BATCH_BUCKETS[-1]
    assert batcher.DynamicBatcher.__init__.__defaults__[0] == MAX_BATCH
    engine = _Blocking()
    b = batcher.DynamicBatcher(engine, max_batch=2, max_delay_s=0.2)
    try:
        first = b.submit([1], 0)
        assert engine.entered.wait(30)
        queued = [b.submit([k], 0) for k in range(2, 7)]
        engine.release.set()
        for fut in [first] + queued:
            assert fut.result(timeout=30).size == 4
    finally:
        b.shutdown()
    assert b.batch_sizes == [1, 2, 2, 1]


def test_batcher_concurrent_requests_equal_engine(engines):
    _, port = _configure(engines, True, False)
    texts = ["a b c", "b c a b", "c c", "a b c a b c a", "b a. c a b"]
    want = [port.synthesize(t, "spk1") for t in texts]
    b = batcher.DynamicBatcher(port, max_batch=4, max_delay_s=0.05)
    results, errors = {}, []

    def req(i, text):
        try:
            results[i] = b.synthesize(text, "spk1")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    try:
        threads = [threading.Thread(target=req, args=(i, t))
                   for i, t in enumerate(texts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        b.shutdown()
    assert not errors, errors
    # the requests shared batches: the comparison is not the unbatched path
    # against itself
    assert max(b.batch_sizes) >= 2, b.batch_sizes
    for i, w in enumerate(want):
        assert results[i].shape == w.shape
        np.testing.assert_allclose(results[i], w, atol=ATOL)


class _Boom:
    def speaker_id(self, name):
        return 0

    def text_to_phone_ids(self, text):
        return [1, 2]

    def synthesize_ids_batch(self, ids, sids):
        raise RuntimeError("boom")


class _Blocking(_Boom):
    """Holds the dispatcher in its first batch until released."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def synthesize_ids_batch(self, ids, sids):
        self.entered.set()
        self.release.wait(30)
        return [np.zeros(4, np.float32) for _ in ids]


@pytest.mark.parametrize("module", [batcher, jax_batcher],
                         ids=["port", "jax"])
def test_batcher_propagates_errors(module):
    b = module.DynamicBatcher(_Boom(), max_delay_s=0.001)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.synthesize("a b. c d")
    finally:
        b.shutdown()


@pytest.mark.parametrize("module", [batcher, jax_batcher],
                         ids=["port", "jax"])
def test_batcher_shutdown_fails_queued_requests(module):
    engine = _Blocking()
    b = module.DynamicBatcher(engine, max_delay_s=0.0)
    first = b.submit([1], 0)
    assert engine.entered.wait(30)
    queued = [b.submit([2], 0), b.submit([3], 0)]
    threading.Timer(0.2, engine.release.set).start()
    b.shutdown()
    assert first.result(timeout=30).size == 4
    for fut in queued:
        with pytest.raises(RuntimeError, match="shut down"):
            fut.result(timeout=30)
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit([1], 0)


def test_server_batching_matches_engine(engines):
    """`/` through TtsServer(batching=True): concurrent requests, each the
    unbatched engine's audio; shutdown stops the batcher."""
    import base64
    import io
    import json
    import urllib.request
    import wave

    _, port = _configure(engines, True, False)
    server = TtsServer(port, host="127.0.0.1", port=0, batching=True,
                       max_delay_s=0.05)
    server.start_background()
    texts = ["a b c", "c b a b c", "b b", "a c a c a"]
    got = {}

    def req(i, text):
        query = urllib.parse.urlencode({"text": text, "name": "spk0"})
        url = f"http://127.0.0.1:{server.port}/?{query}"
        with urllib.request.urlopen(url, timeout=120) as r:
            body = json.loads(r.read())
        with wave.open(io.BytesIO(base64.b64decode(body["audio"]))) as w:
            got[i] = (body["status"], np.frombuffer(
                w.readframes(w.getnframes()), np.int16))

    try:
        threads = [threading.Thread(target=req, args=(i, t))
                   for i, t in enumerate(texts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        server.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        server.batcher.submit([1], 0)
    assert max(server.batcher.batch_sizes) >= 2, server.batcher.batch_sizes
    for i, text in enumerate(texts):
        status, pcm = got[i]
        want = port.synthesize(text, "spk0")
        want = (np.clip(want, -1, 1) * 32767.0).astype(np.int16)
        assert status == "ok" and pcm.shape == want.shape
        assert np.abs(pcm.astype(np.int32) - want).max() <= 8

"""The port's SynthesisEngine and TtsServer against the JAX engine.

Both engines get the same randomized weights and run at scales (0, 1, 0),
where synthesis is deterministic (the noise draws of the two frameworks
differ). Per request: equal sample counts (the text/frame buckets, the
max_frames clip, the decode bucket and the trim) and audio within atol 2e-4
(the slice's parity tolerance). The JAX engine runs its two-phase path
(on_device_bucketing=False).
"""

import base64
import copy
import io
import json
import urllib.error
import urllib.parse
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import jax_synthesizer, port_synthesizer
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.serving.engine import SynthesisEngine as JaxEngine
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.serving.engine import SynthesisEngine
from wetts_tpu_torch.serving.server import TtsServer

CFG = {  # tests/test_serving.py's engine config
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
SPEAKERS = {"spk0": 0, "spk1": 1}
SCALES = dict(noise_scale=0.0, length_scale=1.0, noise_scale_w=0.0)


@pytest.fixture(scope="module")
def engines():
    _, params = jax_synthesizer(CFG)
    # the JAX engine jits over its params: device arrays, not numpy
    jax_engine = JaxEngine(JaxConfig.from_dict(copy.deepcopy(CFG)),
                           jax.tree.map(jnp.asarray, params),
                           PHONES, SPEAKERS, on_device_bucketing=False,
                           **SCALES)
    port = SynthesisEngine(Config.from_dict(copy.deepcopy(CFG)),
                           port_synthesizer(CFG, params), PHONES, SPEAKERS,
                           device="cpu", **SCALES)
    return jax_engine, port


@pytest.mark.parametrize("text,speaker", [
    ("a b c a b", "spk1"),
    ("a zz b c", "spk0"),                         # OOV phone skipped
    ("a b c. b c a! c a", "spk1"),                # sentence split
    ("a b c a b c a b c a b c a b c a b c", None),  # forced clause split
    ("c c b", "nobody"),                          # speaker fallback
])
def test_synthesize_matches_jax_engine(engines, text, speaker):
    jax_engine, port = engines
    want = jax_engine.synthesize(text, speaker)
    got = port.synthesize(text, speaker)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.size > 0 and got.size % port.hop == 0
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_batch_matches_jax_engine(engines):
    jax_engine, port = engines
    batch = [[0, 1, 2, 3, 1], [0, 2, 3], [0, 1, 1, 2, 3, 1, 2, 3, 3]]
    sids = [0, 1, 1]
    want = jax_engine.synthesize_ids_batch(batch, sids)
    got = port.synthesize_ids_batch(batch, sids)
    assert [g.size for g in got] == [w.size for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-4)


def test_text_and_speaker_lookup(engines):
    jax_engine, port = engines
    for text in ("a b c", "a zz b", "", "zz"):
        assert port.text_to_phone_ids(text) == \
            jax_engine.text_to_phone_ids(text)
    for name in ("spk1", "spk0", "nobody", None):
        assert port.speaker_id(name) == jax_engine.speaker_id(name)


def test_server_routes(engines):
    _, port = engines
    server = TtsServer(port, host="127.0.0.1", port=0)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    try:
        query = urllib.parse.urlencode({"text": "a b c", "name": "spk1"})
        with urllib.request.urlopen(f"{base}/?{query}", timeout=60) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["sample_rate"] == 8000
        with wave.open(io.BytesIO(base64.b64decode(body["audio"]))) as w:
            assert w.getframerate() == 8000
            assert w.getnframes() == port.synthesize("a b c", "spk1").size
        with urllib.request.urlopen(f"{base}/demo", timeout=60) as r:
            assert r.status == 200 and b"<audio" in r.read()
        for path, code in (("/", 400), ("/stream", 400)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + path, timeout=60)
            assert err.value.code == code
        # /stream: chunked int16 PCM, 2 bytes a streamed sample
        with urllib.request.urlopen(f"{base}/stream?{query}",
                                    timeout=60) as r:
            assert r.status == 200
            assert r.headers["Transfer-Encoding"] == "chunked"
            pcm = r.read()
        assert len(pcm) == 2 * sum(
            c.size for c in port.stream_synthesize("a b c", "spk1"))
    finally:
        server.shutdown()


# -- the encode's and the flow's CUDA graphs, as far as the CPU can hold
# them: where the engine decides, and its capture and replay bookkeeping
# with a stand-in graph that recomputes on replay

NOISY = dict(noise_scale=0.667, length_scale=1.0, noise_scale_w=0.8)
BATCHES = [  # (ids, sids): two text buckets, two batch sizes
    ([[0, 1, 2, 3, 1], [0, 2, 3]], [0, 1]),
    ([[0, 3, 2, 1, 1, 2], [0, 1, 1]], [1, 0]),
    ([[0] + [1, 2, 3] * 12], [1]),
    ([[0, 2, 1] * 11 + [3], [0, 3] * 17], [0, 1]),
]


def noisy_engine(port, seed=7):
    return SynthesisEngine(Config.from_dict(copy.deepcopy(CFG)),
                           copy.deepcopy(port.model), PHONES, SPEAKERS,
                           device="cpu", seed=seed, **NOISY)


class StandInGraph:
    """A captured graph's contract on the CPU: the capture draws nothing
    (the generator's state is put back), and each replay reads the static
    inputs the capture was given and writes the static outputs it
    returned."""

    def __init__(self, fn, args, generator):
        state = generator.get_state()
        self.fn, self.args = fn, args
        self.out = fn(*args)
        generator.set_state(state)

    def replay(self):
        new = self.fn(*self.args)
        for dst, src in zip(flat(self.out), flat(new)):
            dst.copy_(src)


def flat(out):
    out = out if isinstance(out, tuple) else (out,)
    return [t for t in out if t is not None]


def stand_in_graphs(engine):
    """The engine with graphs that apply on the CPU, through StandInGraph."""
    def capture(fn, args):
        graph = StandInGraph(fn, args, engine.generator)
        return graph, graph.out

    engine._graphs_apply = lambda: True
    engine._capture = capture
    return engine


def test_cpu_engine_is_eager_and_draws_as_the_model_does(engines):
    """On the CPU no graph stage is recorded, and a batch call is the
    model's encode_prior, flow_reverse at the decode bucket and decode,
    drawn from a generator seeded as the engine's."""
    _, port = engines
    engine = noisy_engine(port)
    assert not engine._graphs_apply()
    model, gen = engine.model, torch.Generator().manual_seed(7)
    for ids, sids in BATCHES + BATCHES:
        got = engine.synthesize_ids_batch(ids, sids)
        text_pad, max_frames = engine._bucket(max(len(i) for i in ids))
        x = torch.zeros((len(ids), text_pad), dtype=torch.long)
        for r, row in enumerate(ids):
            x[r, : len(row)] = torch.tensor(row)
        with torch.inference_mode():
            z_p, y_len, y_mask, _, g = model.encode_prior(
                x, torch.tensor([len(i) for i in ids]), torch.tensor(sids),
                0.667, 1.0, 0.8, max_frames, gen)
            fb = engine._frame_bucket(int(y_len.max()), max_frames)
            z = model.flow_reverse(z_p[:, :fb], y_mask[:, :fb], g)
            audio = model.decode(z, g)[:, :, 0].numpy()
        assert len(got) == len(ids)
        for r, a in enumerate(got):
            np.testing.assert_array_equal(
                a, audio[r, : int(y_len[r]) * engine.hop])
        assert torch.equal(engine.generator.get_state(), gen.get_state())
    assert not {"graph_capture", "graph_replay"} & set(
        engine.stage_times.report())


def test_graphs_apply_only_on_a_card_with_the_generators_draws(engines):
    """The decision alone (nothing runs on the stand-in device): graphs on
    a card, none where draws are supplied or sharded or the model is in
    training mode."""
    from wetts_tpu_torch.ops import random as draws
    from wetts_tpu_torch.parallel import mesh

    _, port = engines
    engine = noisy_engine(port)
    assert not engine._graphs_apply()
    engine.device = torch.device("cuda")
    assert engine._graphs_apply()
    with draws.supplied([]):
        assert not engine._graphs_apply()
    with mesh.sharded(0, 2):
        assert not engine._graphs_apply()
    engine.model.train()
    assert not engine._graphs_apply()
    engine.model.eval()
    assert engine._graphs_apply()


def test_supplied_draws_keep_the_engine_eager(engines):
    """Inside `supplied`, an engine whose graphs would apply (its own
    decision, taken as on a card) runs eagerly on the supplied noise: no
    key is seen, nothing is captured, and the answer is the eager one."""
    from wetts_tpu_torch.ops import random as draws

    _, port = engines
    engine = stand_in_graphs(noisy_engine(port))

    def as_on_a_card():
        engine.device = torch.device("cuda")
        try:
            return SynthesisEngine._graphs_apply(engine)
        finally:
            engine.device = torch.device("cpu")

    engine._graphs_apply = as_on_a_card
    ids, sids = BATCHES[0]
    shapes, real = [], draws._draw

    def record(fn, shape, device, dtype, generator):
        shapes.append(tuple(shape))
        return real(fn, shape, device, dtype, generator)

    draws._draw = record
    try:
        engine._encode_flow_eager(ids, sids)
    finally:
        draws._draw = real
    noise = [torch.full(s, 0.5) for s in shapes]
    for _ in range(3):
        with draws.supplied(noise):
            z, y_len, _ = engine._encode_flow(ids, sids)
    assert not engine._seen and not engine._graphs
    with draws.supplied(noise):
        want, want_len, _ = engine._encode_flow_eager(ids, sids)
    assert torch.equal(z, want) and torch.equal(y_len, want_len)
    assert not {"graph_capture", "graph_replay"} & set(
        engine.stage_times.report())
    # and outside it the same engine takes its graphs
    for _ in range(2):
        engine._encode_flow(ids, sids)
    assert engine._graphs


def test_stand_in_graphs_equal_the_eager_engine(engines):
    """Every key runs eagerly once, is captured on its second call and
    replayed after; a replayed call draws and returns what the eager engine
    does, and a z handed out is the caller's own."""
    _, port = engines
    graphed = stand_in_graphs(noisy_engine(port))
    eager = noisy_engine(port)
    eager._encode_flow = eager._encode_flow_eager
    kept = []
    for ids, sids in BATCHES * 3:
        z, y_len, g = graphed._encode_flow(ids, sids)
        want_z, want_len, want_g = eager._encode_flow(ids, sids)
        assert torch.equal(z, want_z) and torch.equal(y_len, want_len)
        assert torch.equal(g, want_g)
        assert torch.equal(graphed.generator.get_state(),
                           eager.generator.get_state())
        kept.append((z, z.clone()))
        got = graphed.synthesize_ids_batch(ids, sids)
        want = eager.synthesize_ids_batch(ids, sids)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert all(torch.equal(z, copy_) for z, copy_ in kept)
    rep = graphed.stage_times.report()
    calls = 2 * len(BATCHES) * 3
    assert rep["encode"]["n"] == rep["flow"]["n"] == calls
    # the encode keys (batch, text bucket) and the flow keys, each captured
    # once: every stage after its key's second call replays
    captures = rep["graph_capture"]["n"]
    assert captures == len(graphed._graphs) and captures >= 4
    assert rep["graph_replay"]["n"] == 2 * calls - len(graphed._seen)


def test_a_repeated_key_replays_without_a_capture(engines):
    _, port = engines
    engine = stand_in_graphs(noisy_engine(port))
    ids, sids = BATCHES[0]
    for _ in range(2):
        engine._encode_flow(ids, sids)
    rep = engine.stage_times.report()
    captures, replays = rep["graph_capture"]["n"], rep["graph_replay"]["n"]
    engine._encode_flow(ids, sids)
    rep = engine.stage_times.report()
    assert rep["graph_capture"]["n"] == captures
    assert rep["graph_replay"]["n"] == replays + 2

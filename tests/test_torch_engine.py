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

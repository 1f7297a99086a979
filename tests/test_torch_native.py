"""The native serving binaries on the port (`utils/native_build.py`):
`tts_main` and `http_server_main` built with g++ from the repo's unchanged
`native/src`, its `embed_engine.cc` importing the port's module, driving
`wetts_tpu_torch.serving.embed` on the CPU (WETTS_DEVICE=cpu) on a tiny
bundle of a random port model.

- `tts_main` writes a WAV (RIFF header, the bundle's rate) whose PCM is
  within 1 int16 LSB of `cli.model.Model` on the same text; from a flags
  file with `--streaming` too;
- `http_server_main`: `/` answers with the WAV of the same PCM, `/stream`
  with chunked framing (even-sized chunks, a terminating empty chunk)
  whose PCM is within 1 LSB of the port's `embed.stream_synthesize`, and a
  request without text gets 400.
"""

from __future__ import annotations

import base64
import copy
import io
import json
import signal
import socket
import subprocess
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

from torch_port_common import small_cfg_dict
from wetts_tpu_torch.utils import native_build

REPO = str(native_build.REPO_DIR)
TEXT, STREAM_TEXT = "p1 p2 p3 p4 p1 p5", "p3 p1 p2 p6 p7 p2 p4 p1"


@pytest.fixture(scope="module")
def binaries():
    return {name: str(native_build.build(name))
            for name in ("tts_main", "http_server_main")}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A params.npz bundle of a random port model (small config)."""
    import torch

    from chip_smoke import random_init_
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.utils.convert import convert_synthesizer
    from wetts_tpu_torch.utils.params_io import save_params_npz

    cfg_dict = small_cfg_dict()
    cfg_dict["data"]["sampling_rate"] = 16000
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    with torch.no_grad():
        net = random_init_(Synthesizer(cfg), 3)
    d = tmp_path_factory.mktemp("native_bundle")
    save_params_npz(str(d / "params.npz"), convert_synthesizer(
        {k: v.numpy() for k, v in net.state_dict().items()}, cfg))
    (d / "config.json").write_text(json.dumps(cfg_dict))
    (d / "phones.txt").write_text(
        "".join(f"p{i} {i}\n" for i in range(1, 24)) + "sil 0\n")
    (d / "speaker.txt").write_text("spk0 0\nspk1 1\n")
    return str(d)


def env():
    return native_build.run_env({"WETTS_DEVICE": "cpu",
                                 "OMP_NUM_THREADS": "1"})


def model_pcm(bundle, text, speaker):
    from wetts_tpu_torch.cli.model import Model

    return Model(bundle, device="cpu").synthesis(text, speaker).astype(
        np.int32)


def read_wav(data: bytes):
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    with wave.open(io.BytesIO(data)) as w:
        return w.getframerate(), np.frombuffer(
            w.readframes(w.getnframes()), "<i2").astype(np.int32)


def test_tts_main_writes_the_models_audio(binaries, bundle, tmp_path):
    wav = tmp_path / "out.wav"
    proc = subprocess.run(
        [binaries["tts_main"], "--model_dir", bundle, "--text", TEXT,
         "--wav_path", str(wav), "--sname", "spk1", "--repo_root", REPO],
        env=env(), capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    rate, pcm = read_wav(wav.read_bytes())
    want = model_pcm(bundle, TEXT, "spk1")
    assert rate == 16000 and pcm.shape == want.shape
    assert np.abs(want).max() > 1000
    assert np.abs(pcm - want).max() <= 1


def test_tts_main_from_a_flags_file_streaming(binaries, bundle, tmp_path):
    wav = tmp_path / "out.wav"
    flags = tmp_path / "tts.flags"
    flags.write_text(f"# comment line\n--model_dir={bundle}\n--sname=spk0\n"
                     f"--repo_root={REPO}\n--streaming\n")
    proc = subprocess.run(
        [binaries["tts_main"], "--flags_file", str(flags), "--text",
         STREAM_TEXT, "--wav_path", str(wav)],
        env=env(), capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    rate, pcm = read_wav(wav.read_bytes())
    assert rate == 16000 and pcm.size > 0 and np.abs(pcm).max() > 0


def raw_get(port: int, path: str):
    """(status line, headers, body) of one GET, read off the socket as it
    came (the chunked framing kept)."""
    with socket.create_connection(("127.0.0.1", port), 60) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    status, *headers = head.decode().split("\r\n")
    return status, [h.lower() for h in headers], body


def dechunk(body: bytes):
    """The chunks of a chunked body, the terminating empty one excluded;
    raises unless the framing is whole."""
    chunks = []
    while True:
        size_line, _, body = body.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            assert body == b"\r\n", body[:40]
            return chunks
        chunks.append(body[:size])
        assert body[size:size + 2] == b"\r\n"
        body = body[size + 2:]


def test_http_server_main(binaries, bundle, monkeypatch):
    from wetts_tpu_torch.serving import embed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [binaries["http_server_main"], "--model_dir", bundle, "--port",
         str(port), "--repo_root", REPO],
        env=env(), stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", port), 1):
                    break
            except OSError:
                time.sleep(0.3)
                assert proc.poll() is None, proc.stderr.read().decode()
        url = (f"http://127.0.0.1:{port}/?text="
               + urllib.request.quote(TEXT) + "&name=spk1")
        with urllib.request.urlopen(url, timeout=120) as resp:
            payload = json.loads(resp.read())
        assert payload["status"] == "ok"
        rate, pcm = read_wav(base64.b64decode(payload["audio"]))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60)
        assert err.value.code == 400
        status, headers, body = raw_get(
            port, "/stream?text=" + urllib.request.quote(STREAM_TEXT))
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    assert status.endswith("200 OK")
    assert "transfer-encoding: chunked" in headers
    chunks = dechunk(body)
    assert chunks and all(len(c) % 2 == 0 for c in chunks)
    streamed = np.frombuffer(b"".join(chunks), "<i2").astype(np.int32)

    # the same requests in order through the same module in this process
    monkeypatch.setenv("WETTS_DEVICE", "cpu")
    monkeypatch.delenv("WETTS_PRECISION", raising=False)
    assert embed.init(bundle) == rate == 16000
    want = np.frombuffer(embed.synthesize(TEXT, "spk1"), "<i2").astype(
        np.int32)
    assert pcm.shape == want.shape and np.abs(pcm - want).max() <= 1
    want = np.frombuffer(b"".join(embed.stream_synthesize(STREAM_TEXT, "")),
                         "<i2").astype(np.int32)
    assert streamed.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(streamed - want).max() <= 1

"""Embedded-engine bootstrap for the native serving binaries (port of
wetts_tpu/serving/embed.py).

The reference's native runtime executes models through an embedded
inference library (ONNX Runtime sessions owned by C++ —
runtime/core/model/onnx_model.cc:29-96). Here C++ embeds CPython and drives
the port's `Model` through this module: C++ owns flag parsing,
orchestration, WAV I/O and the HTTP server and calls the functions below
through the CPython C API, with the byte contract of the JAX package's
module.

All return values crossing the ABI are plain bytes/ints so the C++ side
never needs numpy headers.
"""

from __future__ import annotations

import os

import numpy as np

_MODEL = None


def init(model_dir: str) -> int:
    """Load a model bundle directory; returns the sample rate.

    Env steering (the native binaries own only flag files, so serving
    options cross the ABI as environment variables):
    WETTS_PRECISION={f32,bf16,int8}, as the Python CLI's --precision
    (Model validates the value; a typo raises instead of silently serving
    f32), and WETTS_DEVICE, the torch device (`cuda` when unset; without a
    GPU that raises, `cpu` asks for the CPU).
    """
    global _MODEL
    from wetts_tpu_torch.cli.model import Model

    _MODEL = Model(model_dir,
                   precision=os.environ.get("WETTS_PRECISION", "f32"),
                   device=os.environ.get("WETTS_DEVICE") or None)
    return int(_MODEL.sample_rate)


def synthesize(text: str, name: str = "") -> bytes:
    """Full synthesis -> little-endian int16 PCM bytes.

    Same int16 scaling as the PyTorch inference script
    (wetts/vits/inference.py:102-110, mirrored by cli/model.py).
    """
    if _MODEL is None:
        raise RuntimeError("embed.init(model_dir) must be called first")
    audio = _MODEL.synthesis(text, name or None)
    return audio.astype("<i2").tobytes()


def stream_synthesize(text: str, name: str = ""):
    """Streaming synthesis -> iterator of int16 PCM byte chunks.

    Chunked-decoder semantics of TTS::StreamSynthesis
    (runtime/core/model/tts.cc:91-128).
    """
    if _MODEL is None:
        raise RuntimeError("embed.init(model_dir) must be called first")
    for piece in _MODEL.engine.stream_synthesize(text, name or None):
        pcm = np.clip(piece, -1.0, 1.0) * 32767.0
        yield pcm.astype("<i2").tobytes()

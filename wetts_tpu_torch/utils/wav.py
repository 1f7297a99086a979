"""WAV read/write (16-bit PCM + float), no external audio deps.

Native-equivalent of the reference's C++ WavReader/WavWriter
(runtime/core/frontend/wav.h) and its torchaudio loading path
(wetts/vits/data_utils.py:97-138). Uses the stdlib `wave` + numpy for
standard PCM files and a raw RIFF parser fallback for float32 wavs.

The port's own copy of `wetts_tpu/utils/wav.py`: the PyTorch package imports
nothing of the JAX one.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples in [-1, 1] of shape [T] or [C, T], rate)."""
    with open(path, "rb") as f:
        header = f.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    try:
        with wave.open(path, "rb") as w:
            rate = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif width == 1:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                    - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width {width}")
    except wave.Error:
        data, rate, ch = _read_wav_raw(path)
    if ch > 1:
        data = data.reshape(-1, ch).T
    return data, rate


def _read_wav_raw(path: str):
    """Minimal RIFF parser for IEEE-float wavs the stdlib refuses."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:4] == b"RIFF" and buf[8:12] == b"WAVE"
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        size = struct.unpack("<I", buf[pos + 4 : pos + 8])[0]
        body = buf[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"malformed wav: {path}")
    audio_format, ch, rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        samples = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported wav format {audio_format}/{bits}bit")
    return samples, rate, ch


def write_wav(path: str, data: np.ndarray, rate: int):
    """Write float32 [-1, 1] (or int16) samples as 16-bit PCM."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = np.clip(data, -1.0, 1.0)
        data = (data * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(data.T.tobytes() if data.ndim > 1 else data.tobytes())


def resample_poly(x: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling via scipy (replaces torchaudio Resample)."""
    if orig_rate == target_rate:
        return x
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(orig_rate, target_rate)
    return _rp(x, target_rate // g, orig_rate // g).astype(np.float32)

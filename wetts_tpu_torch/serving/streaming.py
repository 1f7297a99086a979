"""Streaming chunked decode: the overlap/pad/depad math.

Behavioral parity target: the canonical chunk math shared by the
reference's Python, C++ and Triton streamers (wetts/vits/inference_onnx.py:
37-76, runtime/core/model/vits_model.cc:96-153,
runtime/cpu_triton_stream/model_repo/stream_tts/1/model.py:58-111):

- z [B, T, C] is cut into blocks of `block` frames with `pad` overlap frames
  on each side (clamped at the sequence edges),
- each chunk decodes independently; `depad` trims the overlap samples:
  chunk 0 keeps [:block*upsample], the last chunk keeps
  [front_pad*upsample:] (minus reflect-padded tail if used), middle chunks
  keep [front_pad*upsample:(front_pad+block)*upsample],
- optional Triton-style reflect pad-to-MIN_CHUNK for the final chunk,
- concatenated output matches non-streaming decode up to the overlap
  approximation inherent to independent chunk decoding (the decoder's
  receptive field exceeds `pad`; the reference accepts the same tradeoff).

TPU-first: `fixed_shape=True` pads every chunk to block+2*pad frames with a
validity count so the decoder compiles ONCE (the reference hits this need
via MIN_CHUNK, stream_tts model.py:82-85; we generalize to every chunk).

The port's own copy of `wetts_tpu/serving/streaming.py`
(the PyTorch package imports nothing of the JAX one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

# reference defaults: C++ chunk 40/pad 10 (vits_model.h:61-62);
# Triton block 70 / pad 10 / MIN_CHUNK 65 (stream_tts model.py:12-14)
DEFAULT_BLOCK = 40
DEFAULT_PAD = 10


@dataclass
class Chunk:
    data: np.ndarray  # [B, T_chunk(+pad_to), C]
    chunk_id: int
    chunk_num: int
    valid_frames: int  # frames before any fixed-shape tail padding
    pad_end: int  # reflect-padded tail frames (last chunk only)


def get_chunks(
    z: np.ndarray,
    block: int = DEFAULT_BLOCK,
    pad: int = DEFAULT_PAD,
    min_chunk: Optional[int] = None,
    fixed_shape: bool = False,
) -> List[Chunk]:
    """z: [B, T, C] latent -> overlapped chunks."""
    t = z.shape[1]
    if block == -1:
        return [Chunk(z, 0, 1, t, 0)]
    num = math.ceil(t / block)
    chunks: List[Chunk] = []
    full = block + 2 * pad
    for i in range(num):
        start = max(0, i * block - pad)
        end = min((i + 1) * block + pad, t)
        piece = z[:, start:end]
        valid = piece.shape[1]
        pad_end = 0
        target = None
        if fixed_shape:
            target = full
        elif min_chunk is not None and i == num - 1 and valid < min_chunk:
            target = min_chunk
        if target is not None and valid < target:
            pad_end = target - valid
            # reflect-pad over time (stream_tts model.py:82-85); if the
            # chunk is shorter than the pad itself (only possible for very
            # short utterances — the reference's MIN_CHUNK never hits
            # this), edge-pad the remainder so the shape really is fixed
            pe = min(pad_end, valid - 1)
            piece = np.concatenate(
                [piece, piece[:, -2 : -2 - pe : -1]], axis=1)
            if piece.shape[1] < target:
                piece = np.concatenate(
                    [piece, np.repeat(piece[:, -1:],
                                      target - piece.shape[1], axis=1)],
                    axis=1)
        chunks.append(Chunk(piece, i, num, valid, pad_end))
    return chunks


def depad_audio(
    audio: np.ndarray,
    chunk: Chunk,
    block: int,
    pad: int,
    upsample: int,
) -> np.ndarray:
    """Trim one decoded chunk [B, T_samples] to its non-overlapped span."""
    # drop samples from fixed-shape / min-chunk tail padding first
    if chunk.pad_end > 0:
        audio = audio[:, : chunk.valid_frames * upsample]
    front_pad = min(chunk.chunk_id * block, pad)
    if chunk.chunk_id == 0:
        return audio[:, : block * upsample]
    if chunk.chunk_id == chunk.chunk_num - 1:
        return audio[:, front_pad * upsample :]
    return audio[:, front_pad * upsample : (front_pad + block) * upsample]


def stream_decode(
    z: np.ndarray,
    decode_fn,
    block: int = DEFAULT_BLOCK,
    pad: int = DEFAULT_PAD,
    upsample: int = 256,
    fixed_shape: bool = True,
) -> Iterator[np.ndarray]:
    """Yield depadded audio chunks; concat ~= non-streaming decode.

    decode_fn: [B, T_chunk, C] latent -> [B, T_chunk*upsample(, 1)] audio.
    """
    for chunk in get_chunks(z, block, pad, fixed_shape=fixed_shape):
        audio = np.asarray(decode_fn(chunk.data))
        if audio.ndim == 3:
            audio = audio[:, :, 0]
        yield depad_audio(audio, chunk, block, pad, upsample)


def chunk_schedule(t: int, block: int, pad: int
                   ) -> List[Tuple[Chunk, np.ndarray]]:
    """Device-side streaming plan: (Chunk metadata, gather indices).

    Same chunk/overlap/reflect math as get_chunks, expressed as per-chunk
    absolute frame indices of length block+2*pad, so a jitted decoder can
    gather its fixed-shape input directly from the on-device z — no
    host round-trip of the latent (get_chunks copies z to host; on a
    remote-attached TPU each transfer costs far more than the decode).
    """
    full = block + 2 * pad
    num = math.ceil(t / block)
    out = []
    for i in range(num):
        start = max(0, i * block - pad)
        end = min((i + 1) * block + pad, t)
        valid = end - start
        j = np.arange(full)
        # reflect-pad past the valid span (stream_tts model.py:82-85);
        # clamped into the chunk so 1-frame chunks stay in range
        idx = np.where(j < valid,
                       start + j,
                       np.clip(end - 2 - (j - valid), start, end - 1))
        out.append((Chunk(None, i, num, valid, full - valid),
                    idx.astype(np.int32)))
    return out

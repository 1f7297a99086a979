"""What the served engine is to produce, worked out in plain PyTorch from the
request ids, the speakers, the configuration's scales and the state of the
noise generator before the call.

The published engine's semantics (wenet-e2e/wetts runtime tts.cc, and the
buckets the port inherits from the JAX engine): phone ids are padded to the
smallest text bucket that holds the longest row, the realized lengths are
clipped at 12 frames per bucket position, the flow and the decoder run at
the smallest frame bucket covering the longest realized length plus a
10-frame margin, and each row is trimmed to its realized length. The noise
the engine draws depends on those padded shapes, so the reference pads
alike and draws from a generator set to the program's state before the
call; that state is the only thing of the program it reads.

Streaming: the latent is cut into chunks of `block` frames with `pad`
frames of overlap on each side, each chunk padded by reflection to
block + 2 * pad frames, decoded alone, and trimmed to its span.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

TEXT_BUCKETS = (32, 64, 128, 192)
FRAMES_PER_TEXT = 12
FRAME_BUCKETS = (96, 160, 224, 288, 352, 416, 480, 544, 608, 672, 736,
                 768, 1152, 1536, 2304)
DECODE_MARGIN = 10
# rows of one call the reference decodes at a time, so that it fits
DECODE_ROWS = 2


def text_bucket(n: int) -> Tuple[int, int]:
    for b in TEXT_BUCKETS:
        if n <= b:
            return b, b * FRAMES_PER_TEXT
    return TEXT_BUCKETS[-1], TEXT_BUCKETS[-1] * FRAMES_PER_TEXT


def frame_bucket(max_len: int, cap: int) -> int:
    need = max_len + DECODE_MARGIN
    for b in FRAME_BUCKETS:
        if need <= b <= cap:
            return b
    return cap


@torch.no_grad()
def encode_flow(model, ids_list: Sequence[Sequence[int]], sids, scales,
                generator: torch.Generator, device):
    """-> (z [B, C, frame bucket], y_lengths on the host, g)."""
    n = len(ids_list)
    text_pad, max_frames = text_bucket(max(len(i) for i in ids_list))
    x = torch.zeros((n, text_pad), dtype=torch.long)
    for row, ids in enumerate(ids_list):
        x[row, : len(ids)] = torch.tensor(ids)
    xl = torch.tensor([len(i) for i in ids_list])
    g = model.speaker(torch.tensor(list(sids)).to(device))
    noise_scale, length_scale, noise_scale_w = scales
    z_p, y_len, y_mask = model.encode_prior(
        x.to(device), xl.to(device), g, noise_scale, length_scale,
        noise_scale_w, max_frames, generator)
    y_len = y_len.cpu()
    fb = frame_bucket(int(y_len.max()), max_frames)
    z = model.flow_reverse(z_p[:, :, :fb], y_mask[:, :, :fb], g)
    return z, y_len, g


@torch.no_grad()
def synthesize(model, ids_list, sids, scales, generator, device
               ) -> List[np.ndarray]:
    """One engine call: each row's audio, trimmed to its realized length."""
    z, y_len, g = encode_flow(model, ids_list, sids, scales, generator,
                              device)
    out = []
    for lo in range(0, z.shape[0], DECODE_ROWS):
        audio = model.decode(z[lo: lo + DECODE_ROWS],
                             g[lo: lo + DECODE_ROWS]).cpu().numpy()
        for k in range(audio.shape[0]):
            out.append(audio[k, : int(y_len[lo + k]) * model.hop])
    return out


def chunk_windows(t: int, block: int, pad: int):
    """(frame indices of length block + 2 * pad, front samples to drop in
    frames, frames to keep, is last) of each chunk of a t-frame latent."""
    full = block + 2 * pad
    num = math.ceil(t / block)
    out = []
    for i in range(num):
        start = max(0, i * block - pad)
        end = min((i + 1) * block + pad, t)
        valid = end - start
        j = np.arange(full)
        idx = np.where(j < valid, start + j,
                       np.clip(end - 2 - (j - valid), start, end - 1))
        front = min(i * block, pad)
        out.append((idx, valid, front, i))
    return out, num


@torch.no_grad()
def stream_chunks(model, ids_list, sid: int, scales, generator, device,
                  block: int, pad: int, rows: int = 16) -> List[np.ndarray]:
    """Every chunk of a stream of clauses, in order: one encode over every
    clause, then each chunk decoded alone and trimmed to its span."""
    z, y_len, g = encode_flow(model, ids_list, [sid] * len(ids_list),
                              scales, generator, device)
    entries = []
    for row in range(len(ids_list)):
        wins, num = chunk_windows(int(y_len[row]), block, pad)
        for idx, valid, front, i in wins:
            entries.append((row, idx, valid, front, i, num))
    hop, out = model.hop, []
    for lo in range(0, len(entries), rows):
        grp = entries[lo: lo + rows]
        r = torch.tensor([e[0] for e in grp], device=device)
        i = torch.from_numpy(np.stack([e[1] for e in grp])).to(device)
        zz = z[r[:, None], :, i].transpose(1, 2)  # [N, C, frames]
        audio = model.decode(zz, g[r]).cpu().numpy()
        for k, (_, _, valid, front, ci, num) in enumerate(grp):
            a = audio[k, : valid * hop]
            if ci == 0:
                a = a[: block * hop]
            elif ci == num - 1:
                a = a[front * hop:]
            else:
                a = a[front * hop: (front + block) * hop]
            out.append(a)
    return out

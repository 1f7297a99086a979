"""Polyphase resampling on the device (port of wetts_tpu/ops/resample.py):
the WavLM loss resamples waveforms from the model's rate to 16 kHz before
the frozen WavLM (reference losses.py:68, torchaudio's Resample).

`scipy.signal.resample_poly` semantics with its default filter (a
kaiser(5.0)-windowed sinc of 2 * 10 * max(up, down) + 1 taps, `firwin`,
scaled by `up`): y[m] = sum_j x[j] * h[half + m * down - up * j].

The JAX package dilates the input by `up` (`lhs_dilation`) and convolves
with stride `down`. Torch has no input dilation, and zero-stuffing a
22.05 kHz waveform 320x before an 8821-tap filter would do 320x the work.
Here the filter is split into its polyphase components instead: output
m = up * s + t reads x[s * down + floor(t * down / up) - p] against
h[half + up * p + (t * down) % up], so the `up` output phases are the `up`
channels of one strided `conv1d` over the input, interleaved afterwards.
Each phase has about n_taps / up taps; the conv's window also spans the
`down` inputs of one stride (at 24 kHz -> 16 kHz 32 taps a phase, at
22.05 kHz -> 16 kHz 467, against 8821 on the zero-stuffed input). The
function is differentiable in its input.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _poly_filter(up: int, down: int) -> np.ndarray:
    """scipy resample_poly's default filter: kaiser(5.0), half length
    10 * max(up, down), scaled by up."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    taps = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (taps * up).astype(np.float32)


@functools.lru_cache(maxsize=None)
def polyphase_bank(up: int, down: int) -> tuple:
    """(weights [up, 1, L], left pad): phase t's taps in correlation order,
    so that conv1d(pad(x), weights, stride=down)[:, t, s] is output
    up * s + t."""
    h = _poly_filter(up, down)
    half = (len(h) - 1) // 2
    taps = []  # per phase: (offset c_t, {p: tap})
    for t in range(up):
        c, r = divmod(t * down, up)
        ps = range(-((half + r) // up), (half - r) // up + 1)
        taps.append((c, {p: h[half + up * p + r] for p in ps}))
    # input index s * down + c - p sits at q = c - p + pad in the window
    pad = max(max(ph) - c for c, ph in taps)
    length = max(c + pad - min(ph) for c, ph in taps) + 1
    bank = np.zeros((up, 1, length), np.float32)
    for t, (c, ph) in enumerate(taps):
        for p, tap in ph.items():
            bank[t, 0, c + pad - p] = tap
    return bank, pad


def resample(x: torch.Tensor, orig_rate: int, target_rate: int
             ) -> torch.Tensor:
    """x [B, T] -> [B, ceil(T * target / orig)], resample_poly semantics;
    x itself where the rates are equal."""
    if orig_rate == target_rate:
        return x
    g = gcd(orig_rate, target_rate)
    up, down = target_rate // g, orig_rate // g
    bank, pad = polyphase_bank(up, down)
    t = x.shape[-1]
    out_len = -(-t * up // down)
    n_out = -(-out_len // up)  # outputs per phase
    length = bank.shape[-1]
    right = max(0, (n_out - 1) * down + length - pad - t)
    w = torch.from_numpy(bank).to(x.device, x.dtype)
    y = F.conv1d(F.pad(x[:, None, :], (pad, right)), w, stride=down)
    # [B, up, S] -> [B, S * up], output up * s + t from phase t
    return y[:, :, :n_out].transpose(1, 2).reshape(x.shape[0], -1)[
        :, :out_len]

"""STFT / mel-spectrogram DSP (port of wetts_tpu/ops/spectral.py; reference
wetts/vits/utils/mel_processing.py):

- reflect-pad by (n_fft - hop) / 2 on both sides, then a center=False STFT
  with a periodic Hann window (:42-76),
- magnitude = sqrt(re^2 + im^2 + 1e-6) (:74),
- slaney-scale, slaney-normalized mel filterbank (:80-95; the published
  formula, librosa is not a dependency),
- log compression log(clamp(x, min=1e-5)) (:10-12);
- the inverse STFT of the Vocos decoder (torchaudio's InverseSpectrogram,
  decoders.py:281-304): Hann window, overlap-add, division by the
  squared-window envelope, n_fft / 2 trimmed at each end.

The JAX package frames the signal and multiplies by a real DFT basis so the
transform lands on the TPU's matrix unit; that is a device workaround, not
the function. Here the transforms are `torch.stft` and `torch.istft` (cuFFT
on the GPU), which are differentiable: the mel loss backpropagates through
them into the decoder.
Waveforms are [B, T]; spectrograms are [B, frames, bins], as in the JAX
package.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
            ).astype(np.float32)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_part = min_log_mel + np.log(
            np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_part, f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """[n_bins, n_mels] slaney-scale, slaney-normalized mel filterbank
    (librosa.filters.mel(htk=False, norm='slaney') transposed)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, args: tuple, device: torch.device) -> torch.Tensor:
    """The window or the filterbank as a tensor on `device`, made once, and
    made outside inference mode whoever asks first: an inference tensor
    kept here would refuse every later training step that saves it for
    backward (torch.stft does)."""
    make = hann_window if kind == "window" else mel_filterbank
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)


def spectrogram(y: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, eps: float = 1e-6) -> torch.Tensor:
    """Linear-magnitude spectrogram, [B, T] -> [B, T // hop, n_bins] for T a
    multiple of hop: reflect-padded, center=False."""
    pad = (n_fft - hop_length) // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(
        y, n_fft, hop_length=hop_length, win_length=win_length,
        window=_on_device("window", (win_length,), y.device), center=False,
        onesided=True, return_complex=True)
    spec = torch.view_as_real(spec)
    mag = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2 + eps)
    return mag.transpose(1, 2)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5,
                              c: float = 1.0) -> torch.Tensor:
    """log(clamp(x, clip_val) * C)."""
    return torch.log(torch.clamp_min(x, clip_val) * c)


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int,
                sample_rate: int, fmin: float = 0.0,
                fmax: Optional[float] = None) -> torch.Tensor:
    """[B, F, n_bins] linear magnitudes -> [B, F, n_mels] log-mel."""
    fb = _on_device("mel", (sample_rate, n_fft, n_mels, fmin, fmax),
                    spec.device)
    return dynamic_range_compression(spec @ fb)


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int,
                    sample_rate: int, hop_length: int, win_length: int,
                    fmin: float = 0.0, fmax: Optional[float] = None
                    ) -> torch.Tensor:
    """[B, T] waveform -> [B, F, n_mels] log-mel."""
    return spec_to_mel(spectrogram(y, n_fft, hop_length, win_length), n_fft,
                       n_mels, sample_rate, fmin, fmax)


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
          hop_length: int, win_length: int) -> torch.Tensor:
    """Inverse STFT, center=True: [B, F, n_bins] real and imaginary parts
    -> waveform [B, (F - 1) * hop] (the JAX package's `istft`).

    `torch.istft` raises where the squared-window envelope falls below
    1e-11 inside the kept samples, where the JAX function floors the
    envelope at 1e-11 instead. With hop = n_fft / 4, as in every config
    (1024 / 256), each kept sample lies in [n_fft / 4, n_fft / 2) of some
    frame, where the Hann window is at least 0.5: the envelope is at least
    0.25 for any F >= 2, so neither case is reached and the two agree.

    The imaginary parts of the DC and Nyquist bins are dropped, as the JAX
    function's inverse basis drops them. A real inverse FFT leaves its
    result undefined where they are not 0: cuFFT's changed with the batch
    size on the H100 (3.4e-3 apart at 64 x 61 frames, against 16 x 61, for
    spectra of magnitude 7).
    """
    assert n_fft % hop_length == 0, "istft requires hop | n_fft"
    window = _on_device("window", (win_length,), spec_real.device)
    spec_imag = spec_imag.clone()
    spec_imag[..., 0] = 0.0  # DC
    if n_fft % 2 == 0:
        spec_imag[..., -1] = 0.0  # Nyquist
    spec = torch.complex(spec_real, spec_imag).transpose(1, 2)
    return torch.istft(spec, n_fft, hop_length=hop_length,
                       win_length=win_length, window=window, center=True)

"""Mel-cepstral distortion (MCD) evaluation: generated vs reference audio
(the port's own copy of wetts_tpu/bin/eval_mcd.py).

The reference's only synthesis-quality check is listening to the ONNX
inference output (examples/baker/run.sh:83-88); BASELINE.json's quality
metric for this framework is "mel MCD vs reference", so this tool makes
that gate runnable: the standard MCD_13 with DTW alignment,

    MCD = (10 / ln 10) * sqrt(2) * mean_path ||c_gen[1:13] - c_ref[1:13]||_2

over mel-cepstra (DCT-II of the log-mel spectrogram; c0 — overall energy /
gain — is excluded, so MCD is invariant to pure level differences).
Frames are aligned by dynamic time warping, since generated and reference
audio differ in duration.

Modes:
  --gen g.wav --ref r.wav             one pair
  --test_file data/test.txt --gen_dir test_audio
      batch over a recipe manifest (wavpath|speaker|phones): pairs each
      manifest wavpath with gen_dir/<basename>.wav (the layout
      bin/infer_vits.py writes); the baker recipe's stage 4.

Prints one JSON line: per-pair MCDs + the corpus mean.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _dct_matrix(n_mcep: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_mcep, n_mels]."""
    n = np.arange(n_mels)
    k = np.arange(n_mcep)[:, None]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels))
    basis *= np.sqrt(2.0 / n_mels)
    basis[0] *= np.sqrt(0.5)
    return basis


def mel_cepstra(
    wav: np.ndarray,
    sample_rate: int,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    n_mcep: int = 13,
) -> np.ndarray:
    """[T_samples] waveform -> [T_frames, n_mcep] mel-cepstra.

    Same mel front-end as the training losses (ops/spectral.py: reflect
    pad, hann, center=False, slaney mel, log(clamp 1e-5)), then DCT-II.
    Pure numpy — the eval tool must run without a device.
    """
    from wetts_tpu_torch.ops.spectral import hann_window, mel_filterbank

    wav = np.asarray(wav, np.float32)
    pad = (n_fft - hop_length) // 2
    y = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    if n_frames <= 0:
        return np.zeros((0, n_mcep), np.float32)
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    win = np.asarray(hann_window(win_length))
    if win_length < n_fft:  # center-pad the window (torch.stft semantics)
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    frames = y[idx] * win
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1))
    mel = spec @ np.asarray(mel_filterbank(sample_rate, n_fft, n_mels))
    logmel = np.log(np.maximum(mel, 1e-5))
    return (logmel @ _dct_matrix(n_mcep, n_mels).T).astype(np.float32)


def dtw_path(a: np.ndarray, b: np.ndarray):
    """Classic DTW over Euclidean frame distances.

    a: [Ta, D], b: [Tb, D] -> (ia, ib) index arrays of the optimal
    monotonic alignment path.
    """
    ta, tb = len(a), len(b)
    dist = np.sqrt(
        np.maximum(
            (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
            - 2.0 * (a @ b.T), 0.0))
    acc = np.full((ta + 1, tb + 1), np.inf, np.float64)
    acc[0, 0] = 0.0
    for i in range(1, ta + 1):
        # vectorized row update is possible but the plain loop keeps the
        # classic recurrence obvious; eval sets are small
        row = dist[i - 1]
        prev = acc[i - 1]
        cur = acc[i]
        for j in range(1, tb + 1):
            cur[j] = row[j - 1] + min(prev[j], cur[j - 1], prev[j - 1])
    ia, ib = [], []
    i, j = ta, tb
    while i > 0 and j > 0:
        ia.append(i - 1)
        ib.append(j - 1)
        moves = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(moves, key=lambda m: m[0])
    return np.array(ia[::-1]), np.array(ib[::-1])


MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mcd_from_cepstra(c_gen: np.ndarray, c_ref: np.ndarray,
                     use_dtw: bool = True) -> float:
    """MCD_13 between two cepstra sequences (c0 excluded)."""
    g, r = c_gen[:, 1:], c_ref[:, 1:]
    if len(g) == 0 or len(r) == 0:
        return float("nan")
    if use_dtw:
        ia, ib = dtw_path(g, r)
        g, r = g[ia], r[ib]
    else:
        n = min(len(g), len(r))
        g, r = g[:n], r[:n]
    return float(MCD_CONST * np.mean(
        np.sqrt(((g - r) ** 2).sum(axis=1))))


def mcd_wav(gen: np.ndarray, ref: np.ndarray, sample_rate: int,
            use_dtw: bool = True, **kw) -> float:
    return mcd_from_cepstra(mel_cepstra(gen, sample_rate, **kw),
                            mel_cepstra(ref, sample_rate, **kw),
                            use_dtw=use_dtw)


def _load(path: str, target_sr: int | None):
    from wetts_tpu_torch.utils.wav import read_wav, resample_poly

    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    if target_sr is not None and sr != target_sr:
        wav = resample_poly(wav, sr, target_sr)
        sr = target_sr
    return wav.astype(np.float32), sr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", help="generated wav")
    ap.add_argument("--ref", help="reference wav")
    ap.add_argument("--test_file",
                    help="recipe manifest wavpath|speaker|phones")
    ap.add_argument("--gen_dir",
                    help="dir of generated <basename>.wav files "
                         "(bin/infer_vits.py --outdir layout)")
    ap.add_argument("--sample_rate", type=int, default=None,
                    help="resample both sides to this rate before scoring "
                         "(defaults to the reference wav's rate per pair)")
    ap.add_argument("--no-dtw", action="store_true",
                    help="score frame-by-frame without DTW alignment")
    args = ap.parse_args(argv)

    pairs = []
    if args.gen and args.ref:
        pairs.append((args.gen, args.ref))
    elif args.test_file and args.gen_dir:
        with open(args.test_file, encoding="utf8") as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) < 3:
                    continue
                ref_path = parts[0]
                name = os.path.splitext(os.path.basename(ref_path))[0]
                gen_path = os.path.join(args.gen_dir, name + ".wav")
                if os.path.exists(gen_path) and os.path.exists(ref_path):
                    pairs.append((gen_path, ref_path))
                else:
                    print(f"skipping {name}: missing "
                          f"{gen_path if not os.path.exists(gen_path) else ref_path}",
                          file=sys.stderr)
    else:
        ap.error("need --gen/--ref or --test_file/--gen_dir")

    per_pair = {}
    for gen_path, ref_path in pairs:
        ref, sr = _load(ref_path, args.sample_rate)
        gen, _ = _load(gen_path, sr)
        name = os.path.splitext(os.path.basename(ref_path))[0]
        per_pair[name] = round(
            mcd_wav(gen, ref, sr, use_dtw=not args.no_dtw), 4)

    values = [v for v in per_pair.values() if np.isfinite(v)]
    print(json.dumps({
        "metric": "mel_cepstral_distortion_db",
        "mean": round(float(np.mean(values)), 4) if values else None,
        "n_pairs": len(values),
        "dtw": not args.no_dtw,
        "per_pair": per_pair,
    }))


if __name__ == "__main__":
    main()

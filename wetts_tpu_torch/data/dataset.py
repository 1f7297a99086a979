"""Manifest dataset + lookup tables.

Behavioral parity target: wetts/vits/data_utils.py:14-225 —
- manifest lines `wavpath|speaker|phone phone ...` with an optional 4th
  `|num_frames` field (precomputed by tools/compute_spec_length.py),
- phone/speaker tables `token id` per line,
- length filter: text len in [min,max], frames estimated from the wav byte
  size when not precomputed (data_utils.py:61-86),
- per-utterance loading: wav -> float32 [-1,1], resample to target rate.

The dataset returns RAW waveforms; linear/mel spectrograms are computed on
the device inside the train step (ops/spectral.py), so the host never runs
DSP and batches stay bucket-shaped.

The port's own copy of `wetts_tpu/data/dataset.py`: the PyTorch package
imports nothing of the JAX one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from wetts_tpu_torch.config import DataConfig
from wetts_tpu_torch.utils.wav import read_wav, resample_poly


def read_table(path: str) -> Dict[str, int]:
    """`token id` per line -> dict (reference utils/task.py table loading)."""
    table = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2:
                table[parts[0]] = int(parts[1])
            elif len(parts) == 1 and parts[0]:
                table[parts[0]] = len(table)
    return table


@dataclass
class Utterance:
    wav_path: str
    speaker: str
    phone_ids: np.ndarray  # int32 [T_text]
    num_frames: int  # spec frames (estimated or precomputed)


class TTSDataset:
    def __init__(
        self,
        manifest_path: str,
        phone_table: Dict[str, int],
        speaker_table: Optional[Dict[str, int]],
        data_cfg: DataConfig,
    ):
        self.cfg = data_cfg
        self.phone_table = phone_table
        self.speaker_table = speaker_table or {}
        self.items: List[Utterance] = []
        skipped = 0
        with open(manifest_path, encoding="utf8") as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) < 3:
                    continue
                wav_path, speaker, phones = parts[0], parts[1], parts[2]
                tokens = phones.split()
                if not (data_cfg.min_text_len <= len(tokens)
                        <= data_cfg.max_text_len):
                    skipped += 1
                    continue
                try:
                    ids = np.array([phone_table[t] for t in tokens],
                                   dtype=np.int32)
                except KeyError:
                    skipped += 1
                    continue
                if len(parts) >= 4 and parts[3].strip():
                    frames = int(parts[3])
                else:
                    # byte-size estimate: 16-bit PCM -> frames ~ bytes/(2*hop)
                    # (reference data_utils.py:75-80)
                    try:
                        frames = os.path.getsize(wav_path) // (
                            2 * data_cfg.hop_length)
                    except OSError:
                        frames = len(tokens) * 8
                self.items.append(Utterance(wav_path, speaker, ids, frames))
        self.skipped = skipped

    def __len__(self) -> int:
        return len(self.items)

    def speaker_id(self, speaker: str) -> int:
        if not self.speaker_table:
            return 0
        return self.speaker_table.get(speaker, 0)

    def load_audio(self, idx: int) -> np.ndarray:
        """float32 waveform at the configured rate, length multiple of hop."""
        utt = self.items[idx]
        wav, rate = read_wav(utt.wav_path)
        if wav.ndim > 1:
            wav = wav[0]
        if rate != self.cfg.sampling_rate:
            wav = resample_poly(wav, rate, self.cfg.sampling_rate)
        # trim to a whole number of frames so T_wav = T_spec * hop
        hop = self.cfg.hop_length
        n = (len(wav) // hop) * hop
        return wav[:n].astype(np.float32)

    def example(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(phone_ids, waveform, speaker_id)."""
        utt = self.items[idx]
        return utt.phone_ids, self.load_audio(idx), self.speaker_id(utt.speaker)

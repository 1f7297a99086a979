"""Epoch-seeded, length-bucketed, host-sharded batch sampler.

Behavioral parity target: DistributedBucketSampler
(wetts/vits/data_utils.py:228-346): utterances are bucketed by spec length
over boundaries [32, 300, 400, ..., 1000], each epoch is shuffled with
generator seed (seed + epoch), buckets are padded (by wrapping) to a multiple
of world_size * batch_size, and each rank takes a strided subsample
(`ids_bucket[rank::num_replicas]`, :311).

Every batch is padded to bucket shapes: text to a multiple of `text_pad`,
frames to the bucket's upper boundary, so a run sees a handful of distinct
shapes (cuDNN plans and allocator blocks are reused across steps).

The port's own copy of `wetts_tpu/data/sampler.py`: the PyTorch package
imports nothing of the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from wetts_tpu_torch.data.dataset import TTSDataset

DEFAULT_BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000)


@dataclass
class Batch:
    """Host-side numpy batch with static, bucket-padded shapes."""

    phone_ids: np.ndarray  # int32 [B, T_text]
    text_lengths: np.ndarray  # int32 [B]
    wav: np.ndarray  # float32 [B, T_spec * hop]
    wav_lengths: np.ndarray  # int32 [B] (samples)
    spec_lengths: np.ndarray  # int32 [B] (frames)
    sid: np.ndarray  # int32 [B]


class BucketBatcher:
    def __init__(
        self,
        dataset: TTSDataset,
        batch_size: int,
        boundaries: Sequence[int] = DEFAULT_BOUNDARIES,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 1234,
        text_pad_multiple: int = 16,
        drop_tail: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.text_pad_multiple = text_pad_multiple

        self.buckets: List[List[int]] = [
            [] for _ in range(len(self.boundaries) - 1)]
        for idx, utt in enumerate(dataset.items):
            b = self._bisect(utt.num_frames)
            if b != -1:
                self.buckets[b].append(idx)
        # drop empty buckets (reference :253-258)
        pairs = [(bkt, self.boundaries[i + 1])
                 for i, bkt in enumerate(self.buckets) if bkt]
        self.buckets = [p[0] for p in pairs]
        self.bucket_max_frames = [p[1] for p in pairs]

    def _bisect(self, x: int) -> int:
        for i in range(len(self.boundaries) - 1):
            if self.boundaries[i] < x <= self.boundaries[i + 1]:
                return i
        return -1

    def __len__(self) -> int:
        total = 0
        per_super = self.num_replicas * self.batch_size
        for bucket in self.buckets:
            rem = (-len(bucket)) % per_super
            total = total + (len(bucket) + rem) // per_super
        return total

    def epoch_batches(self, epoch: int) -> List[tuple]:
        """List of (bucket_idx, [utterance indices]) for this rank."""
        g = np.random.default_rng(self.seed + epoch)
        per_super = self.num_replicas * self.batch_size
        out = []
        for bi, bucket in enumerate(self.buckets):
            ids = np.array(bucket)[g.permutation(len(bucket))]
            rem = (-len(ids)) % per_super
            if rem:
                # wrap-around padding (reference :296-303)
                reps = np.concatenate([ids] * (rem // max(len(ids), 1) + 1))
                ids = np.concatenate([ids, reps[:rem]])
            ids = ids[self.rank :: self.num_replicas]
            for s in range(0, len(ids), self.batch_size):
                out.append((bi, ids[s : s + self.batch_size].tolist()))
        order = np.random.default_rng(self.seed + epoch + 1).permutation(
            len(out))
        return [out[i] for i in order]

    def _pad_text(self, n: int) -> int:
        m = self.text_pad_multiple
        return ((n + m - 1) // m) * m

    def make_batch(self, bucket_idx: int, indices: List[int]) -> Batch:
        ds = self.dataset
        hop = ds.cfg.hop_length
        max_frames = self.bucket_max_frames[bucket_idx]
        examples = [ds.example(i) for i in indices]
        text_max = self._pad_text(max(len(e[0]) for e in examples))
        b = len(examples)
        phone_ids = np.zeros((b, text_max), np.int32)
        text_lengths = np.zeros((b,), np.int32)
        wav = np.zeros((b, max_frames * hop), np.float32)
        wav_lengths = np.zeros((b,), np.int32)
        sid = np.zeros((b,), np.int32)
        for i, (ids, audio, spk) in enumerate(examples):
            phone_ids[i, : len(ids)] = ids
            text_lengths[i] = len(ids)
            n = min(len(audio), max_frames * hop)
            n = (n // hop) * hop
            wav[i, :n] = audio[:n]
            wav_lengths[i] = n
            sid[i] = spk
        return Batch(
            phone_ids=phone_ids,
            text_lengths=text_lengths,
            wav=wav,
            wav_lengths=wav_lengths,
            spec_lengths=wav_lengths // hop,
            sid=sid,
        )

    def __call__(self, epoch: int) -> Iterator[Batch]:
        for bucket_idx, indices in self.epoch_batches(epoch):
            yield self.make_batch(bucket_idx, indices)

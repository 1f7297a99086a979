"""Frontend dataset: polyphone + prosody supervision in one set.

Behavioral parity target: wetts/frontend/dataset.py:19-154 —
- polyphone format: `…▁le5▁…` markers; the pronunciation labels the LAST
  subtoken of the preceding text span, IGNORE_ID elsewhere,
- prosody format: `今天 #1 天气 #1 怎么样 #3` word/#rank pairs; rank labels the
  last subtoken of the word, 0 on inner subtokens,
- multi-task mixing by concatenation; collate pads and offsets labels by one
  for [CLS].

Tokenization uses a character-level tokenizer interface: any object with
`encode(text) -> List[int]` (no special tokens) and `cls_id/sep_id/pad_id`.
A vocab-file-backed CharTokenizer is provided (equivalent to the
BertTokenizer char behavior for Chinese); HF tokenizers can be wrapped.

The port's own copy of `wetts_tpu/frontend/dataset.py`: the PyTorch package
imports nothing of the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IGNORE_ID = -100


class CharTokenizer:
    """Character tokenizer over a BERT vocab file (one token per line)."""

    def __init__(self, vocab_file: str):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.unk_id = self.vocab.get("[UNK]", 0)
        self.cls_id = self.vocab.get("[CLS]", 1)
        self.sep_id = self.vocab.get("[SEP]", 2)
        self.pad_id = self.vocab.get("[PAD]", 0)

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(ch, self.unk_id) for ch in text]


@dataclass
class Example:
    tokens: List[int]
    polyphones: List[int]
    prosody: List[int]


class FrontendDataset:
    def __init__(
        self,
        tokenizer,
        polyphone_file: Optional[str] = None,
        polyphone_dict: Optional[Dict[str, int]] = None,
        prosody_file: Optional[str] = None,
        prosody_dict: Optional[Dict[str, int]] = None,
    ):
        self.tokenizer = tokenizer
        self.data: List[Example] = []
        if polyphone_file and polyphone_dict is not None:
            self.data += self._read_polyphone(polyphone_file, polyphone_dict)
        if prosody_file and prosody_dict is not None:
            self.data += self._read_prosody(prosody_file, prosody_dict)

    def _read_polyphone(self, path: str, table: Dict[str, int]
                        ) -> List[Example]:
        out = []
        with open(path, encoding="utf8") as f:
            for line in f:
                arr = line.strip().strip("▁").split("▁")
                tokens: List[int] = []
                labels: List[int] = []
                for i in range(0, len(arr), 2):
                    toks = self.tokenizer.encode(arr[i])
                    span = [IGNORE_ID] * len(toks)
                    if i + 1 < len(arr) and arr[i + 1] in table and span:
                        span[-1] = table[arr[i + 1]]
                    tokens.extend(toks)
                    labels.extend(span)
                if tokens:
                    out.append(Example(tokens, labels,
                                       [IGNORE_ID] * len(labels)))
        return out

    def _read_prosody(self, path: str, table: Dict[str, int]
                      ) -> List[Example]:
        out = []
        num_ranks = len(table)
        with open(path, encoding="utf8") as f:
            for line in f:
                arr = line.strip().split()
                if len(arr) % 2 != 0:
                    continue
                ok = all(
                    arr[i + 1].startswith("#")
                    and arr[i + 1][1:].isdigit()
                    and int(arr[i + 1][1:]) < num_ranks
                    for i in range(0, len(arr), 2))
                if not ok:
                    continue
                tokens: List[int] = []
                prosody: List[int] = []
                for i in range(0, len(arr), 2):
                    toks = self.tokenizer.encode(arr[i])
                    rhythm = [0] * len(toks)
                    if rhythm:
                        rhythm[-1] = int(arr[i + 1][1:])
                    tokens.extend(toks)
                    prosody.extend(rhythm)
                if tokens:
                    out.append(Example(tokens, [IGNORE_ID] * len(prosody),
                                       prosody))
        return out

    def __len__(self) -> int:
        return len(self.data)

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 42,
                max_len: int = 128, shuffle: bool = True):
        """Yield padded numpy batches (ids, mask, polyphone, prosody)."""
        order = np.arange(len(self.data))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        tok = self.tokenizer
        for s in range(0, len(order), batch_size):
            chunk = [self.data[i] for i in order[s : s + batch_size]]
            t = min(max(len(e.tokens) for e in chunk) + 2, max_len)
            b = len(chunk)
            ids = np.full((b, t), tok.pad_id, np.int32)
            mask = np.zeros((b, t), np.int32)
            poly = np.full((b, t), IGNORE_ID, np.int32)
            pros = np.full((b, t), IGNORE_ID, np.int32)
            for i, e in enumerate(chunk):
                n = min(len(e.tokens), t - 2)
                ids[i, 0] = tok.cls_id
                ids[i, 1 : n + 1] = e.tokens[:n]
                ids[i, n + 1] = tok.sep_id
                mask[i, : n + 2] = 1
                poly[i, 1 : n + 1] = e.polyphones[:n]
                pros[i, 1 : n + 1] = e.prosody[:n]
            yield ids, mask, poly, pros

"""Char-level CLI frontend (pure Mandarin path).

Behavioral parity target: wetts/cli/frontend.py:21-86 — [CLS]/char/[SEP]
tokenization, frontend model posteriors, per-char polyphone disambiguation
restricted to the hanzi's candidate pinyins, pinyin -> phones lookup, `sil`
head, per-char `#k` prosody tags, forced final `#4`. Combined here with the
TN pass so SynthesisEngine can call `normalize` + `compute`.

The port's own copy of `wetts_tpu/cli/frontend.py`.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from wetts_tpu_torch.text.tn import TextNormalizer


def read_list(path: str) -> Dict[str, int]:
    table = {}
    with open(path, encoding="utf8") as f:
        for i, line in enumerate(f):
            table[line.strip()] = i
    return table


def read_char2pinyins(path: str) -> Dict[str, List[str]]:
    table = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            arr = line.split()
            if len(arr) == 2:
                table[arr[0]] = arr[1].split(",")
    return table


class CharFrontend:
    """scorer: token_ids [T] -> (polyphone_probs [T,P], prosody_probs [T,R])."""

    def __init__(self, scorer, token2id: Dict[str, int],
                 polyphone2id: Dict[str, int],
                 char2pinyins: Dict[str, List[str]],
                 pinyin2phones: Dict[str, List[str]]):
        self.scorer = scorer
        self.token2id = token2id
        self.polyphone2id = polyphone2id
        self.char2pinyins = char2pinyins
        self.pinyin2phones = pinyin2phones
        self.tn = TextNormalizer()

    @classmethod
    def from_dir(cls, scorer, model_dir: str) -> "CharFrontend":
        """Bundle-dir tables first, vendored repo assets as fallback
        (wetts_tpu_torch/assets/lexicon mirrors the reference's in-repo
        tables, examples/chinese_prosody_polyphone/lexicon/)."""
        from wetts_tpu_torch.assets import resolve
        from wetts_tpu_torch.text.lexicon import read_pinyin2phones

        return cls(
            scorer,
            read_list(os.path.join(model_dir, "vocab.txt")),
            read_list(resolve(model_dir, "lexicon", "polyphone.txt")),
            read_char2pinyins(resolve(model_dir, "lexicon",
                                      "pinyin_dict.txt")),
            read_pinyin2phones(resolve(model_dir, "lexicon", "lexicon.txt")),
        )

    def normalize(self, text: str) -> str:
        return self.tn.normalize(text)

    def compute(self, text: str) -> List[str]:
        chars = [c for c in text if c in self.char2pinyins]
        if not chars:
            return []
        unk = self.token2id.get("[UNK]", 0)
        tokens = ([self.token2id.get("[CLS]", 0)]
                  + [self.token2id.get(c, unk) for c in chars]
                  + [self.token2id.get("[SEP]", 0)])
        pinyin_prob, prosody_prob = self.scorer(
            np.asarray(tokens, dtype=np.int64))
        pinyins = []
        for i, ch in enumerate(chars, start=1):
            cands = self.char2pinyins[ch]
            if len(cands) > 1:
                # guard the head width: a bundle may pair a small model
                # with the full 470-class vendored table — candidates the
                # model can't score fall back to the first pronunciation
                n_cls = pinyin_prob.shape[1]
                scorable = [p for p in cands
                            if self.polyphone2id.get(p, n_cls) < n_cls]
                probs = [pinyin_prob[i][self.polyphone2id[p]]
                         for p in scorable]
                # first-max tie-breaking, like the reference's
                # poly_probs.index(max(...)) (cli/frontend.py:74-78)
                pinyins.append(scorable[int(np.argmax(probs))] if probs
                               else cands[0])
            else:
                pinyins.append(cands[0])
        prosody = prosody_prob.argmax(axis=1).tolist()
        out: List[str] = []
        for i, py in enumerate(pinyins, start=1):
            out.extend(self.pinyin2phones.get(py, []))
            out.append(f"#{prosody[i]}")
        if out:
            out[-1] = "#4"
        return out

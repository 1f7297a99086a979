"""Pronunciation lexicon + pinyin->phones table.

Behavioral parity targets:
- Lexicon: word -> comma-separated pronunciations with `<UNK>` fallback
  (runtime/core/frontend/lexicon.cc:31-60),
- pinyin2phones: `syllable phone phone...` table (ReadTableFile,
  runtime/core/utils/utils.cc) produced by tools/gen_pinyin_lexicon.py.

The benchmark's frozen copy of the port's `text/lexicon.py`, part of its
reference; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

UNK = "<UNK>"


class Lexicon:
    def __init__(self, path: str):
        self.table: Dict[str, List[str]] = {}
        with open(path, encoding="utf8") as f:
            for line in f:
                parts = line.strip().split(None, 1)
                if len(parts) < 2:
                    continue
                word, prons = parts
                self.table[word] = [p.strip() for p in prons.split(",")
                                    if p.strip()]

    def num_prons(self, word: str) -> int:
        return len(self.table.get(word, ()))

    def prons(self, word: str) -> List[str]:
        if word in self.table:
            return self.table[word]
        return self.table.get(UNK, [])

    def __contains__(self, word: str) -> bool:
        return word in self.table

    def words(self):
        return self.table.keys()


def read_pinyin2phones(path: str) -> Dict[str, List[str]]:
    table: Dict[str, List[str]] = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                table[parts[0]] = parts[1:]
    return table

"""Mandarin tone sandhi within a word.

Behavioral parity target: runtime/core/frontend/sandhi.cc:29-57 (itself
following PaddleSpeech's tone_sandhi rules):
- third-tone sandhi: 3 + 3 -> 2 + 3,
- 不 + tone-4 syllable -> bu2,
- 一: after 第 -> yi1; before tone-4 -> yi2; otherwise -> yi4.

Rules look one syllable ahead, so the final syllable is never rewritten.

The benchmark's frozen copy of the port's `text/sandhi.py`, part of its
reference; it imports nothing of the program.
"""

from __future__ import annotations

from typing import List


def apply_sandhi(word: str, pinyin: List[str]) -> List[str]:
    """word: chinese chars; pinyin: tone-suffixed syllables (e.g. 'bu4').

    Returns a new list with sandhi applied (input is not mutated).
    """
    chars = list(word)
    assert len(chars) == len(pinyin), (word, pinyin)
    out = list(pinyin)
    for i in range(len(chars) - 1):
        cur_tone = out[i][-1]
        next_tone = out[i + 1][-1]
        if cur_tone == "3" and next_tone == "3":
            out[i] = out[i][:-1] + "2"
        if chars[i] == "不" and next_tone == "4":
            out[i] = out[i][:-1] + "2"
        if chars[i] == "一":
            if i > 0 and chars[i - 1] == "第":
                out[i] = out[i][:-1] + "1"
            elif next_tone == "4":
                out[i] = out[i][:-1] + "2"
            else:
                out[i] = out[i][:-1] + "4"
    return out

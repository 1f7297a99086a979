"""Sentence and word segmentation.

Behavioral parity targets:
- WordBreak greedy longest-forward-match over a lexicon dictionary, with
  ASCII alnum run grouping and single-codepoint fallback
  (runtime/core/frontend/word_break.cc:60-129),
- SentenceSegement: split at sentence delimiters (.;!?。；！？ and newlines),
  track safe break points (commas/colons/quotes/、, spaces, ASCII word
  boundaries), force splits at max_clause_len without cutting an English
  word or number run (runtime/core/frontend/sentence_break.cc:28-131).

Ported gtest coverage: runtime/core/test/{word_break,sentence_break}_test.cc
-> tests/test_text_segment.py.

The benchmark's frozen copy of the port's `text/segmenter.py`, part of its
reference; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set

SENTENCE_DELIMS = {".", ";", "!", "?", "。", "；", "！", "？", "\n", "\r"}
SAFE_BREAKS = {",", "，", ":", "：", '"', "“", "”", "、"}


def split_utf8_chars(text: str) -> List[str]:
    """Python strings are already codepoints; kept for API parity."""
    return list(text)


def is_ascii_alnum(ch: str) -> bool:
    return len(ch) == 1 and ord(ch) < 128 and ch.isalnum()


def is_english_word(word: str) -> bool:
    return bool(word) and all(
        ord(c) < 128 and (c.isalpha() or c == "'") for c in word)


class WordBreak:
    """Greedy longest-forward-match segmentation."""

    def __init__(self, words: Iterable[str] | str):
        if isinstance(words, str):
            dictionary: Set[str] = set()
            with open(words, encoding="utf8") as f:
                for line in f:
                    parts = line.strip().split(None, 1)
                    if parts:
                        dictionary.add(parts[0])
            self.dictionary = dictionary
        else:
            self.dictionary = set(words)
        self._max_len = max((len(w) for w in self.dictionary), default=0)

    def has_word(self, word: str) -> bool:
        return word in self.dictionary

    def _longest_match(self, text: str, pos: int) -> int:
        # bounded by the longest dictionary entry (the reference scans the
        # whole remaining text, word_break.cc:120; same result, less work)
        limit = min(len(text) - pos, self._max_len)
        for length in range(limit, 0, -1):
            if text[pos : pos + length] in self.dictionary:
                return length
        return 0

    def segment(self, text: str) -> List[str]:
        words: List[str] = []
        pos = 0
        n = len(text)
        while pos < n:
            match = self._longest_match(text, pos)
            if match > 0:
                words.append(text[pos : pos + match])
                pos += match
            elif is_ascii_alnum(text[pos]):
                end = pos
                while end < n and is_ascii_alnum(text[end]):
                    end += 1
                words.append(text[pos:end])
                pos = end
            else:
                words.append(text[pos])
                pos += 1
        return words


def sentence_segment(text: str, max_clause_len: int = 0) -> List[str]:
    """Split text into synthesizable clauses (see module docstring)."""
    sentences: List[str] = []
    current: List[str] = []
    last_safe = 0  # index into `current` of the latest safe split point
    in_ascii_word = False

    def flush(upto: Optional[int] = None):
        nonlocal current, last_safe, in_ascii_word
        if upto is None:
            piece, rest = current, []
        else:
            piece, rest = current[:upto], current[upto:]
        s = "".join(piece).strip()
        if s:
            sentences.append(s)
        current = rest
        last_safe = 0
        in_ascii_word = False

    for ch in text:
        if ch in SENTENCE_DELIMS:
            current.append(ch)
            flush()
            continue
        alnum = is_ascii_alnum(ch)
        if ch in SAFE_BREAKS:
            last_safe = len(current) + 1  # split AFTER the punctuation
            in_ascii_word = False
        elif ch in (" ", "\t"):
            last_safe = len(current)
            in_ascii_word = False
        elif not in_ascii_word and alnum:
            last_safe = len(current)  # word start: split before it
            in_ascii_word = True
        elif in_ascii_word and not alnum:
            last_safe = len(current)  # word end
            in_ascii_word = False
        current.append(ch)
        if max_clause_len > 0 and len(current) >= max_clause_len:
            if last_safe > 0:
                flush(last_safe)
            else:
                flush()
    flush()
    return sentences

"""English grapheme-to-phoneme.

Behavioral parity target: runtime/core/frontend/g2p_en.cc:32-114 —
CMUdict lookup; short OOV (< 4 chars) spelled letter-by-letter joined with
`#0`; long OOV split on '-' and converted piecewise; long OOV otherwise
goes through a phonetisaurus FST shortest path (g2p_en.cc:84-114). The FST
model is an optional external asset there; here its role is played by
(a) fewest-pieces compound splitting over CMUdict ("tensorflow" ->
"tensor" + "flow") and (b) rule-based letter-to-sound for residues — both
produce whole-word pronunciations instead of the audibly-wrong
letter-by-letter spelling of round 1.

The benchmark's frozen copy of the port's `text/g2p_en.py`, part of its
reference; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

_VOWEL_PHONES = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
                 "IH", "IY", "OW", "OY", "UH", "UW"}

# ordered letter-to-sound rules: longest-match first within each position.
# (grapheme, phones) — applied by a greedy left-to-right scanner; stress is
# assigned afterwards (first vowel "1", the rest "0"), approximating the
# statistical FST's most-likely path for unseen words.
_LTS_MULTI = [
    ("tion", ["SH", "AH", "N"]),
    ("sion", ["ZH", "AH", "N"]),
    ("ould", ["UH", "D"]),
    ("ough", ["OW"]),
    ("augh", ["AO"]),
    ("eigh", ["EY"]),
    ("igh", ["AY"]),
    ("tch", ["CH"]),
    ("dge", ["JH"]),
    ("sch", ["S", "K"]),
    ("ing", ["IH", "NG"]),
    ("ck", ["K"]),
    ("ch", ["CH"]),
    ("sh", ["SH"]),
    ("th", ["TH"]),
    ("ph", ["F"]),
    ("wh", ["W"]),
    ("ng", ["NG"]),
    ("qu", ["K", "W"]),
    ("ee", ["IY"]),
    ("ea", ["IY"]),
    ("oo", ["UW"]),
    ("ou", ["AW"]),
    ("ow", ["OW"]),
    ("ai", ["EY"]),
    ("ay", ["EY"]),
    ("oa", ["OW"]),
    ("oi", ["OY"]),
    ("oy", ["OY"]),
    ("au", ["AO"]),
    ("aw", ["AO"]),
    ("ew", ["UW"]),
    ("ue", ["UW"]),
    ("ie", ["IY"]),
    ("ei", ["EY"]),
    ("ar", ["AA", "R"]),
    ("er", ["ER"]),
    ("ir", ["ER"]),
    ("ur", ["ER"]),
    ("or", ["AO", "R"]),
    ("ll", ["L"]),
    ("ss", ["S"]),
    ("tt", ["T"]),
    ("pp", ["P"]),
    ("bb", ["B"]),
    ("dd", ["D"]),
    ("ff", ["F"]),
    ("gg", ["G"]),
    ("mm", ["M"]),
    ("nn", ["N"]),
    ("rr", ["R"]),
    ("zz", ["Z"]),
]
_LTS_SINGLE = {
    "a": ["AE"], "b": ["B"], "d": ["D"], "e": ["EH"], "f": ["F"],
    "h": ["HH"], "i": ["IH"], "j": ["JH"], "k": ["K"], "l": ["L"],
    "m": ["M"], "n": ["N"], "o": ["AA"], "p": ["P"], "r": ["R"],
    "s": ["S"], "t": ["T"], "u": ["AH"], "v": ["V"], "w": ["W"],
    "x": ["K", "S"], "z": ["Z"],
}
# magic-e: <vowel><single consonant>e$ lengthens the vowel and silences e
_MAGIC_E = {"a": ["EY"], "e": ["IY"], "i": ["AY"], "o": ["OW"],
            "u": ["UW"]}
_SOFT = {"e", "i", "y"}


def letter_to_sound(word: str) -> List[str]:
    """Rule-based whole-word pronunciation for OOV words (ARPAbet)."""
    w = word.lower()
    phones: List[str] = []
    # magic-e: strip the final e and remember to lengthen the last vowel
    magic_pos = -1
    if (len(w) >= 3 and w[-1] == "e" and w[-2] not in "aeiou"
            and w[-3] in "aeiou"):
        magic_pos = len(w) - 3
        w = w[:-1]
    i = 0
    while i < len(w):
        if i == magic_pos:
            phones.extend(_MAGIC_E[w[i]])
            i += 1
            continue
        matched = False
        for pat, ph in _LTS_MULTI:
            if w.startswith(pat, i):
                # word-initial silent letters: kn-, wr-, gn-
                phones.extend(ph)
                i += len(pat)
                matched = True
                break
        if matched:
            continue
        c = w[i]
        nxt = w[i + 1] if i + 1 < len(w) else ""
        if i == 0 and w.startswith(("kn", "gn")):
            phones.append("N")
            i += 2
            continue
        if i == 0 and w.startswith("wr"):
            phones.append("R")
            i += 2
            continue
        if c == "c":
            phones.append("S" if nxt in _SOFT else "K")
        elif c == "g":
            phones.append("JH" if nxt in _SOFT else "G")
        elif c == "y":
            if i == 0:
                phones.append("Y")
            elif i == len(w) - 1:
                phones.append("IY")
            else:
                phones.append("IH")
        else:
            phones.extend(_LTS_SINGLE.get(c, []))
        i += 1
    # stress: first vowel primary, rest unstressed (FST-style single-path)
    out: List[str] = []
    seen_vowel = False
    for p in phones:
        if p in _VOWEL_PHONES:
            out.append(p + ("0" if seen_vowel else "1"))
            seen_vowel = True
        else:
            out.append(p)
    return out


class G2pEn:
    def __init__(self, cmudict_path: str):
        self.cmudict: Dict[str, List[str]] = {}
        with open(cmudict_path, encoding="utf8") as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 2:
                    self.cmudict.setdefault(parts[0], parts[1:])

    def _spell(self, word: str) -> List[str]:
        phones: List[str] = []
        for i, ch in enumerate(word):
            phones.extend(self.cmudict.get(ch, []))
            if i < len(word) - 1:
                phones.append("#0")
        return phones

    def _compound_split(self, word: str) -> Optional[List[str]]:
        """Fewest-pieces split into CMUdict words (each piece >= 3 chars),
        ties broken toward longer leading pieces — the dictionary-backed
        analog of the FST's most-likely segmentation."""
        n = len(word)
        best: List[Optional[List[str]]] = [None] * (n + 1)
        best[0] = []
        for i in range(3, n + 1):
            # prefer long final pieces: scan longest-first
            for j in range(max(0, i - 24), i - 2):
                piece = word[j:i]
                prev = best[j]
                if prev is None or piece not in self.cmudict:
                    continue
                cand = prev + [piece]
                if best[i] is None or len(cand) < len(best[i]):
                    best[i] = cand
        return best[n]

    def convert(self, grapheme: str) -> List[str]:
        if grapheme in self.cmudict:
            return list(self.cmudict[grapheme])
        if len(grapheme) < 4:
            # reference: short OOV is spelled letter-by-letter with #0
            # between letters (g2p_en.cc:77-82)
            return self._spell(grapheme)
        parts = [p for p in grapheme.split("-") if p]
        phones: List[str] = []
        for i, part in enumerate(parts):
            if part in self.cmudict:
                phones.extend(self.cmudict[part])
            elif len(part) < 4:
                phones.extend(self._spell(part))
            else:
                # phonetisaurus-FST role (g2p_en.cc:84-114): whole-word
                # pronunciation — dictionary compound split first, then
                # rule-based letter-to-sound
                split = self._compound_split(part)
                if split is not None:
                    for w in split:
                        phones.extend(self.cmudict[w])
                else:
                    phones.extend(letter_to_sound(part))
            if i < len(parts) - 1:
                phones.append("#0")
        return phones

    def convert_str(self, grapheme: str) -> str:
        return " ".join(self.convert(grapheme))

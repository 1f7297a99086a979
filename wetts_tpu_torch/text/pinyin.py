"""Mandarin pinyin lexicon generation (syllable -> initial + final/tone).

Behavioral parity target: tools/gen_pinyin_lexicon.py:41-213 — enumerate all
phonotactically legal (initial, final, erhua, tone) combinations, apply
pinyin orthography (y/w/yu substitutions, ü->u after j/q/x, iou->iu,
uei->ui, uen->un), and emit `syllable initial final[r][tone]` entries plus
the phone symbol set. Used to produce the MFA-compatible `lexicon.txt` /
`phones.txt` consumed by the Baker/AISHELL recipes.

The phonotactics are encoded as declarative constraint tables (standard
Mandarin syllabary facts) rather than an if-chain; output is
entry-for-entry identical to the reference tool.

The port's own copy of `wetts_tpu/text/pinyin.py`
(the PyTorch package imports nothing of the JAX one).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h", "zh", "ch", "sh",
    "r", "z", "c", "s", "j", "q", "x",
]

FINALS = [
    "a", "ai", "ao", "an", "ang", "e", "er", "ei", "en", "eng", "o", "ou",
    "ong", "ii", "iii", "i", "ia", "iao", "ian", "iang", "ie", "io", "iou",
    "iong", "in", "ing", "u", "ua", "uai", "uan", "uang", "uei", "uo", "uen",
    "ueng", "v", "ve", "van", "vn",
]

# -- phonotactic constraint tables ------------------------------------------
_APICAL_Z = {"z", "c", "s"}            # take the apical vowel 'ii'
_APICAL_ZH = {"zh", "ch", "sh", "r"}   # take the apical vowel 'iii'
_NO_PALATAL = {"f", "g", "k", "h", "zh", "ch", "sh", "r", "z", "c", "s"}
_PALATAL_ONLY = {"j", "q", "x"}
_LABIAL = {"b", "p", "m", "f"}
_NO_UA = {"d", "t", "n", "l", "r", "z", "c", "s"}
_NO_O = {"d", "t", "n", "g", "k", "h", "zh", "ch", "sh", "r", "z", "c", "s"}


def _is_palatal_final(final: str) -> bool:
    """i-row or ü-row finals (excluding the apical vowels ii/iii)."""
    return final not in ("ii", "iii") and final[0] in ("i", "v")


def _legal(initial: str, final: str) -> bool:
    if final == "ii":
        return initial in _APICAL_Z
    if final == "iii":
        return initial in _APICAL_ZH
    if _is_palatal_final(final) and initial in _NO_PALATAL:
        return False
    if final.startswith("v"):
        allowed = ({"j", "q", "x", "n", "l", ""} if final in ("v", "ve")
                   else {"j", "q", "x", ""})
        if initial not in allowed:
            return False
    if initial in _PALATAL_ONLY and not _is_palatal_final(final):
        return False
    if initial in _LABIAL and ((final[0] in ("u", "v") and final != "u")
                               or final == "ong"):
        return False
    if final in ("ua", "uai", "uang") and initial in _NO_UA:
        return False
    if final == "ong" and initial == "sh":
        return False
    if final == "o" and initial in _NO_O:
        return False
    if final == "ueng" and initial != "":
        return False  # only the zero-initial 'weng' exists
    if final == "er" and initial != "":
        return False  # 'er' stands alone
    return True


def _orthography(initial: str, final: str) -> Tuple[str, str]:
    """Pinyin spelling rules for the syllable surface form."""
    if initial == "":
        if final in ("i", "in", "ing"):
            return "y", final
        if final == "u":
            return "w", final
        if final.startswith("i") and final not in ("ii", "iii"):
            return "y", final[1:]
        if final.startswith("u"):
            return "w", final[1:]
        if final.startswith("v"):
            return "yu", final[1:]
        return initial, final
    if initial in _PALATAL_ONLY and final.startswith("v"):
        final = final.replace("v", "u")
    final = {"iou": "iu", "uei": "ui", "uen": "un"}.get(final, final)
    return initial, final


def make_syllable(initial: str, final: str, erhua: str, tone: str
                  ) -> Optional[str]:
    """Surface syllable string, or None if the combination is illegal."""
    if not _legal(initial, final):
        return None
    c, v = _orthography(initial, final)
    surface = c + v
    if surface.endswith("r") and erhua == "r":
        return None  # already-rhotic finals take no erhua
    surface = re.sub(r"i+", "i", surface)  # apical ii/iii spell as 'i'
    return surface + erhua + tone


def generate_pinyin_lexicon(
    with_zero_initial: bool = False,
    with_tone: bool = False,
    with_erhua: bool = False,
) -> "OrderedDict[str, str]":
    """syllable -> 'initial final[r][tone]' mapping."""
    out: "OrderedDict[str, str]" = OrderedDict()
    tones = ["1", "2", "3", "4", "5"] if with_tone else [""]
    erhuas = ["", "r"] if with_erhua else [""]
    for initial in [""] + INITIALS:
        for final in FINALS:
            for erhua in erhuas:
                for tone in tones:
                    syl = make_syllable(initial, final, erhua, tone)
                    if syl is None:
                        continue
                    head = "^" if (initial == "" and with_zero_initial) else initial
                    # NB: zero-initial entries keep the leading space, exactly
                    # like the reference tool's f'{C} {V}{R}{T}' output
                    out[syl] = f"{head} {final}{erhua}{tone}"
    return out


def generate_symbols(lexicon: Dict[str, str]) -> List[str]:
    symbols = set()
    for phones in lexicon.values():
        symbols.update(phones.split())
    return sorted(symbols)


def write_lexicon_files(lexicon_path: str, phones_path: str,
                        with_zero_initial=False, with_tone=False,
                        with_erhua=False) -> None:
    lex = generate_pinyin_lexicon(with_zero_initial, with_tone, with_erhua)
    with open(lexicon_path, "w", encoding="utf8") as f:
        for syl, phones in lex.items():
            f.write(f"{syl} {phones}\n")
    with open(phones_path, "w", encoding="utf8") as f:
        for s in generate_symbols(lex):
            f.write(s + "\n")

"""Bundled offline data assets.

The reference keeps its frontend data tables in-repo
(`examples/chinese_prosody_polyphone/lexicon/`: pinyin_dict.txt 6,873
hanzi->pinyins, polyphone.txt 470 classes, prosody.txt 5 ranks) and fetches
CMUdict at recipe time. This package vendors those data tables (plus a
lexicon.txt generated by tools/gen_pinyin_lexicon.py and a curated
mini-CMUdict) so the text pipeline works with zero egress; loaders use a
bundle-dir -> repo-assets fallback chain.

The port's own copy of `wetts_tpu/assets/__init__.py`
(the PyTorch package imports nothing of the JAX one).
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.abspath(__file__))


def asset_path(*parts: str) -> str:
    return os.path.join(_ROOT, *parts)


def lexicon_path(name: str) -> str:
    """Path of a vendored lexicon table (pinyin_dict.txt, polyphone.txt,
    prosody.txt, lexicon.txt, phones.list)."""
    return asset_path("lexicon", name)


def cmudict_path() -> str:
    """Curated CMUdict snapshot (English G2P offline fallback)."""
    return asset_path("cmudict_mini.txt")


def resolve(bundle_dir: str | None, *parts: str) -> str:
    """First existing path among <bundle_dir>/<parts> and assets/<parts>."""
    if bundle_dir:
        cand = os.path.join(bundle_dir, *parts)
        if os.path.exists(cand):
            return cand
    return asset_path(*parts)

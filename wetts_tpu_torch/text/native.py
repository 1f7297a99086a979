"""ctypes bindings for the native text frontend (native/libwetts_text.so).

The port's own copy of `wetts_tpu/text/native.py`. The serving path prefers
the C++ implementations (native-equivalents of the reference's
runtime/core/frontend C++ stack) and falls back to the port's pure-Python
twins in wetts_tpu_torch.text when the library isn't built. Both are
behaviorally identical (tests/test_torch_mcd.py cross-checks them).

Build: `wetts_tpu_torch.utils.native_build.build("libwetts_text.so")`
(into wetts_tpu_torch/_build/native/, with g++), or cmake -B native/build
native && cmake --build native/build; the first found of
$WETTS_NATIVE_LIB, the port's build and native/build is loaded.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

_SEP = "\x1e"
_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False


def _find_library() -> Optional[ctypes.CDLL]:
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [
        os.environ.get("WETTS_NATIVE_LIB", ""),
        os.path.join(here, "wetts_tpu_torch", "_build", "native",
                     "libwetts_text.so"),
        os.path.join(here, "native", "build", "libwetts_text.so"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            lib = ctypes.CDLL(path)
            lib.wetts_sentence_segment.restype = ctypes.c_void_p
            lib.wetts_sentence_segment.argtypes = [ctypes.c_char_p,
                                                   ctypes.c_size_t]
            lib.wetts_free.argtypes = [ctypes.c_void_p]
            lib.wetts_wordbreak_new.restype = ctypes.c_void_p
            lib.wetts_wordbreak_new.argtypes = [ctypes.c_char_p]
            lib.wetts_wordbreak_segment.restype = ctypes.c_void_p
            lib.wetts_wordbreak_segment.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_char_p]
            lib.wetts_wordbreak_delete.argtypes = [ctypes.c_void_p]
            lib.wetts_sandhi.restype = ctypes.c_void_p
            lib.wetts_sandhi.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.wetts_g2p_en_new.restype = ctypes.c_void_p
            lib.wetts_g2p_en_new.argtypes = [ctypes.c_char_p]
            lib.wetts_g2p_en_convert.restype = ctypes.c_void_p
            lib.wetts_g2p_en_convert.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_char_p]
            lib.wetts_g2p_en_delete.argtypes = [ctypes.c_void_p]
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _find_library() is not None


def _consume(lib, ptr) -> List[str]:
    if not ptr:
        return []
    try:
        raw = ctypes.string_at(ptr).decode("utf8")
    finally:
        lib.wetts_free(ptr)
    return raw.split(_SEP) if raw else []


def sentence_segment(text: str, max_clause_len: int = 0) -> List[str]:
    lib = _find_library()
    if lib is None:
        from wetts_tpu_torch.text.segmenter import sentence_segment as py

        return py(text, max_clause_len)
    return _consume(lib, lib.wetts_sentence_segment(
        text.encode("utf8"), max_clause_len))


def sandhi(word: str, pinyin: List[str]) -> List[str]:
    lib = _find_library()
    if lib is None:
        from wetts_tpu_torch.text.sandhi import apply_sandhi

        return apply_sandhi(word, pinyin)
    return _consume(lib, lib.wetts_sandhi(
        word.encode("utf8"), _SEP.join(pinyin).encode("utf8")))


class NativeWordBreak:
    def __init__(self, lexicon_path: str):
        lib = _find_library()
        if lib is None:
            raise RuntimeError("native library not built")
        self._lib = lib
        self._h = lib.wetts_wordbreak_new(lexicon_path.encode("utf8"))
        if not self._h:
            raise RuntimeError(f"failed to load lexicon {lexicon_path}")

    def segment(self, text: str) -> List[str]:
        return _consume(self._lib, self._lib.wetts_wordbreak_segment(
            self._h, text.encode("utf8")))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wetts_wordbreak_delete(self._h)


class NativeG2pEn:
    def __init__(self, cmudict_path: str):
        lib = _find_library()
        if lib is None:
            raise RuntimeError("native library not built")
        self._lib = lib
        self._h = lib.wetts_g2p_en_new(cmudict_path.encode("utf8"))
        if not self._h:
            raise RuntimeError(f"failed to load cmudict {cmudict_path}")

    def convert(self, grapheme: str) -> List[str]:
        return _consume(self._lib, self._lib.wetts_g2p_en_convert(
            self._h, grapheme.encode("utf8")))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wetts_g2p_en_delete(self._h)

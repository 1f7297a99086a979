"""G2P + prosody orchestrator (production text -> phoneme pipeline).

Behavioral parity target: runtime/core/frontend/g2p_prosody.cc:45-231 —
word segmentation -> char tokenization ([CLS]/[SEP], English -> [UNK]) with
per-word offsets -> one BERT pass (polyphone + prosody posteriors) ->
per-word polyphone argmax over lexicon-allowed pronunciations + prosody
rank at the word boundary -> English G2P substitution -> tone sandhi ->
pinyin -> phones + interleaved `#k` prosody; punctuation maps `, ， : ：`->#3,
`、`->#2 onto the previous token; the final token is forced to `#4`.

The BERT forward is injected as a callable (the reference's
`text/bert.py:Scorer`), keeping this module pure Python.

The benchmark's frozen copy of the port's `text/frontend.py`, part of
its reference; it imports nothing of the program. `normalize` is the
text normalization (`tn.py`), which the engine calls before `compute`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.text.g2p_en import G2pEn
from benchmark.reference.text.lexicon import Lexicon, read_pinyin2phones
from benchmark.reference.text.sandhi import apply_sandhi
from benchmark.reference.text.segmenter import WordBreak, is_english_word
from benchmark.reference.text.tn import TextNormalizer

CLS, SEP, UNK = "[CLS]", "[SEP]", "[UNK]"

PUNCT_PROSODY = {",": "#3", "，": "#3", ":": "#3", "：": "#3", "、": "#2"}

# scorer: token_ids [T] -> (polyphone_probs [T, P], prosody_probs [T, R])
Scorer = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


class G2pProsody:
    def __init__(
        self,
        scorer: Scorer,
        vocab: Dict[str, int],
        lexicon: Lexicon,
        pinyin2id: Dict[str, int],
        pinyin2phones: Dict[str, List[str]],
        g2p_en: Optional[G2pEn] = None,
    ):
        self.scorer = scorer
        self.vocab = vocab
        self.lexicon = lexicon
        self.word_break = WordBreak(set(lexicon.words()))
        self.pinyin2id = pinyin2id
        self.pinyin2phones = pinyin2phones
        self.g2p_en = g2p_en
        self.tn = TextNormalizer()

    def normalize(self, text: str) -> str:
        return self.tn.normalize(text)

    # ------------------------------------------------------------------

    def tokenize(self, words: Sequence[str]) -> Tuple[List[int], List[int]]:
        """(token_ids with CLS/SEP, per-word offsets) — g2p_prosody.cc:72-100."""
        token_ids = [self.vocab[CLS]]
        offsets = []
        offset = 1
        for word in words:
            offsets.append(offset)
            if self.lexicon.num_prons(word) > 0:
                for ch in word:
                    token_ids.append(self.vocab.get(ch, self.vocab[UNK]))
                    offset += 1
            elif word and ord(word[0]) < 128 and word[0].isalnum():
                token_ids.append(self.vocab[UNK])
                offset += 1
            else:
                token_ids.append(self.vocab.get(word, self.vocab[UNK]))
                offset += 1
        token_ids.append(self.vocab[SEP])
        return token_ids, offsets

    def forward(self, words: Sequence[str], token_ids: Sequence[int],
                offsets: Sequence[int]) -> Tuple[List[str], List[List[str]]]:
        """Per-word (pinyin-or-raw-word, prosody tags) — cc:102-168."""
        poly_probs, pros_probs = self.scorer(
            np.asarray(token_ids, dtype=np.int64))
        pinyins: List[str] = []
        prosodys: List[List[str]] = []
        for i, word in enumerate(words):
            num_chars = len(word)
            offset = offsets[i]
            prosody_offset = offset
            prosody: List[str] = []
            n_prons = self.lexicon.num_prons(word)
            if n_prons == 0:
                pinyins.append(word)  # OOV / English / punctuation
            elif n_prons == 1:
                pinyins.append(self.lexicon.prons(word)[0])
                for _ in range(num_chars - 1):
                    prosody.append("#0")  # inside-word boundary
                    prosody_offset += 1
            else:
                # polyphone char: argmax over allowed pronunciations
                cands = self.lexicon.prons(word)
                vals = [poly_probs[offset, self.pinyin2id[p]] for p in cands]
                pinyins.append(cands[int(np.argmax(vals))])
            rank = int(np.argmax(pros_probs[prosody_offset]))
            prosody.append(f"#{rank}")
            prosodys.append(prosody)
        return pinyins, prosodys

    def compute(self, text: str) -> List[str]:
        """text (already normalized) -> phoneme+prosody sequence — cc:170-231."""
        words = self.word_break.segment(text)
        if not words:
            return []
        token_ids, offsets = self.tokenize(words)
        pinyins, prosodys = self.forward(words, token_ids, offsets)

        for i, word in enumerate(words):
            if is_english_word(word) and self.g2p_en is not None:
                pinyins[i] = " ".join(self.g2p_en.convert(word.lower()))

        phonemes: List[str] = []
        for idx, word in enumerate(words):
            pinyin = pinyins[idx].split()
            prosody = prosodys[idx]
            if self.lexicon.num_prons(word) > 0:
                assert len(pinyin) == len(prosody), (word, pinyin, prosody)
                pinyin = apply_sandhi(word, pinyin)
                for syl, pro in zip(pinyin, prosody):
                    phones = self.pinyin2phones.get(syl)
                    if phones is None:
                        continue  # logged as error in the reference
                    phonemes.extend(phones)
                    phonemes.append(pro)
            elif is_english_word(word):
                phonemes.extend(pinyin)
                phonemes.append(prosody[0])
            elif word in PUNCT_PROSODY:
                if phonemes:
                    phonemes[-1] = PUNCT_PROSODY[word]
            # else: ignored word (reference logs a warning)
        if phonemes:
            phonemes[-1] = "#4"
        return phonemes

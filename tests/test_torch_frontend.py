"""The port's text frontend against the JAX package's.

- `tn`, `sandhi`, `g2p_en`, `lexicon` and `pinyin`: the same outputs on the
  same inputs (TN over tests/data/tn_corpus.tsv, sandhi over every rule,
  English G2P over dictionary words, short and long OOV words and
  hyphenated compounds, the vendored tables as loaded, the generated pinyin
  lexicon under every option); the vendored assets byte for byte;
- `G2pProsody` and `CharFrontend` on the vendored tables with a seeded
  numpy scorer (posteriors drawn per token id, so both sides see the same
  ones): exactly the JAX modules' phones;
- `FrontendModel` at `BertConfig.tiny` with every parameter random: logits
  within atol 1e-5 of the JAX model's on a padded batch, the port's weights
  carried to JAX by `convert_frontend_torch` and the JAX weights to the port
  by `frontend_params_from_jax`; `export` and `FrontendScorer` within the
  same bound; the weight bridge refuses a leaf it cannot place;
- chip_smoke's frontend (the vendored tables, `[PAD]`/`[CLS]`/`[SEP]`/
  `[UNK]` and the hanzi of pinyin_dict.txt as its vocabulary) through a
  tiny random `FrontendModel` and `FrontendScorer`: the JAX G2pProsody's
  phones through the JAX scorer on the same weights.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import frontend_tables
from wetts_tpu import assets as jax_assets
from wetts_tpu.cli.frontend import CharFrontend as JaxCharFrontend
from wetts_tpu.frontend.scorer import FrontendScorer as JaxScorer
from wetts_tpu.models import bert_frontend as jax_bert
from wetts_tpu.text import g2p_en as jax_g2p_en
from wetts_tpu.text import lexicon as jax_lexicon
from wetts_tpu.text import pinyin as jax_pinyin
from wetts_tpu.text import sandhi as jax_sandhi
from wetts_tpu.text import tn as jax_tn
from wetts_tpu.text.frontend import G2pProsody as JaxG2pProsody
from wetts_tpu_torch import assets
from wetts_tpu_torch.cli.frontend import CharFrontend
from wetts_tpu_torch.frontend.scorer import FrontendScorer
from wetts_tpu_torch.models.bert_frontend import BertConfig, FrontendModel
from wetts_tpu_torch.text import g2p_en, lexicon, pinyin, sandhi, tn
from wetts_tpu_torch.text.frontend import G2pProsody
from wetts_tpu_torch.utils.convert import frontend_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # f32 on both sides, products summed in another order
TEXTS = [
    "你好世界，今天天气怎么样？",
    "我们一起去银行，不要迟到。",
    "他说hello world、然后走了",
    "一个人的第一次，不对不是",
    "长城很长，好好学习，重要的事情说三遍",
    "AI和tensorflow都很好：ABC",
    "了解了就行，行不行",
]
TN_TEXTS = ["涨了5%", "2023年8月15日下午3:05", "电话13812345678", "气温-5度",
            "共465篇，约315万字", "3.14是圆周率", "1/3的人", "第2名"]


def _scorer(n_poly: int, n_pros: int = 5, seed: int = 0):
    """Posteriors drawn per token id from a seeded table: the same ids get
    the same rows on both sides."""
    rng = np.random.default_rng(seed)
    poly = rng.random((8000, n_poly)).astype(np.float32)
    pros = rng.random((8000, n_pros)).astype(np.float32)

    def score(ids):
        ids = np.asarray(ids)
        return poly[ids], pros[ids]

    return score


# ---- the rule modules -----------------------------------------------------

def test_tn_matches_jax():
    corpus = os.path.join(ROOT, "tests", "data", "tn_corpus.tsv")
    srcs = [line.split("\t")[1] for line in open(corpus, encoding="utf8")]
    ours, theirs = tn.TextNormalizer(), jax_tn.TextNormalizer()
    assert len(srcs) >= 150
    for src in srcs + TN_TEXTS + TEXTS:
        assert ours.normalize(src) == theirs.normalize(src), src
    for n in (0, 10, 14, 105, 1234, 10001, 200000000, 1234567890):
        assert tn.number_to_chinese(n) == jax_tn.number_to_chinese(n)


@pytest.mark.parametrize("word,syllables", [
    ("你好", ["ni3", "hao3"]), ("不要", ["bu4", "yao4"]),
    ("不对", ["bu4", "dui4"]), ("一个", ["yi1", "ge4"]),
    ("第一", ["di4", "yi1"]), ("一天", ["yi1", "tian1"]),
    ("一起", ["yi1", "qi3"]), ("展览馆", ["zhan3", "lan3", "guan3"]),
    ("看一看", ["kan4", "yi1", "kan4"]), ("好", ["hao3"])])
def test_sandhi_matches_jax(word, syllables):
    assert sandhi.apply_sandhi(word, syllables) == \
        jax_sandhi.apply_sandhi(word, syllables)


def test_g2p_en_matches_jax():
    ours = g2p_en.G2pEn(assets.cmudict_path())
    theirs = jax_g2p_en.G2pEn(jax_assets.cmudict_path())
    words = ["hello", "world", "a", "the", "abc", "ai", "tensorflow",
             "state-of-the-art", "xyzzy", "nation", "knight", "through",
             "qu", "ok", "chatgpt", "pytorch", "kernels", "h"]
    for word in words:
        assert ours.convert(word) == theirs.convert(word), word
        assert ours.convert_str(word) == theirs.convert_str(word)
    for word in ("phonetic", "straight", "quick", "judge"):
        assert g2p_en.letter_to_sound(word) == \
            jax_g2p_en.letter_to_sound(word)


def test_lexicon_tables_match_jax():
    for name in ("pinyin_dict.txt", "lexicon.txt"):
        ours = lexicon.Lexicon(assets.lexicon_path(name))
        theirs = jax_lexicon.Lexicon(jax_assets.lexicon_path(name))
        assert ours.table == theirs.table
        for word in ("好", "中", "行", "zz", "<UNK>"):
            assert ours.prons(word) == theirs.prons(word)
            assert ours.num_prons(word) == theirs.num_prons(word)
    path = assets.lexicon_path("lexicon.txt")
    assert lexicon.read_pinyin2phones(path) == \
        jax_lexicon.read_pinyin2phones(path)


@pytest.mark.parametrize("options", [(False, False, False),
                                     (True, True, True),
                                     (False, True, True),
                                     (True, False, False)])
def test_pinyin_lexicon_matches_jax(options, tmp_path):
    ours = pinyin.generate_pinyin_lexicon(*options)
    assert list(ours.items()) == \
        list(jax_pinyin.generate_pinyin_lexicon(*options).items())
    assert pinyin.generate_symbols(ours) == jax_pinyin.generate_symbols(ours)
    pinyin.write_lexicon_files(str(tmp_path / "a"), str(tmp_path / "b"),
                               *options)
    jax_pinyin.write_lexicon_files(str(tmp_path / "c"), str(tmp_path / "d"),
                                   *options)
    for got, want in (("a", "c"), ("b", "d")):
        assert (tmp_path / got).read_bytes() == (tmp_path / want).read_bytes()


def test_vendored_assets_are_the_jax_packages(tmp_path):
    names = ["cmudict_mini.txt"] + [
        os.path.join("lexicon", n) for n in sorted(os.listdir(
            jax_assets.asset_path("lexicon")))]
    for name in names:
        with open(assets.asset_path(name), "rb") as f, \
                open(jax_assets.asset_path(name), "rb") as g:
            assert f.read() == g.read(), name
    assert assets.lexicon_path("phones.list").startswith(
        os.path.join(ROOT, "wetts_tpu_torch"))
    (tmp_path / "lexicon").mkdir()
    (tmp_path / "lexicon" / "polyphone.txt").write_text("x\n")
    assert assets.resolve(str(tmp_path), "lexicon", "polyphone.txt") == \
        str(tmp_path / "lexicon" / "polyphone.txt")
    assert assets.resolve(str(tmp_path), "lexicon", "prosody.txt") == \
        assets.lexicon_path("prosody.txt")
    assert assets.resolve(None, "cmudict_mini.txt") == assets.cmudict_path()


# ---- the orchestrators ----------------------------------------------------

def _g2p_pair(scorer):
    vocab, lex, pinyin2id, pinyin2phones, g2p, _ = frontend_tables()
    jax_lex = jax_lexicon.Lexicon(jax_assets.lexicon_path("pinyin_dict.txt"))
    theirs = JaxG2pProsody(scorer, vocab, jax_lex, pinyin2id, pinyin2phones,
                           jax_g2p_en.G2pEn(jax_assets.cmudict_path()))
    return G2pProsody(scorer, vocab, lex, pinyin2id, pinyin2phones, g2p), \
        theirs


def test_g2p_prosody_matches_jax():
    ours, theirs = _g2p_pair(_scorer(470))
    norm = jax_tn.TextNormalizer()
    for text in TEXTS + TN_TEXTS:
        assert ours.normalize(text) == norm.normalize(text)
        words = ours.word_break.segment(ours.normalize(text))
        assert ours.tokenize(words) == theirs.tokenize(words)
        got = ours.compute(ours.normalize(text))
        assert got == theirs.compute(norm.normalize(text)), text
        assert got and got[-1] == "#4"


def test_char_frontend_matches_jax(tmp_path):
    vocab, *_ = frontend_tables()
    (tmp_path / "vocab.txt").write_text(
        "\n".join(sorted(vocab, key=vocab.get)) + "\n", encoding="utf8")
    scorer = _scorer(470, seed=1)
    ours = CharFrontend.from_dir(scorer, str(tmp_path))
    theirs = JaxCharFrontend.from_dir(scorer, str(tmp_path))
    assert ours.token2id == theirs.token2id == vocab
    assert ours.polyphone2id == theirs.polyphone2id
    assert ours.char2pinyins == theirs.char2pinyins
    for text in TEXTS + TN_TEXTS:
        norm = ours.normalize(text)
        assert norm == theirs.normalize(text)
        assert ours.compute(norm) == theirs.compute(norm), text
    # a head narrower than the table: unscorable candidates fall back
    narrow = _scorer(40, seed=2)
    ours.scorer = theirs.scorer = narrow
    for text in TEXTS:
        norm = ours.normalize(text)
        assert ours.compute(norm) == theirs.compute(norm)


# ---- the BERT frontend model ----------------------------------------------

TINY = BertConfig.tiny(vocab_size=96)
N_POLY, N_PROS, HEADS, FFN = 11, 5, 4, 48


def _jax_model():
    return jax_bert.FrontendModel(
        N_POLY, N_PROS, jax_bert.BertConfig.tiny(vocab_size=96),
        transform_heads=HEADS, transform_ffn=FFN)


def _port_model(seed: int) -> FrontendModel:
    """Every parameter drawn from a numpy seed (LayerNorms near 1 and 0)."""
    model = FrontendModel(N_POLY, N_PROS, TINY, HEADS, FFN)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = rng.standard_normal(p.shape).astype(np.float32) * 0.2
            if "LayerNorm.weight" in name or name.endswith(
                    ("norm1.weight", "norm2.weight")):
                draw += 1.0
            p.copy_(torch.from_numpy(draw))
    return model.eval()


def _inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 96, (3, 20))
    mask = np.ones((3, 20), np.int64)
    mask[1, 13:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _port_logits(model, ids, mask):
    with torch.inference_mode():
        phone, pros = model(torch.from_numpy(ids), torch.from_numpy(mask))
    return phone.numpy(), pros.numpy()


def _jax_logits(params, ids, mask):
    phone, pros = _jax_model().apply({"params": params}, jnp.asarray(ids),
                                     jnp.asarray(mask))
    return np.asarray(phone), np.asarray(pros)


def _close(got, want, mask):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g[mask > 0], w[mask > 0], atol=ATOL)


def test_frontend_model_port_weights_in_jax():
    model = _port_model(0)
    params, meta = jax_bert.convert_frontend_torch(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert (meta["num_polyphones"], meta["num_prosody"],
            meta["transform_ffn"], meta["bert"].num_layers) == \
        (N_POLY, N_PROS, FFN, TINY.num_layers)
    ids, mask = _inputs()
    _close(_port_logits(model, ids, mask), _jax_logits(params, ids, mask),
           mask)


def test_frontend_model_jax_weights_in_port():
    ids, mask = _inputs(4)
    variables = _jax_model().init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                  jnp.asarray(mask))
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.2 * rng.standard_normal(a.shape)
                   ).astype(np.float32), jax.device_get(variables["params"]))
    meta = {"bert": jax_bert.BertConfig.tiny(vocab_size=96)}
    model = FrontendModel(N_POLY, N_PROS, TINY, HEADS, FFN)
    model.load_state_dict(frontend_params_from_jax(params, meta))
    _close(_port_logits(model.eval(), ids, mask),
           _jax_logits(params, ids, mask), mask)
    # the bridge round-trips through the JAX package's own converter
    back, _ = jax_bert.convert_frontend_torch(
        {k: v.numpy() for k, v in model.state_dict().items()})
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf)


def test_frontend_params_from_jax_refuses_what_it_cannot_place():
    model = _port_model(1)
    params, meta = jax_bert.convert_frontend_torch(
        {k: v.numpy() for k, v in model.state_dict().items()})
    stray = copy.deepcopy(params)
    stray["transform"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        frontend_params_from_jax(stray, meta)
    missing = copy.deepcopy(params)
    del missing["bert"]["layer_1"]["intermediate"]
    with pytest.raises(KeyError):
        frontend_params_from_jax(missing, meta)


def test_export_and_scorer_match_jax():
    model = _port_model(2)
    params, _ = jax_bert.convert_frontend_torch(
        {k: v.numpy() for k, v in model.state_dict().items()})
    ids = np.random.default_rng(6).integers(1, 96, (2, 9))
    with torch.inference_mode():
        got = [a.numpy() for a in model.export(torch.from_numpy(ids))]
    want = _jax_model().apply({"params": params}, jnp.asarray(ids),
                              method=jax_bert.FrontendModel.export)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
    ours, theirs = FrontendScorer(model), JaxScorer(_jax_model(), params)
    for t in (1, 7, 16, 17, 30):
        tokens = np.random.default_rng(t).integers(1, 96, t)
        for g, w in zip(ours(tokens), theirs(tokens)):
            assert g.shape == w.shape and g.dtype == np.float32
            assert g.shape[0] == t
            np.testing.assert_allclose(g, w, atol=ATOL)


def test_chip_smoke_frontend_matches_jax():
    """chip_smoke's frontend at a tiny width on the CPU: the vendored tables
    and vocabulary, a random FrontendModel behind FrontendScorer, against
    the JAX G2pProsody behind the JAX scorer on the same weights. Each
    decision is an argmax over posteriors within 1e-5 of each other."""
    vocab, _, pinyin2id, _, _, phone2id = frontend_tables()
    assert list(vocab)[:4] == ["[PAD]", "[CLS]", "[SEP]", "[UNK]"]
    assert phone2id["sil"] == 0 and "#4" in phone2id and "zh" in phone2id
    torch.manual_seed(0)
    cfg = BertConfig.tiny(vocab_size=len(vocab))
    model = FrontendModel(len(pinyin2id), 5, cfg, 4, 48).eval()
    params, _ = jax_bert.convert_frontend_torch(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jax_model = jax_bert.FrontendModel(
        len(pinyin2id), 5, jax_bert.BertConfig.tiny(vocab_size=len(vocab)),
        transform_heads=4, transform_ffn=48)
    ours, theirs = _g2p_pair(FrontendScorer(model))
    theirs.scorer = JaxScorer(jax_model, params)
    for text in TEXTS[:4]:
        norm = ours.normalize(text)
        phones = ours.compute(norm)
        assert phones == theirs.compute(norm), text
        assert all(p in phone2id for p in phones), phones

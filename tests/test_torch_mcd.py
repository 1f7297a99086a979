"""The port's MCD tool (`bin/eval_mcd.py`), its native text bindings
(`text/native.py`) and its embedded-engine module (`serving/embed.py`),
held against the JAX package on the CPU.

- eval_mcd: tests/test_eval_mcd.py's eight tests on the port's functions,
  and the port's MCD equal to the JAX tool's on the same WAVs (rtol 1e-6),
  function by function and through both CLIs;
- text/native: tests/test_native_text.py's four tests on the port's
  bindings, on the library `utils/native_build.py` builds with g++,
  and the Python fallback, which runs everywhere, equal to the port's and
  the JAX package's Python twins;
- serving/embed: `init`, `synthesize` and `stream_synthesize` against
  `wetts_tpu.serving.embed` on one bundle at the Model's scales with the
  same patterned draws on both sides (tests/torch_port_common.py), the
  int16 bytes within the bound of atol 2e-4 on the float wave.
"""

import copy
import json
import subprocess
import sys

import numpy as np
import pytest

from torch_port_common import patch_shared_draws, small_cfg_dict
from wetts_tpu.bin import eval_mcd as jax_mcd
from wetts_tpu.serving import embed as jax_embed
from wetts_tpu.text import native as jax_native
from wetts_tpu_torch.bin.eval_mcd import (
    MCD_CONST,
    dtw_path,
    mcd_from_cepstra,
    mcd_wav,
    mel_cepstra,
)
from wetts_tpu_torch.serving import embed
from wetts_tpu_torch.text import native
from wetts_tpu_torch.text.g2p_en import G2pEn
from wetts_tpu_torch.text.sandhi import apply_sandhi
from wetts_tpu_torch.text.segmenter import WordBreak, sentence_segment

SR = 22050


def _tone(freqs, n=SR // 2, amp=0.3):
    t = np.arange(n) / SR
    return amp * sum(np.sin(2 * np.pi * f * t) for f in freqs).astype(
        np.float32)


# ---------------------------------------------------------------------------
# eval_mcd: tests/test_eval_mcd.py on the port
# ---------------------------------------------------------------------------


def test_mcd_identity_is_zero():
    x = _tone([220, 440])
    assert mcd_wav(x, x, SR) == pytest.approx(0.0, abs=1e-5)


def test_mcd_level_invariant():
    """MCD excludes c0, so a pure gain change (log-mel shifted by a
    constant) must score ~0. Broadband noise keeps every mel band above
    the log-compression floor, where the shift really is constant."""
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(SR // 2)).astype(np.float32)
    assert mcd_wav(0.5 * x, x, SR) == pytest.approx(0.0, abs=1e-3)


def test_mcd_differs_for_different_spectra():
    a = _tone([220])
    b = _tone([1760])
    assert mcd_wav(a, b, SR) > 1.0


def test_mcd_formula_matches_numpy_oracle():
    """mcd_from_cepstra on equal-length aligned cepstra == the closed-form
    expression; DTW can only lower the mean distance."""
    rng = np.random.default_rng(0)
    c1 = rng.standard_normal((20, 13)).astype(np.float32)
    c2 = c1 + 0.1 * rng.standard_normal((20, 13)).astype(np.float32)
    want = MCD_CONST * np.mean(
        np.sqrt(((c1[:, 1:] - c2[:, 1:]) ** 2).sum(axis=1)))
    got = mcd_from_cepstra(c1, c2)
    naive = mcd_from_cepstra(c1, c2, use_dtw=False)
    assert naive == pytest.approx(want, rel=1e-6)
    assert got <= want * (1 + 1e-6)


def test_dtw_aligns_time_shift():
    """A time-shifted copy scores ~0 with DTW, clearly nonzero without."""
    x = np.concatenate([_tone([220], n=SR // 4), _tone([880], n=SR // 4)])
    shifted = np.concatenate([x[2048:], x[:2048]])
    with_dtw = mcd_wav(shifted, x, SR)
    without = mcd_wav(shifted, x, SR, use_dtw=False)
    assert with_dtw < without * 0.5


def test_dtw_path_monotonic():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((15, 4))
    b = rng.standard_normal((11, 4))
    ia, ib = dtw_path(a, b)
    assert ia[0] == 0 and ib[0] == 0
    assert ia[-1] == 14 and ib[-1] == 10
    assert (np.diff(ia) >= 0).all() and (np.diff(ib) >= 0).all()
    assert ((np.diff(ia) + np.diff(ib)) >= 1).all()


def test_mel_cepstra_shape():
    c = mel_cepstra(_tone([440]), SR)
    assert c.shape[1] == 13 and c.shape[0] > 20
    assert np.isfinite(c).all()


def _mcd_corpus(tmp_path, gain=0.8):
    """Two reference / generated WAV pairs and their manifest."""
    from wetts_tpu_torch.utils.wav import write_wav

    ref_dir, gen_dir = tmp_path / "ref", tmp_path / "gen"
    ref_dir.mkdir()
    gen_dir.mkdir()
    lines = []
    rng = np.random.default_rng(2)
    for i in range(2):
        # broadband noise: every mel band above the log floor, so the gain
        # difference lands almost entirely in the excluded c0
        x = (0.3 * rng.standard_normal(SR // 2)).astype(np.float32)
        write_wav(str(ref_dir / f"utt{i}.wav"), x, SR)
        write_wav(str(gen_dir / f"utt{i}.wav"), x * gain, SR)
        lines.append(f"{ref_dir}/utt{i}.wav|spk0|a b c")
    manifest = tmp_path / "test.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest, gen_dir


def test_cli_batch_mode(tmp_path):
    """End-to-end CLI: manifest + gen_dir pairing, JSON output."""
    manifest, gen_dir = _mcd_corpus(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "wetts_tpu_torch.bin.eval_mcd",
         "--test_file", str(manifest), "--gen_dir", str(gen_dir)],
        capture_output=True, text=True, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n_pairs"] == 2
    # int16 wav round-trip + 0.8 gain: tiny but nonzero quantization MCD
    assert out["mean"] < 1.0


def test_mcd_equals_the_jax_tool(tmp_path, capsys):
    """The same numbers as wetts_tpu.bin.eval_mcd: cepstra, DTW paths and
    MCDs (rtol 1e-6) on speech-like pairs of unequal length, and the same
    JSON line from both CLIs on one manifest (pair mode, resampled)."""
    rng = np.random.default_rng(5)
    a = (_tone([180, 2300], n=SR // 2) + 0.05 * rng.standard_normal(
        SR // 2)).astype(np.float32)
    b = (_tone([190, 2100], n=SR // 3) + 0.05 * rng.standard_normal(
        SR // 3)).astype(np.float32)
    np.testing.assert_allclose(mel_cepstra(a, SR), jax_mcd.mel_cepstra(a, SR),
                               rtol=1e-6, atol=1e-6)
    ca, cb = mel_cepstra(a, SR), mel_cepstra(b, SR)
    for got, want in zip(dtw_path(ca, cb), jax_mcd.dtw_path(ca, cb)):
        np.testing.assert_array_equal(got, want)
    for use_dtw in (True, False):
        assert mcd_wav(a, b, SR, use_dtw=use_dtw) == pytest.approx(
            jax_mcd.mcd_wav(a, b, SR, use_dtw=use_dtw), rel=1e-6)

    from wetts_tpu_torch.bin import eval_mcd

    manifest, gen_dir = _mcd_corpus(tmp_path, gain=0.5)
    outs = []
    for args in (["--test_file", str(manifest), "--gen_dir", str(gen_dir)],
                 ["--gen", str(gen_dir / "utt0.wav"),
                  "--ref", str(tmp_path / "ref" / "utt1.wav"),
                  "--sample_rate", "16000"]):
        eval_mcd.main(args)
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["eval_mcd"] + args)
            jax_mcd.main()
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got.keys() == want.keys()
        assert got["mean"] == pytest.approx(want["mean"], rel=1e-6)
        outs.append(got)
    assert outs[0]["n_pairs"] == 2 and outs[1]["mean"] > 1.0


# ---------------------------------------------------------------------------
# text/native: tests/test_native_text.py on the port, and its fallback
# ---------------------------------------------------------------------------

CASES = [
    ("我爱编程，但是今天下雨了。明天呢？好吧！", 0),
    ("Hello, world! Are you OK? Yes; good.", 0),
    ("abc def ghi jkl", 4),
    ("我爱编程学习", 3),
    ("11月10日，第十五届全国运动会。来自广州的\"00后\"志愿者", 32),
    ("", 0),
]
SANDHI_CASES = [
    ("你好", ["ni3", "hao3"]),
    ("不要", ["bu4", "yao4"]),
    ("第一名", ["di4", "yi1", "ming2"]),
    ("一起", ["yi1", "qi3"]),
]


@pytest.fixture
def built(monkeypatch):
    """libwetts_text.so built into the port's build dir and found there."""
    from wetts_tpu_torch.utils import native_build

    native_build.build("libwetts_text.so")
    monkeypatch.delenv("WETTS_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", False)
    assert native.available()


def test_sentence_segment_parity(built):
    for text, maxlen in CASES:
        assert native.sentence_segment(text, maxlen) == \
            sentence_segment(text, maxlen)


def test_sandhi_parity(built):
    for word, pinyin in SANDHI_CASES:
        assert native.sandhi(word, pinyin) == apply_sandhi(word, pinyin)


def test_wordbreak_parity(built, tmp_path):
    lex = tmp_path / "lexicon.txt"
    words = ["我", "爱", "我爱", "编程", "中国", "中国人", "人民"]
    lex.write_text("\n".join(f"{w} x" for w in words), encoding="utf8")
    nat = native.NativeWordBreak(str(lex))
    py = WordBreak(set(words))
    for text in ["我爱编程", "中国人民", "hello 世界", "我爱python编程", ""]:
        assert nat.segment(text) == py.segment(text)


def test_g2p_en_parity(built, tmp_path):
    cmu = tmp_path / "cmu.txt"
    cmu.write_text("hello HH AH0 L OW1\nworld W ER1 L D\na EY1\nb B IY1\n"
                   "c S IY1\nsuper S UW1 P ER0\nman M AE1 N\n"
                   "tensor T EH1 N S ER0\nflow F L OW1\n",
                   encoding="utf8")
    nat = native.NativeG2pEn(str(cmu))
    py = G2pEn(str(cmu))
    for word in ["hello", "abc", "super-man", "superman", "ab",
                 "tensorflow", "blargish", "knightly", "tensor-blarg"]:
        assert nat.convert(word) == py.convert(word), word
    assert py.convert("tensorflow") == [
        "T", "EH1", "N", "S", "ER0", "F", "L", "OW1"]
    assert "#0" not in py.convert("blargish")


def test_python_fallback_without_the_library(monkeypatch):
    """With no library found, the bindings answer through the port's
    Python twins, as the JAX package's do through its own; the classes that
    need the library say so."""
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_SEARCHED", True)
    assert not native.available()
    for text, maxlen in CASES:
        got = native.sentence_segment(text, maxlen)
        assert got == sentence_segment(text, maxlen)
        assert got == jax_native.sentence_segment(text, maxlen)
    for word, pinyin in SANDHI_CASES:
        got = native.sandhi(word, pinyin)
        assert got == apply_sandhi(word, pinyin)
        assert got == jax_native.sandhi(word, pinyin)
    with pytest.raises(RuntimeError, match="not built"):
        native.NativeWordBreak("lexicon.txt")
    with pytest.raises(RuntimeError, match="not built"):
        native.NativeG2pEn("cmu.txt")


# ---------------------------------------------------------------------------
# serving/embed against the JAX package's
# ---------------------------------------------------------------------------

EMBED_TEXT = " ".join(f"p{1 + (7 * i) % 23}" for i in range(40))
ATOL = 2e-4


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A params.npz bundle of a random port model (small config)."""
    from chip_smoke import random_init_
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.utils.convert import convert_synthesizer
    from wetts_tpu_torch.utils.params_io import save_params_npz

    cfg_dict = small_cfg_dict()
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    net = random_init_(Synthesizer(cfg), 2)
    d = tmp_path_factory.mktemp("embed")
    save_params_npz(str(d / "params.npz"), convert_synthesizer(
        {k: v.numpy() for k, v in net.state_dict().items()}, cfg))
    (d / "config.json").write_text(json.dumps(cfg_dict))
    (d / "phones.txt").write_text(
        "".join(f"p{i} {i}\n" for i in range(1, 24)) + "sil 0\n")
    (d / "speaker.txt").write_text("spk0 0\nspk1 1\n")
    return str(d)


def _pcm(b: bytes) -> np.ndarray:
    return np.frombuffer(b, "<i2").astype(np.int32)


def test_embed_matches_jax(bundle, monkeypatch):
    patch_shared_draws(monkeypatch)
    monkeypatch.setenv("WETTS_ON_DEVICE_BUCKETING", "0")
    monkeypatch.setenv("WETTS_DEVICE", "cpu")
    monkeypatch.delenv("WETTS_PRECISION", raising=False)
    assert embed.init(bundle) == jax_embed.init(bundle) == 22050

    # whole requests: the Model's peak scaling (tests/test_torch_cli.py's
    # int16 bound, from the port's float peak)
    wave_f = embed._MODEL.engine.synthesize(EMBED_TEXT, "spk1")
    peak = max(0.01, float(np.abs(wave_f).max()))
    got = _pcm(embed.synthesize(EMBED_TEXT, "spk1"))
    want = _pcm(jax_embed.synthesize(EMBED_TEXT, "spk1"))
    assert got.shape == want.shape and np.abs(got).max() > 1000
    assert np.abs(got - want).max() <= 2 * ATOL * 0.6 * 32767 / peak + 1
    # a name of "" is the first speaker
    assert np.array_equal(_pcm(embed.synthesize(EMBED_TEXT, "")),
                          _pcm(embed.synthesize(EMBED_TEXT, "spk0")))

    # streamed chunks: clipped and scaled by 32767, no peak
    got = [_pcm(c) for c in embed.stream_synthesize(EMBED_TEXT, "spk1")]
    want = [_pcm(c) for c in jax_embed.stream_synthesize(EMBED_TEXT, "spk1")]
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= ATOL * 32767 + 1


def test_embed_steering_and_errors(bundle, monkeypatch):
    import torch

    monkeypatch.setattr(embed, "_MODEL", None)
    with pytest.raises(RuntimeError, match="init"):
        embed.synthesize("p1")
    with pytest.raises(RuntimeError, match="init"):
        next(embed.stream_synthesize("p1"))
    monkeypatch.setenv("WETTS_DEVICE", "cpu")
    monkeypatch.setenv("WETTS_PRECISION", "int-8")
    with pytest.raises(ValueError, match="precision"):
        embed.init(bundle)
    monkeypatch.setenv("WETTS_PRECISION", "int8")
    embed.init(bundle)
    assert embed._MODEL.engine.precision == "int8"
    assert len(embed.synthesize("p1 p2 p3", "spk1")) > 0
    monkeypatch.delenv("WETTS_PRECISION")
    monkeypatch.delenv("WETTS_DEVICE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            embed.init(bundle)

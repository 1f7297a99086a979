"""The port's model bundle (`cli/model.py`), its `tts` CLI, the hub, the
export stage and the artifact readers, held against the JAX package on the
CPU at the small configs of tests/torch_port_common.py.

Every artifact is built in the released layout from a random port model
(`chip_smoke.random_init_`): a training dir of numbered `G_<step>.pth` with a
`D_*.pth` beside it, a `final.onnx` with weight norm folded and the tensors
the inference trace never touches (`enc_q.*`, `dp.flows.1.*`) left out, a
`params.npz` written by either package's `export_bundle`, and the port's
`Trainer` checkpoint.

The JAX side is kept cheap: each JAX `Model` jits anew (some 10 s a
precision here), and a JAX `Model` of a `final.onnx` merges over a full
`init_state` (about a minute). So one module fixture builds one JAX `Model`
per precision on the bundle the port exported, which is also the check that
the JAX package reads the port's bundle; every other artifact is held to
it through equal weights: the JAX package's own readers give the same flax
tree for it (exactly, or for the folded `final.onnx` within the float
rounding of the fold), and a `Model`'s audio is a function of its tree.
Synthesis runs at the `Model`'s fixed scales (0.667, 1, 0.8) with the same
patterned draws on both sides (`patch_shared_draws`).

int16 bounds: `Model.synthesis` scales by 0.6 * 32767 / peak, so two waves
within atol a of each other (and so their peaks) give int16 audio within
2 * a * 19660.2 / peak + 1 (the 1 for the truncation).
"""

import copy
import dataclasses
import json
import logging
import os
import sys
import tarfile
import wave
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from chip_smoke import random_init_
from onnx_writer import write_initializers_onnx
from test_torch_vits2 import vits2_cfg
from torch_port_common import patch_shared_draws, small_cfg_dict
from wetts_tpu.bin import export_bundle as jax_export
from wetts_tpu.cli import model as jax_model
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.models import bert_frontend as jax_bert
from wetts_tpu.utils import convert as jax_convert
from wetts_tpu.utils import onnx_import as jax_onnx
from wetts_tpu.utils import params_io as jax_params_io
from wetts_tpu_torch.bin import export_bundle, infer_vits
from wetts_tpu_torch.cli import hub, model, tts
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.bert_frontend import (
    BertConfig,
    FrontendModel,
    convert_frontend_torch,
)
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.utils import convert, onnx_import, params_io

CFG = small_cfg_dict()
PHONES = ["sil"] + [f"p{i}" for i in range(1, 24)]
SPEAKERS = ["spk0", "spk1", "spk2"]
TEXTS = [("p1 p5 p9 p2 p7 p3 p11 p4", "spk1"), ("p3 p2 p8 p6 p1", "spk0")]
SCALE = 0.6 * 32767.0
ATOL_F32 = 2e-4  # the port's f32 parity tolerance on the float wave
ATOL_REDUCED = 5e-2  # tests/test_torch_half.py's engine drift bound


def _state(m: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


def _folded(sd: dict) -> dict:
    """A state_dict with weight norm removed, as the reference's export
    does (export_onnx.py:80-82): `weight` = g * v / ||v|| over all axes but
    the first."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            g = torch.from_numpy(sd[k[:-2] + "_g"])
            k, v = k[:-2], torch._weight_norm(torch.from_numpy(v), g,
                                              0).numpy()
        out[k] = v
    return out


def _onnx_tensors(sd: dict) -> dict:
    """The initializers of a released final.onnx: folded, without the
    posterior encoder and the SDP flow the inference trace drops."""
    return {k: v for k, v in _folded(sd).items()
            if not k.startswith(("enc_q.", "dp.flows.1."))}


def _tables(d, cfg_dict=CFG):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "phones.txt"), "w") as f:
        f.write("".join(f"{p} {i}\n" for i, p in enumerate(PHONES)))
    with open(os.path.join(d, "speaker.txt"), "w") as f:
        f.write("".join(f"{s} {i}\n" for i, s in enumerate(SPEAKERS)))
    if cfg_dict is not None:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg_dict, f)
    return str(d)


def _port_model(cfg_dict=CFG, seed=0) -> Synthesizer:
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    return random_init_(Synthesizer(cfg), seed).eval()


def _export_args(src, out, fold=False):
    return (["--cfg", os.path.join(src, "config.json"), "--model_dir", src,
             "--phone_table", os.path.join(src, "phones.txt"),
             "--speaker_table", os.path.join(src, "speaker.txt"),
             "--out_dir", out] + (["--fold_weight_norm"] if fold else []))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Every artifact kind, all of one random model (seed 0)."""
    root = tmp_path_factory.mktemp("bundles")
    net = _port_model()
    sd = _state(net)
    out = {"net": net, "sd": sd}

    g = _tables(root / "g")
    # the lower step holds other weights: the highest step must be taken
    torch.save({"model": _port_model(seed=1).state_dict(), "iteration": 5},
               os.path.join(g, "G_50000.pth"))
    torch.save({"model": net.state_dict(), "iteration": 9,
                "learning_rate": 2e-4}, os.path.join(g, "G_90000.pth"))
    torch.save({"model": {}, "iteration": 9}, os.path.join(g, "D_90000.pth"))
    out["g"] = g

    onnx = _tables(root / "onnx")
    write_initializers_onnx(os.path.join(onnx, "final.onnx"),
                            _onnx_tensors(sd))
    out["onnx"] = onnx

    ckpt = _tables(root / "ckpt")
    os.makedirs(os.path.join(ckpt, "checkpoint"))
    torch.save({"step": 7, "net_g": net.state_dict()},
               os.path.join(ckpt, "checkpoint", "ckpt_7.pt"))
    out["ckpt"] = ckpt

    out["port_npz"] = str(root / "port_npz")
    export_bundle.main(_export_args(g, out["port_npz"]))
    out["jax_npz"] = str(root / "jax_npz")
    with mock.patch.object(sys, "argv", ["export_bundle"]
                           + _export_args(g, out["jax_npz"])):
        jax_export.main()
    return out


@pytest.fixture(scope="module")
def jax_audio(bundles):
    """int16 audio of TEXTS from the JAX `Model` of the port's exported
    bundle, per precision, under the shared draws."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_shared_draws(mp)
        for precision in ("f32", "bf16", "int8"):
            m = jax_model.Model(bundles["port_npz"], precision=precision,
                                on_device_bucketing=False)
            out[precision] = [m.synthesis(t, s) for t, s in TEXTS]
    return out


def _check_int16(port: model.Model, want, atol: float, corr: float = None):
    """port's Model.synthesis of TEXTS against `want` within the int16
    bound that `atol` on the float wave implies (see the module
    docstring); the float wave is the port engine's, whose peak sets the
    scale."""
    for (text, spk), w in zip(TEXTS, want):
        wave_f = port.engine.synthesize(text, spk)
        peak = max(0.01, float(np.abs(wave_f).max()))
        got = port.synthesis(text, spk)
        np.testing.assert_array_equal(
            got, (wave_f * 32767.0 / peak * 0.6).astype(np.int16))
        assert got.dtype == np.int16 and got.shape == w.shape
        assert np.abs(got.astype(np.int32)).max() > 1000
        bound = 2 * atol * SCALE / peak + 1
        err = np.abs(got.astype(np.int32) - w.astype(np.int32)).max()
        assert err <= bound, (err, bound)
        if corr is not None:
            assert np.corrcoef(got, w)[0, 1] > corr


# ---------------------------------------------------------------------------
# the readers and the converter
# ---------------------------------------------------------------------------


def test_onnx_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a.weight": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "half": rng.standard_normal((7,)).astype(np.float16),
        "ids": rng.integers(-9, 9, (2, 3)).astype(np.int64),
        "mask": rng.random((4,)) > 0.5,
        "scalar": np.float32(1.5).reshape(()),
    }
    path = str(tmp_path / "final.onnx")
    write_initializers_onnx(path, tensors)
    got = onnx_import.read_onnx_initializers(path)
    want = jax_onnx.read_onnx_initializers(path)
    assert list(got) == list(want) == list(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == want[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], v)


def test_npz_both_ways_with_a_bf16_leaf(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    # bf16 values: exact in both dtypes
    b = torch.from_numpy(b).bfloat16()
    port_tree = {"enc_p": {"emb": w, "proj": {"bias": b}}}
    params_io.save_params_npz(str(tmp_path / "port.npz"), port_tree)
    got = jax_params_io.load_params_npz(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(got["enc_p"]["emb"], w)
    assert got["enc_p"]["proj"]["bias"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        got["enc_p"]["proj"]["bias"].astype(np.float32), b.float().numpy())

    jax_tree = {"enc_p": {"emb": w, "proj": {
        "bias": b.float().numpy().astype(ml_dtypes.bfloat16)}}}
    jax_params_io.save_params_npz(str(tmp_path / "jax.npz"), jax_tree)
    back = params_io.load_params_npz(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(back["enc_p"]["emb"], w)
    assert back["enc_p"]["proj"]["bias"].dtype == np.float32
    np.testing.assert_array_equal(back["enc_p"]["proj"]["bias"],
                                  b.float().numpy())
    # the same bytes under the same keys
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            np.testing.assert_array_equal(p[k], j[k])


def _assert_trees_equal(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", ["v1_small", "vits2_vocos_small"])
def test_convert_synthesizer_equals_jax(name):
    """Exactly JAX's tree, the reference quirks handled alike (the unused
    `post_transformer` of a pre_conv flow dropped, an unmapped tensor an
    error), and the bridge back to the port is the identity."""
    cfg_dict = CFG if name == "v1_small" else vits2_cfg("pre_conv")
    net = _port_model(cfg_dict)
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    jcfg = JaxConfig.from_dict(copy.deepcopy(cfg_dict))
    sd = _state(net)
    if name != "v1_small":
        sd["flow.flows.0.post_transformer.conv_o.weight"] = np.ones(
            (4, 4, 1), np.float32)
    got = convert.convert_synthesizer(sd, cfg)
    _assert_trees_equal(got, jax_convert.convert_synthesizer(sd, jcfg))
    back = convert.params_from_jax(got, cfg)
    state = net.state_dict()
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    # a partial (exported) state_dict: subset mapping, leftovers tolerated
    part = _onnx_tensors(sd)
    part["onnx::Gather_12"] = np.zeros(3, np.int64)
    _assert_trees_equal(convert.convert_synthesizer(part, cfg, subset=True),
                        jax_convert.convert_synthesizer(part, jcfg,
                                                        subset=True))
    sd["bogus.weight"] = np.ones(2, np.float32)
    for fn, c in ((convert.convert_synthesizer, cfg),
                  (jax_convert.convert_synthesizer, jcfg)):
        with pytest.raises(ValueError, match="unmapped reference tensors"):
            fn(sd, c)


def test_load_params_finds_every_artifact(bundles, tmp_path):
    """`load_params` on each artifact gives the JAX package's tree of the
    same artifact (the final.onnx on the leaves the graph carries, the
    fresh init elsewhere); the Trainer checkpoint is found under
    checkpoint/ and under the directory itself; nothing found raises."""
    cfg = Config.from_dict(copy.deepcopy(CFG))
    jcfg = JaxConfig.from_dict(copy.deepcopy(CFG))
    want = jax_convert.convert_synthesizer(bundles["sd"], jcfg)
    for kind in ("g", "port_npz", "jax_npz", "ckpt"):
        _assert_trees_equal(model.load_params(bundles[kind], cfg)["params"],
                            want)
    _assert_trees_equal(
        jax_params_io.load_params_npz(
            os.path.join(bundles["port_npz"], "params.npz")),
        jax_params_io.load_params_npz(
            os.path.join(bundles["jax_npz"], "params.npz")))
    assert model._latest_g_pth(bundles["g"]).endswith("G_90000.pth")
    assert jax_model._latest_g_pth(bundles["g"]).endswith("G_90000.pth")

    onnx_tree = model.load_params(bundles["onnx"], cfg)["params"]
    sd = jax_onnx.read_onnx_initializers(
        os.path.join(bundles["onnx"], "final.onnx"))
    partial = jax_convert.convert_synthesizer(sd, jcfg, subset=True)

    def check(got, part):
        for k, v in part.items():
            if isinstance(v, dict):
                check(got[k], v)
            else:
                np.testing.assert_array_equal(got[k], v)

    check(onnx_tree, partial)
    assert "enc_q" in onnx_tree and "enc_q" not in partial

    flat = tmp_path / "flat"
    flat.mkdir()
    torch.save({"step": 3, "net_g": bundles["net"].state_dict()},
               flat / "ckpt_3.pt")
    _assert_trees_equal(model.load_params(str(flat), cfg)["params"], want)
    with pytest.raises(FileNotFoundError):
        model.load_params(str(tmp_path), cfg)


# ---------------------------------------------------------------------------
# Model against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["g", "onnx", "port_npz", "jax_npz",
                                  "ckpt"])
def test_model_matches_jax(bundles, jax_audio, kind, monkeypatch):
    """Each artifact kind through the port's Model against the JAX Model's
    audio, f32, within the int16 bound of atol 2e-4."""
    patch_shared_draws(monkeypatch)
    port = model.Model(bundles[kind], device="cpu")
    assert port.engine.precision == "f32" and port.sample_rate == 22050
    _check_int16(port, jax_audio["f32"], ATOL_F32)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_reduced_model_matches_jax(bundles, jax_audio, precision,
                                   monkeypatch):
    """The reduced Models against the JAX Model of the same precision and
    against the f32 JAX Model, within tests/test_torch_half.py's bounds
    (max abs err 5e-2 on the float wave, correlation > 0.99)."""
    patch_shared_draws(monkeypatch)
    port = model.Model(bundles["port_npz"], precision=precision,
                       device="cpu")
    assert port.engine.precision == precision
    for want in (jax_audio[precision], jax_audio["f32"]):
        _check_int16(port, want, ATOL_REDUCED, corr=0.99)


def test_invalid_precision_raises_as_jax(bundles):
    with pytest.raises(ValueError) as got:
        model.Model(bundles["g"], precision="int-8", device="cpu")
    with pytest.raises(ValueError) as want:
        jax_model.Model(bundles["g"], precision="int-8")
    assert str(got.value) == str(want.value)


def test_model_refuses_to_run_without_a_gpu(bundles):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.Model(bundles["g"])


@pytest.mark.parametrize("entry", ["model", "voice_convert"])
def test_entry_points_turn_tf32_off(bundles, tmp_path, monkeypatch, entry):
    """cuDNN's default TF32 would round the f32 path's convolutions to a
    10-bit mantissa on the card; `Model` and `bin/voice_convert` turn it
    off (infer_vits too: test_infer_vits_reads_released_artifacts)."""
    from wetts_tpu_torch.bin import voice_convert
    from wetts_tpu_torch.utils.wav import write_wav

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    if entry == "model":
        model.Model(bundles["g"], device="cpu")
    else:
        d = bundles["port_npz"]
        source = np.random.default_rng(3).standard_normal(2048) * 0.2
        write_wav(str(tmp_path / "in.wav"), source.astype(np.float32), 22050)
        voice_convert.main([
            "--cfg", os.path.join(d, "config.json"), "--model_dir", d,
            "--phone_table", os.path.join(d, "phones.txt"),
            "--speaker_table", os.path.join(d, "speaker.txt"),
            "--wav", str(tmp_path / "in.wav"), "--source_speaker", "spk0",
            "--target_speaker", "spk1", "--out", str(tmp_path / "out.wav"),
            "--device", "cpu"])
        assert (tmp_path / "out.wav").exists()
    assert torch.backends.cudnn.allow_tf32 is False


def test_vocos_bundle_serves_f32_with_a_warning(tmp_path, caplog):
    """A Vocos bundle asked for bf16 or int8 logs the JAX engine's warning
    and serves f32: its audio equals the f32 Model's exactly."""
    cfg_dict = vits2_cfg("pre_conv")
    d = _tables(tmp_path / "vocos", cfg_dict)
    torch.save({"model": _port_model(cfg_dict).state_dict()},
               os.path.join(d, "G_1.pth"))
    want = model.Model(d, device="cpu").synthesis(*TEXTS[0])
    for precision in ("bf16", "int8"):
        caplog.clear()
        with caplog.at_level(logging.WARNING, "wetts_tpu_torch.serving"):
            m = model.Model(d, precision=precision, device="cpu")
        assert m.engine.precision == "f32"
        assert any("serving the f32 decoder instead" in r.getMessage()
                   for r in caplog.records)
        np.testing.assert_array_equal(m.synthesis(*TEXTS[0]), want)


def test_onnx_bundle_without_config_uses_vendored(bundles, jax_audio,
                                                  tmp_path, monkeypatch):
    """A released runtime bundle has no config.json: the Model takes the
    vendored multilingual_v3 config (pointed here at the small config, as
    tests/test_hub.py does for the JAX package)."""
    import wetts_tpu.assets as jax_assets
    import wetts_tpu_torch.assets as assets

    vendored = assets.asset_path("configs", "multilingual_v3.json")
    with open(vendored) as f, open(jax_assets.asset_path(
            "configs", "multilingual_v3.json")) as g:
        assert json.load(f) == json.load(g)
    Config.from_json(vendored)

    d = _tables(tmp_path / "nocfg", cfg_dict=None)
    os.symlink(os.path.join(bundles["onnx"], "final.onnx"),
               os.path.join(d, "final.onnx"))
    cfg_file = tmp_path / "small.json"
    cfg_file.write_text(json.dumps(CFG))
    asked = []
    monkeypatch.setattr(assets, "asset_path",
                        lambda *parts: asked.append(parts) or str(cfg_file))
    patch_shared_draws(monkeypatch)
    port = model.Model(d, device="cpu")
    assert asked == [("configs", "multilingual_v3.json")]
    _check_int16(port, jax_audio["f32"], ATOL_F32)


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------


def _tar(src, archive, arcname):
    with tarfile.open(archive, "w:gz") as tar:
        tar.add(src, arcname=arcname)


@pytest.fixture()
def hub_home(tmp_path, monkeypatch):
    home = tmp_path / "hub_home"
    home.mkdir()
    monkeypatch.setenv("WETTS_TPU_HOME", str(home))
    return home


def test_hub_extracts_and_loads_exp_release(bundles, hub_home):
    _tar(bundles["g"], hub_home / "multilingual_vits_v3_exp.tar.gz",
         "multilingual_vits_v3_exp")
    d = hub.get_model("vits")
    assert os.path.basename(d) == "multilingual_vits_v3_exp"
    assert hub.get_model("vits") == d  # the cached extraction
    assert model._latest_g_pth(d).endswith("G_90000.pth")
    audio = model.Model(d, device="cpu").synthesis("p1 p2 p3 p1", "spk1")
    assert audio.dtype == np.int16 and audio.size > 0


def test_hub_bundle_root_and_extract(tmp_path):
    one = tmp_path / "one"
    (one / "wrapper").mkdir(parents=True)
    assert hub._bundle_root(str(one)) == str(one / "wrapper")
    (one / "other.txt").write_text("x")
    assert hub._bundle_root(str(one)) == str(one)
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("a")
    _tar(src, tmp_path / "a.tar.gz", "payload")
    hub.extract(str(tmp_path / "a.tar.gz"), str(tmp_path / "out"))
    assert (tmp_path / "out" / "payload" / "a.txt").read_text() == "a"


def test_default_model_dir_without_frontend(bundles, hub_home, monkeypatch):
    """The zero-config path: the VITS bundle resolves, and a failing
    frontend fetch (a missing file:// archive) leaves raw-phone mode."""
    _tar(bundles["g"], hub_home / "multilingual_vits_v3_exp.tar.gz",
         "multilingual_vits_v3_exp")
    monkeypatch.setitem(
        hub.MODEL_URLS, "frontend",
        ("file:///nonexistent/frontend.tar.gz", "frontend.tar.gz"))
    d = hub.get_default_model_dir()
    assert os.path.exists(os.path.join(d, "G_90000.pth"))
    assert not os.path.exists(os.path.join(d, "frontend"))


def test_default_model_dir_links_a_prepared_frontend(bundles, hub_home,
                                                     tmp_path):
    _tar(bundles["g"], hub_home / "multilingual_vits_v3_exp.tar.gz",
         "multilingual_vits_v3_exp")
    fe = tmp_path / "fe"
    fe.mkdir()
    (fe / "vocab.txt").write_text("[CLS]\n")
    _tar(fe, hub_home / "baker_bert_onnx.tar.gz", "baker_bert_onnx")
    d = hub.get_default_model_dir()
    link = os.path.join(d, "frontend")
    assert os.path.islink(link)
    assert os.path.exists(os.path.join(link, "vocab.txt"))


def test_unknown_model_name_raises():
    with pytest.raises(KeyError):
        hub.get_model("nope")


# ---------------------------------------------------------------------------
# the frontend in both layouts
# ---------------------------------------------------------------------------

FE_VOCAB = ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "你", "好", "了"]


def _frontend_dir(d, bert: BertConfig, layout: str, seed: int):
    """A frontend bundle of a random port FrontendModel: the JAX export's
    config.json + params.npz (written by the port) or a released
    final.onnx, with vocab.txt and lexicon/."""
    torch.manual_seed(seed)
    # the onnx layout's transform heads are inferred: 8 at any width but 312
    heads = 2 if layout == "npz" else 8
    fm = FrontendModel(6, 5, bert, transform_heads=heads, transform_ffn=48)
    sd = _state(fm)
    (d / "lexicon").mkdir(parents=True)
    if layout == "onnx":
        write_initializers_onnx(str(d / "final.onnx"), sd)
    else:
        params_io.save_params_npz(str(d / "params.npz"),
                                  convert_frontend_torch(sd)[0])
        (d / "config.json").write_text(json.dumps({
            "bert": dataclasses.asdict(bert), "num_polyphones": 6,
            "num_prosody": 5, "transform_heads": heads,
            "transform_ffn": 48}))
    (d / "vocab.txt").write_text("\n".join(FE_VOCAB) + "\n")
    (d / "lexicon" / "polyphone.txt").write_text(
        "ni3\nhao3\nle5\nliao3\nla1\nlo5\n")
    (d / "lexicon" / "pinyin_dict.txt").write_text(
        "你 ni3\n好 hao3\n了 le5,liao3\n")
    (d / "lexicon" / "lexicon.txt").write_text(
        "ni3 n i3\nhao3 h ao3\nle5 l e5\nliao3 l iao3\n")
    return sd


@pytest.mark.parametrize("layout", ["npz", "onnx"])
def test_load_frontend_matches_jax(tmp_path, layout):
    """`_load_frontend` in both layouts gives JAX's posteriors within 1e-5:
    BertConfig.tiny for the npz layout; the onnx layout infers the heads
    from the width (hidden // 64), so it takes tiny at width 64."""
    bert = (BertConfig.tiny(len(FE_VOCAB)) if layout == "npz" else
            dataclasses.replace(BertConfig.tiny(len(FE_VOCAB)),
                                hidden_size=64, num_heads=1))
    sd = _frontend_dir(tmp_path, bert, layout, seed=3)
    if layout == "onnx":
        got_p, got_m = convert_frontend_torch(sd)
        want_p, want_m = jax_bert.convert_frontend_torch(sd)
        _assert_trees_equal(got_p, jax.tree.map(np.asarray, want_p))
        assert dataclasses.asdict(got_m["bert"]) == dataclasses.asdict(
            want_m["bert"])
        assert {k: v for k, v in got_m.items() if k != "bert"} == \
            {k: v for k, v in want_m.items() if k != "bert"}
    fe = model._load_frontend(str(tmp_path), "cpu")
    jfe = jax_model._load_frontend(str(tmp_path))
    ids = np.array([1, 4, 5, 6, 2], np.int64)
    for got, want in zip(fe.scorer(ids), jfe.scorer(ids)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert fe.compute("你好了") == jfe.compute("你好了")
    assert fe.compute("你好了")[-1] == "#4"


def test_model_with_a_frontend_and_its_fallback(bundles, tmp_path):
    """A bundle with frontend/ takes Mandarin text; an unreadable frontend
    leaves raw-phone input with a warning, as the JAX Model does."""
    d = tmp_path / "fe_bundle"
    d.mkdir()
    for f in ("config.json", "phones.txt", "speaker.txt", "params.npz"):
        os.symlink(os.path.join(bundles["port_npz"], f), d / f)
    _frontend_dir(d / "frontend", BertConfig.tiny(len(FE_VOCAB)), "npz", 4)
    # the frontend's phones on ids the model has (its embedding is fixed)
    with open(d / "phones.txt") as f:
        table = f.read()
    os.remove(d / "phones.txt")
    (d / "phones.txt").write_text(table + "".join(
        f"{p} {i}\n" for i, p in enumerate(
            ["n", "i3", "h", "ao3", "l", "e5", "#0", "#1", "#2", "#3", "#4"],
            start=1)))
    m = model.Model(str(d), device="cpu")
    assert m.engine.frontend is not None
    audio = m.synthesis("你好了", "spk0")
    assert audio.dtype == np.int16 and audio.size > 0

    os.remove(d / "frontend" / "params.npz")
    with pytest.warns(UserWarning, match="raw-phone input mode"):
        m = model.Model(str(d), device="cpu")
    assert m.engine.frontend is None
    assert m.synthesis("p1 p2 p3", "spk0").size > 0


# ---------------------------------------------------------------------------
# the CLI, the export stage and stage 2 of the recipe
# ---------------------------------------------------------------------------


def test_tts_cli_writes_the_model_audio(bundles, tmp_path, capsys):
    out = tmp_path / "out.wav"
    tts.main(["--model-dir", bundles["g"], "--text", TEXTS[0][0],
              "--speaker", TEXTS[0][1], "--wav", str(out),
              "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    with wave.open(str(out)) as w:
        assert w.getframerate() == 22050 and w.getsampwidth() == 2
        got = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    want = model.Model(bundles["g"], device="cpu").synthesis(*TEXTS[0])
    np.testing.assert_array_equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tts.main(["--model-dir", bundles["g"], "--text", "p1",
                      "--wav", str(out)])


def test_fold_weight_norm_equals_jax(bundles, tmp_path, monkeypatch):
    """The port's fold equals JAX's on the flax tree (whose upsamples' kernel
    sizes differ from their input channels); the folded bundle of either
    package is the same file, and its audio is the unfolded bundle's within
    the f32 bound."""
    cfg = Config.from_dict(copy.deepcopy(CFG))
    tree = model.load_params(bundles["g"], cfg)["params"]
    got = export_bundle.fold_weight_norm(tree)
    _assert_trees_equal(got, jax_export.fold_weight_norm(tree))
    assert np.abs(got["dec"]["up_0"]["v"] - tree["dec"]["up_0"]["v"]).max() > 0
    # an upsample whose kernel size equals its input channels keeps its
    # weight g * v / ||v|| over (O, K) (the JAX package's fold, which tells
    # the layouts apart by shape, normalizes it as a conv [K, I, O])
    rng = np.random.default_rng(3)
    up = {"v": rng.standard_normal((16, 8, 16)).astype(np.float32),
          "g": rng.uniform(0.5, 2.0, 16).astype(np.float32)}

    def weight(p):
        v = p["v"].astype(np.float64)
        return p["g"][:, None, None] * v / np.sqrt(
            (v * v).sum(axis=(1, 2), keepdims=True))

    folded_up = export_bundle.fold_weight_norm({"dec": {"up_1": up}})
    np.testing.assert_allclose(weight(folded_up["dec"]["up_1"]), weight(up),
                               rtol=1e-6)

    folded = str(tmp_path / "folded")
    export_bundle.main(_export_args(bundles["g"], folded, fold=True))
    jax_folded = str(tmp_path / "jax_folded")
    with mock.patch.object(sys, "argv", ["export_bundle"] + _export_args(
            bundles["g"], jax_folded, fold=True)):
        jax_export.main()
    _assert_trees_equal(
        params_io.load_params_npz(os.path.join(folded, "params.npz")),
        params_io.load_params_npz(os.path.join(jax_folded, "params.npz")))
    patch_shared_draws(monkeypatch)
    want = [model.Model(bundles["g"], device="cpu").synthesis(t, s)
            for t, s in TEXTS]
    _check_int16(model.Model(folded, device="cpu"), want, ATOL_F32)


@pytest.mark.parametrize("kind", ["g", "onnx"])
def test_infer_vits_reads_released_artifacts(bundles, tmp_path, capsys,
                                             kind, monkeypatch):
    """Stage 2 of the recipe on a released G_*.pth or final.onnx (the
    params.npz and Trainer checkpoint cases are in test_torch_half.py),
    with cuDNN's TF32 turned off."""
    from wetts_tpu_torch.utils.wav import read_wav

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    d = bundles[kind]
    (tmp_path / "test.txt").write_text("x/utt1.wav|spk1|p1 p2 p3 p4\n")
    infer_vits.main([
        "--cfg", os.path.join(d, "config.json"), "--model_dir", d,
        "--phone_table", os.path.join(d, "phones.txt"),
        "--speaker_table", os.path.join(d, "speaker.txt"),
        "--test_file", str(tmp_path / "test.txt"),
        "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert "utt1:" in capsys.readouterr().out
    assert torch.backends.cudnn.allow_tf32 is False
    wav, rate = read_wav(str(tmp_path / "out" / "utt1.wav"))
    assert rate == 22050 and wav.size > 0 and wav.size % 16 == 0

"""Reduced-precision serving in the port (`precision="bf16"`: bf16 flow and
decoder; "int8": bf16 flow, int8 decoder) held against the port's own f32
path and against the JAX package with the matching option (`half`,
`quantize`).

The two frameworks round bf16 at other places, so nothing here is exact:
each test states the bound it uses, which is the JAX package's own for its
reduced decoder (tests/test_hifigan_fast.py:93-99,137-140) and engine
(tests/test_serving.py:154-178).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quant import GEN, _jax_decode, _latents, decoders  # noqa: F401
from torch_port_common import (
    jax_synthesizer,
    patch_shared_draws,
    port_synthesizer,
    small_cfg_dict,
)
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer
from wetts_tpu.serving.engine import SynthesisEngine as JaxEngine
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.serving.engine import SynthesisEngine


def test_bf16_decoder_within_the_jax_bounds(decoders):  # noqa: F811
    """The bf16 decoder against f32 and against JAX's bf16 decoder: max abs
    err < 3e-2 on the tanh-bounded wave, correlation > 0.995."""
    params, port = decoders
    x, spk = _latents(1)
    xt = torch.from_numpy(x).transpose(1, 2)
    gt = torch.from_numpy(spk).transpose(1, 2)
    with torch.no_grad():
        exact = port(xt, gt).transpose(1, 2).numpy()
        got = port(xt, gt, precision="bf16").transpose(1, 2).numpy()
    assert got.dtype == np.float32 and got.shape == exact.shape
    for want in (exact, _jax_decode(params, x, spk, dtype=jnp.bfloat16)):
        assert np.abs(got - want).max() < 3e-2
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.995


def test_bf16_flow_reverse_tracks_f32_and_jax():
    """The flow reverse on the bf16 copy of its folded parameters (inputs
    cast, output bf16) against the f32 flow and against the JAX flow on
    bf16-cast parameters: max abs err < 5e-2 of max |z| (4 couplings of 4
    WN layers in bf16, 8 bits of mantissa), correlation > 0.999; the mask
    holds exactly."""
    cfg = small_cfg_dict()
    jmodel, params = jax_synthesizer(cfg)
    port = port_synthesizer(cfg, params)
    rng = np.random.default_rng(6)
    z_p = rng.standard_normal((2, 24, 32)).astype(np.float32)
    mask = np.ones((2, 24, 1), np.float32)
    mask[1, 15:] = 0
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    half = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want_jax = np.asarray(jmodel.apply(
        half, jnp.asarray(z_p, jnp.bfloat16), jnp.asarray(mask, jnp.bfloat16),
        jnp.asarray(g, jnp.bfloat16), method=JaxSynthesizer.flow_reverse
    ).astype(jnp.float32))
    with torch.no_grad():
        args = [torch.from_numpy(a) for a in (z_p, mask, g)]
        exact = port.flow_reverse(*args).numpy()
        got = port.flow_reverse(*args, precision="bf16")
        assert port.flow_at("bf16") is port.flow_at("bf16")  # made once
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert not got[1, 15:].any()
    for want in (exact, want_jax):
        assert np.abs(got - want).max() < 5e-2 * np.abs(want).max()
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


ENGINE_CFG = {  # tests/test_serving.py's engine config
    "train": {"segment_size": 2048},
    "data": {"filter_length": 256, "hop_length": 64, "win_length": 256,
             "sampling_rate": 8000},
    "model": {
        "inter_channels": 16, "hidden_channels": 16,
        "filter_channels": 32, "n_heads": 2, "n_layers": 1,
        "kernel_size": 3, "p_dropout": 0.1, "resblock": "2",
        "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
        "upsample_rates": [4, 4, 2, 2], "upsample_initial_channel": 32,
        "upsample_kernel_sizes": [8, 8, 4, 4], "gin_channels": 8,
    },
    "num_phones": 16, "num_speakers": 2}
PHONES = {"sil": 0, "a": 1, "b": 2, "c": 3}
SPEAKERS = {"spk0": 0, "spk1": 1}
BATCH, SIDS = [[1, 2, 3, 1, 2], [3, 2, 1]], [0, 1]
# the JAX engine's option -> the port engine's precision
PRECISION = {"half": "bf16", "quantize": "int8"}


@pytest.mark.parametrize("option", ["half", "quantize"])
def test_reduced_engine_drift_bounded(option, monkeypatch):
    """As test_half_precision_drift_bounded, for `half` and `quantize`: the
    port's reduced engine against its f32 engine and against the JAX engine
    with the same option, at the default noise scales with the same
    patterned draws on both sides. Lengths are equal (the duration path
    stays f32); max abs err < 5e-2; correlation > 0.99."""
    _, params = jax_synthesizer(ENGINE_CFG)
    patch_shared_draws(monkeypatch)
    jax_engine = JaxEngine(JaxConfig.from_dict(copy.deepcopy(ENGINE_CFG)),
                           jax.tree.map(jnp.asarray, params), PHONES,
                           SPEAKERS, on_device_bucketing=False,
                           **{option: True})
    want_jax = jax_engine.synthesize_ids_batch(BATCH, SIDS)

    def port_engine(**kw):
        return SynthesisEngine(Config.from_dict(copy.deepcopy(ENGINE_CFG)),
                               port_synthesizer(ENGINE_CFG, params), PHONES,
                               SPEAKERS, device="cpu", **kw)

    exact = port_engine().synthesize_ids_batch(BATCH, SIDS)
    reduced = port_engine(precision=PRECISION[option])
    assert reduced.precision == PRECISION[option]
    got = reduced.synthesize_ids_batch(BATCH, SIDS)
    for want in (exact, want_jax):
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert g.size > 0 and np.isfinite(g).all()
            assert np.abs(g - w).max() < 5e-2
            assert np.corrcoef(g, w)[0, 1] > 0.99


VITS2_ENGINE_CFG = copy.deepcopy(ENGINE_CFG)  # vits2_v1.json's flow type
VITS2_ENGINE_CFG["model"].update(use_transformer_flows=True,
                                 transformer_flow_type="pre_conv")


@pytest.mark.parametrize("option", ["half", "quantize"])
def test_reduced_vits2_engine_drift_bounded(option, monkeypatch):
    """test_reduced_engine_drift_bounded on `pre_conv` transformer flows
    (vits2_v1.json's): the bf16 flow copy casts the attention and LayerNorm
    parameters with the rest, as the JAX engine casts every float leaf.
    The same bounds: equal lengths, max abs err < 5e-2, correlation >
    0.99, against the port's f32 engine and the JAX engine with the same
    option."""
    _, params = jax_synthesizer(VITS2_ENGINE_CFG)
    patch_shared_draws(monkeypatch)
    jax_engine = JaxEngine(
        JaxConfig.from_dict(copy.deepcopy(VITS2_ENGINE_CFG)),
        jax.tree.map(jnp.asarray, params), PHONES, SPEAKERS,
        on_device_bucketing=False, **{option: True})
    want_jax = jax_engine.synthesize_ids_batch(BATCH, SIDS)

    def port_engine(**kw):
        return SynthesisEngine(
            Config.from_dict(copy.deepcopy(VITS2_ENGINE_CFG)),
            port_synthesizer(VITS2_ENGINE_CFG, params), PHONES, SPEAKERS,
            device="cpu", **kw)

    exact = port_engine().synthesize_ids_batch(BATCH, SIDS)
    reduced = port_engine(precision=PRECISION[option])
    flow = reduced.model.flow_at("bf16")
    assert {p.dtype for p in flow.parameters()} == {torch.bfloat16}
    got = reduced.synthesize_ids_batch(BATCH, SIDS)
    for want in (exact, want_jax):
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert g.size > 0 and np.isfinite(g).all()
            assert np.abs(g - w).max() < 5e-2
            assert np.corrcoef(g, w)[0, 1] > 0.99


def test_reduced_engine_refuses_another_vocoder():
    """A decoder with no route at a reduced precision (Vocos: f32 only)
    raises from its own module when the engine is built."""
    cfg_dict = copy.deepcopy(ENGINE_CFG)
    cfg_dict["model"].update(
        vocoder_type="vocos", vocos_channels=32, vocos_h_channels=48,
        vocos_out_channels=258, vocos_num_layers=2,
        vocos_istft_config={"n_fft": 256, "hop_length": 64,
                            "win_length": 256})
    cfg = Config.from_dict(cfg_dict)
    model = Synthesizer(cfg)
    for precision in PRECISION.values():
        with pytest.raises(ValueError, match="Vocos decoder runs in f32"):
            SynthesisEngine(cfg, model, PHONES, SPEAKERS, device="cpu",
                            precision=precision)


@pytest.mark.parametrize("precision,bundle", [
    ("f32", "npz"), ("bf16", "npz"), ("int8", "npz"), ("int8", "ckpt")])
def test_infer_vits_cli(tmp_path, capsys, precision, bundle):
    """`bin/infer_vits` on a tiny model: a `params.npz` bundle written by the
    JAX package, or a checkpoint as the port's Trainer writes it; one wav
    per manifest line, peak-scaled to at most 0.6 (a wave below 0.01 is
    scaled as if its peak were 0.01), and the RTF lines."""
    import json

    from wetts_tpu.utils.params_io import save_params_npz
    from wetts_tpu_torch.bin import infer_vits
    from wetts_tpu_torch.utils.wav import read_wav

    _, params = jax_synthesizer(ENGINE_CFG)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    if bundle == "npz":
        save_params_npz(str(model_dir / "params.npz"), params)
    else:
        torch.save({"step": 3, "net_g": port_synthesizer(
            ENGINE_CFG, params).state_dict()}, model_dir / "ckpt_3.pt")
    (tmp_path / "config.json").write_text(json.dumps(ENGINE_CFG))
    (tmp_path / "phones.txt").write_text("sil 0\na 1\nb 2\nc 3")
    (tmp_path / "speaker.txt").write_text("spk0 0\nspk1 1")
    (tmp_path / "test.txt").write_text(
        "x/utt1.wav|spk1|a b c a b\nx/utt2.wav|spk0|c b\nmalformed line")
    infer_vits.main([
        "--cfg", str(tmp_path / "config.json"), "--model_dir", str(model_dir),
        "--phone_table", str(tmp_path / "phones.txt"),
        "--speaker_table", str(tmp_path / "speaker.txt"),
        "--test_file", str(tmp_path / "test.txt"),
        "--outdir", str(tmp_path / "out"), "--precision", precision,
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "utt1:" in out and "utt2:" in out and "TOTAL:" in out
    assert "RTF" in out and "stages:" in out
    for name in ("utt1", "utt2"):
        wav, rate = read_wav(str(tmp_path / "out" / f"{name}.wav"))
        assert rate == 8000 and wav.size > 0 and wav.size % 64 == 0
        assert 0.0 < np.abs(wav).max() <= 0.6 + 1e-3

"""The VITS2 serving path of the port against the JAX package: the
transformer flows, the attention blocks they use, the speaker-conditioned
text encoder, the iSTFT and the Vocos decoder, Synthesizer.infer and
voice_conversion, the weight bridge, a Vocos engine and the voice-conversion
CLI.

Both sides get the same numpy inputs and the same parameters, every one of
them random (tests/torch_port_common.py:randomize, or chip_smoke's
random_init_ carried to JAX by `convert_synthesizer` for the engines), so
that no zero-initialised `post` conv hides a path. f32 on the CPU. Stated
tolerances: modules atol 2e-5; each flow stack, forward and reverse, 1e-4;
the iSTFT 1e-4; the Vocos decoder, infer and voice conversion 2e-4 (the
port's parity tolerance), times max(1, max|want|) where the Vocos decoder's
exp-magnitude spectra make the wave large.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_init_
from test_torch_engine import CFG as ENGINE_CFG
from test_torch_engine import PHONES, SCALES, SPEAKERS
from test_torch_streaming import BLOCK, PAD, RAW_TEXT
from torch_port_common import (
    jax_synthesizer,
    patch_shared_draws,
    port_synthesizer,
    randomize,
    small_cfg_dict,
)
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.models import attention as jattention
from wetts_tpu.models import flows as jflows
from wetts_tpu.models import vocos as jvocos
from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer
from wetts_tpu.ops.spectral import istft as jax_istft
from wetts_tpu.serving.engine import SynthesisEngine as JaxEngine
from wetts_tpu.train.step import compute_spec as jax_compute_spec
from wetts_tpu.utils.convert import convert_synthesizer
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models import attention, flows, vocos
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.ops import spectral
from wetts_tpu_torch.serving.engine import SynthesisEngine
from wetts_tpu_torch.utils.convert import FlaxToTorch, params_from_jax

KEY = jax.random.PRNGKey(0)
FLOW_TYPES = ("pre_conv", "pre_conv2", "fft", "mono_layer_inter_residual",
              "mono_layer_post_residual")
# Vocos at the small configs' geometry: n_fft 64 / hop 16, the data hop
VOCOS = {"vocoder_type": "vocos", "vocos_channels": 32,
         "vocos_h_channels": 48, "vocos_out_channels": 66,
         "vocos_num_layers": 2,
         "vocos_istft_config": {"n_fft": 64, "hop_length": 16,
                                "win_length": 64, "center": True}}


def vits2_cfg(ftype="pre_conv", vocoder="vocos", **overrides):
    return small_cfg_dict(use_transformer_flows=True,
                          transformer_flow_type=ftype,
                          **(VOCOS if vocoder == "vocos" else {}),
                          **overrides)


def _init(module, *args, seed=1):
    params = module.init({"params": KEY}, *args)["params"]
    return randomize(jax.device_get(params), seed)


def _bct(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a).transpose(0, 2, 1))


def _btc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 1)


def _mask(lengths, t):
    """[B, T, 1] float mask."""
    return (np.arange(t)[None, :, None]
            < np.asarray(lengths)[:, None, None]).astype(np.float32)


def _load(port, params, map_fn):
    m = FlaxToTorch(params)
    map_fn(m)
    m.check_all_used()
    port.load_state_dict(m.state)
    return port.eval()


# ---- the attention blocks ------------------------------------------------

MHA_CASES = {
    "cross": {},
    "proximal": {"proximal_bias": True},
    "window_per_head_block": {"window_size": 4, "heads_share": False,
                              "block_length": 2},
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_multi_head_attention(case):
    """Cross-attention (5 queries over 9 keys, ragged masks), the proximal
    bias, and relative embeddings per head with block-local masking; atol
    2e-5."""
    rng = np.random.default_rng(len(case))
    kw = MHA_CASES[case]
    t_t, t_s = (5, 9) if case == "cross" else (7, 7)
    x = rng.standard_normal((2, t_t, 16)).astype(np.float32)
    c = (rng.standard_normal((2, t_s, 16)).astype(np.float32)
         if case == "cross" else x)
    mask = (_mask([t_t, t_t - 2], t_t)[:, None]
            * _mask([t_s, t_s - 3], t_s)[:, None, :, 0][..., None, :])
    mask = mask.reshape(2, 1, t_t, t_s)
    jmha = jattention.MultiHeadAttention(16, 16, 2, **kw)
    params = _init(jmha, x, c, mask)
    want = jmha.apply({"params": params}, x, c, mask)
    port = _load(attention.MultiHeadAttention(
        16, 16, 2, window_size=kw.get("window_size"),
        heads_share=kw.get("heads_share", True),
        block_length=kw.get("block_length"),
        proximal_bias=kw.get("proximal_bias", False)),
        params, lambda m: m.mha((), ""))
    with torch.no_grad():
        got = port(_bct(x), _bct(c), torch.from_numpy(mask))
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=2e-5)


def test_decoder():
    """Causal self-attention with the proximal bias, enc-dec attention over
    a ragged encoder output, causal FFN; atol 2e-5 across two layers."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    h = rng.standard_normal((2, 9, 16)).astype(np.float32)
    x_mask, h_mask = _mask([7, 5], 7), _mask([9, 6], 9)
    jdec = jattention.Decoder(16, 32, 2, 2, kernel_size=3,
                              proximal_bias=True)
    params = _init(jdec, x, x_mask, h, h_mask)
    want = jdec.apply({"params": params}, x, x_mask, h, h_mask)

    def map_decoder(m):
        for i in range(2):
            for src, dst in (("self_attn", "self_attn_layers"),
                             ("encdec_attn", "encdec_attn_layers")):
                m.mha((f"{src}_{i}",), f"{dst}.{i}")
            for k in range(3):
                m.layer_norm((f"norm{k}_{i}",), f"norm_layers_{k}.{i}")
            m.ffn((f"ffn_{i}",), f"ffn_layers.{i}")

    port = _load(attention.Decoder(16, 32, 2, 2, kernel_size=3,
                                   proximal_bias=True), params, map_decoder)
    with torch.no_grad():
        got = port(_bct(x), _bct(x_mask), _bct(h), _bct(h_mask))
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("gin", [0, 8])
def test_fft_block(gin):
    """The flows' causal FFT block, two layers, with and without its gated
    speaker conditioning (cond_pre shared by the layers); atol 2e-5."""
    rng = np.random.default_rng(3 + gin)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    x_mask = _mask([11, 8], 11)
    g = rng.standard_normal((2, 1, 8)).astype(np.float32) if gin else None
    jfft = jattention.FFT(16, 32, 2, n_layers=2, kernel_size=3,
                          gin_channels=gin)
    params = _init(jfft, x, x_mask, g)
    want = jfft.apply({"params": params}, x, x_mask, g)
    port = _load(attention.FFT(16, 32, 2, 2, 3, gin_channels=gin), params,
                 lambda m: m.fft((), "", 2))
    with torch.no_grad():
        got = port(_bct(x), _bct(x_mask), None if g is None else _bct(g))
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=2e-5)


def test_speaker_conditioned_encoder():
    """`spk_emb_linear` added before the third of three layers; atol 2e-5.
    The projection is absent where the encoder has no third layer."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    x_mask = _mask([9, 6], 9)
    g = rng.standard_normal((2, 1, 8)).astype(np.float32)
    jenc = jattention.Encoder(16, 32, 2, 3, kernel_size=3, gin_channels=8)
    params = _init(jenc, x, x_mask, g)
    want = jenc.apply({"params": params}, x, x_mask, g)
    port = _load(attention.Encoder(16, 32, 2, 3, kernel_size=3,
                                   gin_channels=8), params,
                 lambda m: m.encoder((), "", 3))
    with torch.no_grad():
        got = port(_bct(x), _bct(x_mask), _bct(g))
        unconditioned = port(_bct(x), _bct(x_mask))
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=2e-5)
    assert np.abs(_btc(unconditioned) - np.asarray(want)).max() > 1e-3
    assert not hasattr(attention.Encoder(16, 32, 2, 2, gin_channels=8),
                       "spk_emb_linear")


# ---- the flows ------------------------------------------------------------

@pytest.mark.parametrize("ftype,gin", [
    ("pre_conv", 16), ("pre_conv2", 16), ("fft", 0), ("fft", 16),
    ("mono_layer_inter_residual", 16), ("mono_layer_post_residual", 16)])
def test_flow_stack(ftype, gin):
    """ResidualCouplingBlock of each transformer flow type at the
    synthesizer's arguments (kernel 5, dilation 1, 4 WN layers, 4 flows):
    forward (voice conversion's direction) and reverse, ragged mask, atol
    1e-4."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 24, 32)).astype(np.float32)
    mask = _mask([24, 15], 24)
    g = rng.standard_normal((2, 1, gin)).astype(np.float32) if gin else None
    jflow = jflows.ResidualCouplingBlock(
        32, 32, 5, 1, 4, gin_channels=gin, use_transformer_flows=True,
        transformer_flow_type=ftype)
    params = _init(jflow, z, mask, g, seed=2)
    port = _load(flows.ResidualCouplingBlock(
        32, 32, 5, 1, 4, gin_channels=gin, transformer_flow_type=ftype),
        params, lambda m: m.flow((), "", ftype))
    for reverse in (False, True):
        want = jflow.apply({"params": params}, z, mask, g, reverse=reverse)
        with torch.no_grad():
            got = port(_bct(z), _bct(mask), None if g is None else _bct(g),
                       reverse=reverse)
        np.testing.assert_allclose(_btc(got), np.asarray(want), atol=1e-4,
                                   err_msg=f"reverse={reverse}")


def test_flow_type_is_checked():
    with pytest.raises(ValueError, match="transformer_flow_type"):
        flows.ResidualCouplingBlock(8, 8, 5, 1, 4,
                                    transformer_flow_type="pre_conv3")


# ---- the iSTFT and the Vocos decoder --------------------------------------

@pytest.mark.parametrize("n_fft,hop", [(64, 16), (1024, 256)])
def test_istft(n_fft, hop):
    """At the test and the published geometry, 61 frames (a streamed
    chunk of 60 plus the reflection pad); atol 1e-4."""
    rng = np.random.default_rng(n_fft)
    re, im = (rng.standard_normal((2, 61, n_fft // 2 + 1)).astype(
        np.float32) for _ in range(2))
    want = np.asarray(jax_istft(jnp.asarray(re), jnp.asarray(im), n_fft,
                                hop, n_fft))
    got = spectral.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft,
                         hop, n_fft).numpy()
    assert got.shape == want.shape == (2, 60 * hop)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_window_made_in_inference_mode_serves_training():
    """The iSTFT's cached window, first asked for under inference mode (a
    Vocos decode), still serves a spectrogram that autograd records (the
    training step's mel loss)."""
    with torch.inference_mode():
        spectral.istft(torch.ones(1, 3, 25), torch.ones(1, 3, 25), 48, 12,
                       48)
    y = torch.randn(1, 96, requires_grad=True)
    spectral.spectrogram(y, 48, 12, 48).sum().backward()
    assert y.grad is not None and bool(y.grad.abs().sum() > 0)


def test_vocos_generator():
    """The Vocos decoder with speaker conditioning: T frames -> T * hop
    samples, within 2e-4 * max(1, max|want|); no reduced precision."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 20, 16)).astype(np.float32)
    g = rng.standard_normal((2, 1, 8)).astype(np.float32)
    jvoc = jvocos.VocosGenerator(16, 32, 48, 66, 2, istft_n_fft=64,
                                 istft_hop_length=16, istft_win_length=64,
                                 gin_channels=8)
    params = _init(jvoc, x, g, seed=3)
    want = np.asarray(jvoc.apply({"params": params}, x, g))
    port = _load(vocos.VocosGenerator(16, 32, 48, 66, 2, 64, 16, 64,
                                      gin_channels=8), params,
                 lambda m: m.vocos((), "", 2))
    with torch.no_grad():
        got = _btc(port(_bct(x), _bct(g)))
        with pytest.raises(ValueError, match="f32"):
            port(_bct(x), _bct(g), precision="bf16")
    assert got.shape == want.shape == (2, 320, 1)
    np.testing.assert_allclose(got, want,
                               atol=2e-4 * max(1.0, np.abs(want).max()))


# ---- the synthesizer ------------------------------------------------------

SYNTH_CASES = {
    **{f"vocos_{t}": vits2_cfg(t) for t in FLOW_TYPES},
    **{f"hifigan_{t}": vits2_cfg(t, "hifigan") for t in FLOW_TYPES},
    "vocos_spk_conditioned_encoder": vits2_cfg(
        "pre_conv", use_spk_conditioned_encoder=True, n_layers=3),
}


@pytest.mark.parametrize("case", list(SYNTH_CASES))
def test_infer_matches_jax(case):
    """Synthesizer.infer at scales (0, 1, 0): equal y_lengths, audio within
    2e-4 * max(1, max|want|), for every transformer flow type with each
    decoder, and with the speaker-conditioned text encoder (whose enc_p is
    held at 2e-5 with the speaker's g)."""
    cfg = SYNTH_CASES[case]
    jmodel, params = jax_synthesizer(cfg)
    port = port_synthesizer(cfg, params)
    rng = np.random.default_rng(1)
    x = rng.integers(1, 24, size=(3, 13))
    xl = np.array([13, 9, 4])
    sid = np.array([0, 2, 1])
    max_frames = 96
    want_audio, want_len, _ = jmodel.apply(
        params, jnp.asarray(x), jnp.asarray(xl), jnp.asarray(sid),
        0.0, 1.0, 0.0, max_frames, method=JaxSynthesizer.infer,
        rngs={"noise": KEY})
    with torch.no_grad():
        audio, y_len, _ = port.infer(
            torch.from_numpy(x), torch.from_numpy(xl), torch.from_numpy(sid),
            0.0, 1.0, 0.0, max_frames)
    np.testing.assert_array_equal(y_len.numpy(), np.asarray(want_len))
    want_audio = np.asarray(want_audio)
    assert audio.shape == want_audio.shape == (3, max_frames * 16, 1)
    np.testing.assert_allclose(
        audio.numpy(), want_audio,
        atol=2e-4 * max(1.0, np.abs(want_audio).max()))
    if cfg["model"].get("use_spk_conditioned_encoder"):
        bound = jmodel.bind(params)
        g = bound._speaker(jnp.asarray(sid))
        want = bound.enc_p(jnp.asarray(x), jnp.asarray(xl), g=g)
        with torch.no_grad():
            got = port.enc_p(torch.from_numpy(x), torch.from_numpy(xl),
                             g=_bct(g))
        for a, b in zip(got, want):
            np.testing.assert_allclose(_btc(a), np.asarray(b), atol=2e-5)


@pytest.mark.parametrize("case", ["vocos_pre_conv", "hifigan_fft",
                                  "vocos_mono_layer_post_residual"])
def test_weight_bridge_round_trip(case):
    """port state_dict -> convert_synthesizer gives exactly the JAX tree
    (every transformer flow leaf, Vocos's), and params_from_jax gives back
    the port's tensors; the other flow types and the speaker-conditioned
    encoder load strictly in test_infer_matches_jax."""
    cfg = SYNTH_CASES[case]
    _, params = jax_synthesizer(cfg)
    port = port_synthesizer(cfg, params)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    tree = convert_synthesizer(state, JaxConfig.from_dict(copy.deepcopy(cfg)))
    want = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert set(got) == set(want)
    for p, a in want.items():
        np.testing.assert_array_equal(got[p], a, err_msg=str(p))
    back = params_from_jax(tree, Config.from_dict(copy.deepcopy(cfg)))
    assert set(back) == set(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_published_configs_build():
    """Both published VITS2 recipes build, with the modules they name."""
    for name, dec in (("vits2_vocos_v1", vocos.VocosGenerator),
                      ("vits2_v1", None)):
        cfg = Config.from_json(f"examples/baker/configs/{name}.json")
        model = Synthesizer(cfg)
        assert model.hop == 256
        assert isinstance(model.flow.flows[0],
                          flows.ResidualCouplingTransformersLayer)
        assert dec is None or isinstance(model.dec, dec)


def test_noise_scaled_mas_is_refused_in_training():
    """Noise-scaled MAS was refused here until its port; now the training
    forward of a model built with it gives, at scale 0, the alignment of
    the same weights built without it, and still takes its draw from the
    generator, as the JAX package does (tests/test_torch_vits2_train.py
    holds it against JAX at a scale that moves the alignment)."""
    cfg = vits2_cfg(use_noise_scaled_mas=True)
    model = Synthesizer(Config.from_dict(copy.deepcopy(cfg)))
    plain = Synthesizer(Config.from_dict(vits2_cfg()))
    plain.load_state_dict(model.state_dict())
    x = torch.tensor([[3, 1, 4, 1, 5]])
    y = torch.randn(1, 20, 33, generator=torch.Generator().manual_seed(0))
    feed = (x, torch.tensor([5]), y, torch.tensor([20]), torch.tensor([0]))
    gens = [torch.Generator().manual_seed(1) for _ in range(2)]
    with torch.no_grad():
        got = model(*feed, generator=gens[0], mas_noise_scale=0.0)
        want = plain(*feed, generator=gens[1])
    assert torch.equal(got["attn"], want["attn"])
    assert not torch.equal(gens[0].get_state(), gens[1].get_state())


def _vc_cfg(mel: bool):
    cfg = vits2_cfg("pre_conv")
    if mel:
        cfg["data"].update(use_mel_posterior_encoder=True, n_mel_channels=20)
        cfg["model"]["use_mel_posterior_encoder"] = True
    return cfg


@pytest.mark.parametrize("mel", [False, True], ids=["linear", "mel"])
def test_voice_conversion_matches_jax(mel, monkeypatch):
    """voice_conversion on the JAX package's posterior input for two
    ragged utterances (the linear spectrogram, or the log-mel), with the
    same patterned posterior sample on both sides: z, z_p, z_hat within
    1e-4, audio within 2e-4 * max(1, max|want|), the mask equal."""
    cfg = _vc_cfg(mel)
    jmodel, params = jax_synthesizer(cfg)
    port = port_synthesizer(cfg, params)
    patch_shared_draws(monkeypatch)
    rng = np.random.default_rng(8)
    wav = (rng.standard_normal((2, 40 * 16)) * 0.3).astype(np.float32)
    spec = np.array(jax_compute_spec(
        JaxConfig.from_dict(copy.deepcopy(cfg)), jnp.asarray(wav)))
    assert spec.shape == (2, 40, 20 if mel else 33)
    yl = np.array([40, 31])
    src, tgt = np.array([0, 2]), np.array([1, 0])
    want, want_mask, want_z = jmodel.apply(
        params, jnp.asarray(spec), jnp.asarray(yl), jnp.asarray(src),
        jnp.asarray(tgt), method=JaxSynthesizer.voice_conversion,
        rngs={"noise": KEY})
    with torch.no_grad():
        got, mask, zs = port.voice_conversion(
            *(torch.from_numpy(a) for a in (spec, yl, src, tgt)))
    want = np.asarray(want)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    for g, w in zip(zs, want_z):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert got.shape == want.shape == (2, 40 * 16, 1)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-4 * max(1.0, np.abs(want).max()))


def test_voice_convert_cli(tmp_path):
    """`bin/voice_convert` end to end on a `params.npz` bundle and a 16 kHz
    WAV: resampled to the model's rate, cut to whole hops, converted with
    the seeded posterior sample, peak-scaled to 0.6; equal to the model's
    own voice_conversion within the int16 rounding. Without `--device cpu`
    it raises where there is no GPU."""
    from wetts_tpu.utils.params_io import save_params_npz
    from wetts_tpu_torch.bin import voice_convert
    from wetts_tpu_torch.train.step import compute_spec
    from wetts_tpu_torch.utils.wav import read_wav, resample_poly, write_wav

    cfg = _vc_cfg(False)
    _, params = jax_synthesizer(cfg)
    (tmp_path / "model").mkdir()
    save_params_npz(str(tmp_path / "model" / "params.npz"), params)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    (tmp_path / "phones.txt").write_text("sil 0\na 1\nb 2")
    (tmp_path / "speaker.txt").write_text("spk0 0\nspk1 1\nspk2 2")
    rng = np.random.default_rng(9)
    source = (rng.standard_normal(3200) * 0.2).clip(-1, 1).astype(np.float32)
    write_wav(str(tmp_path / "in.wav"), source, 16000)
    argv = ["--cfg", str(tmp_path / "config.json"),
            "--model_dir", str(tmp_path / "model"),
            "--phone_table", str(tmp_path / "phones.txt"),
            "--speaker_table", str(tmp_path / "speaker.txt"),
            "--wav", str(tmp_path / "in.wav"), "--source_speaker", "spk2",
            "--target_speaker", "spk0", "--out", str(tmp_path / "out.wav")]
    voice_convert.main(argv + ["--device", "cpu"])
    got, rate = read_wav(str(tmp_path / "out.wav"))
    assert rate == 22050

    wav, _ = read_wav(str(tmp_path / "in.wav"))
    wav = resample_poly(wav, 16000, 22050)
    wav = torch.from_numpy(wav[: len(wav) // 16 * 16].copy())[None]
    port = port_synthesizer(cfg, params)
    with torch.no_grad():
        spec = compute_spec(Config.from_dict(copy.deepcopy(cfg)), wav)
        want, _, _ = port.voice_conversion(
            spec, torch.tensor([spec.shape[1]]), torch.tensor([2]),
            torch.tensor([0]), generator=torch.Generator().manual_seed(0))
    want = want[0, :, 0].numpy()
    want = want * 0.6 / max(0.01, float(np.abs(want).max()))
    assert got.shape == want.shape and got.size == wav.shape[1]
    np.testing.assert_allclose(got, want, atol=1.5 / 32767)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            voice_convert.main(argv)


# ---- a Vocos engine -------------------------------------------------------

VOCOS_ENGINE_CFG = copy.deepcopy(ENGINE_CFG)
VOCOS_ENGINE_CFG["model"].update(
    use_transformer_flows=True, transformer_flow_type="pre_conv",
    vocoder_type="vocos", vocos_channels=32, vocos_h_channels=48,
    vocos_out_channels=258, vocos_num_layers=2,
    vocos_istft_config={"n_fft": 256, "hop_length": 64, "win_length": 256,
                        "center": True})


@pytest.fixture(scope="module")
def vocos_engines():
    """A `pre_conv` / Vocos engine pair at tests/test_torch_engine.py's
    size (hop 64 = the iSTFT hop), scales (0, 1, 0), chip_smoke's seeded
    weights carried to the JAX engine."""
    cfg = Config.from_dict(copy.deepcopy(VOCOS_ENGINE_CFG))
    model = random_init_(Synthesizer(cfg), 0).eval()
    jax_cfg = JaxConfig.from_dict(copy.deepcopy(VOCOS_ENGINE_CFG))
    params = convert_synthesizer(
        {k: v.numpy() for k, v in model.state_dict().items()}, jax_cfg)
    jax_engine = JaxEngine(jax_cfg,
                           {"params": jax.tree.map(jnp.asarray, params)},
                           PHONES, SPEAKERS, on_device_bucketing=False,
                           **SCALES)
    return jax_engine, SynthesisEngine(cfg, model, PHONES, SPEAKERS,
                                       device="cpu", **SCALES)


def _close(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(1.0, max(float(np.abs(w).max()) for w in want))
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=2e-4 * scale)


def test_vocos_engine_synthesize_matches_jax(vocos_engines):
    jax_engine, port = vocos_engines
    for text, speaker in (("a b c a b. c b a c", "spk1"), ("c c b", None)):
        got = port.synthesize(text, speaker)
        assert got.size > 0 and got.size % 64 == 0
        _close([got], [jax_engine.synthesize(text, speaker)])


@pytest.mark.parametrize("tail", [True, False])
def test_vocos_engine_streams_match_jax(vocos_engines, tail):
    """Both streaming paths chunk by chunk (block 8, pad 2); the chunks of
    the port sum to the whole synthesis' length."""
    jax_engine, port = vocos_engines
    jax_engine.stream_batch_tail = port.stream_batch_tail = tail
    want = list(jax_engine.stream_synthesize(RAW_TEXT, "spk0", BLOCK, PAD))
    got = list(port.stream_synthesize(RAW_TEXT, "spk0", BLOCK, PAD))
    assert len(got) >= 3
    _close(got, want)
    assert sum(g.size for g in got) == port.synthesize(RAW_TEXT, "spk0").size


def test_vocos_engine_refuses_reduced_precision():
    """`half` and `quantize` run the HiFi-GAN decoder at a reduced
    precision; the Vocos decoder has no such route, so they raise (the JAX
    engine warns and serves f32)."""
    cfg = Config.from_dict(copy.deepcopy(VOCOS_ENGINE_CFG))
    for option in ("half", "quantize"):
        with pytest.raises(ValueError, match="vocoder_type"):
            SynthesisEngine(cfg, Synthesizer(cfg), PHONES, SPEAKERS,
                            device="cpu", **{option: True})


def test_infer_vits_cli_writes_the_config_rate(tmp_path):
    """`bin/infer_vits` takes a VITS2 config as it is and writes its WAVs at
    `cfg.data.sampling_rate` (24 kHz here, as vits2_vocos_v1.json), whole
    hops of audio, peak-scaled to at most 0.6."""
    from wetts_tpu.utils.params_io import save_params_npz
    from wetts_tpu_torch.bin import infer_vits
    from wetts_tpu_torch.utils.wav import read_wav

    cfg = copy.deepcopy(VOCOS_ENGINE_CFG)
    cfg["data"]["sampling_rate"] = 24000
    model = random_init_(Synthesizer(Config.from_dict(copy.deepcopy(cfg))),
                         0)
    (tmp_path / "model").mkdir()
    save_params_npz(str(tmp_path / "model" / "params.npz"), {
        "params": convert_synthesizer(
            {k: v.numpy() for k, v in model.state_dict().items()},
            JaxConfig.from_dict(copy.deepcopy(cfg)))})
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    (tmp_path / "phones.txt").write_text("sil 0\na 1\nb 2\nc 3")
    (tmp_path / "speaker.txt").write_text("spk0 0\nspk1 1")
    (tmp_path / "test.txt").write_text("x/utt1.wav|spk1|a b c a b")
    infer_vits.main([
        "--cfg", str(tmp_path / "config.json"),
        "--model_dir", str(tmp_path / "model"),
        "--phone_table", str(tmp_path / "phones.txt"),
        "--speaker_table", str(tmp_path / "speaker.txt"),
        "--test_file", str(tmp_path / "test.txt"),
        "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    wav, rate = read_wav(str(tmp_path / "out" / "utt1.wav"))
    assert rate == 24000 and wav.size > 0 and wav.size % 64 == 0
    assert 0.0 < np.abs(wav).max() <= 0.6 + 1e-3

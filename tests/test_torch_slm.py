"""The WavLM (SLM) branch of the port against the JAX package, on the CPU:
the polyphase resample, the WavLM encoder (also against `transformers`'
WavLMModel where that package is installed), the SLM feature function and
its gradient, the WavLM discriminator and its weight bridge, `_load_slm`
on a WavLM saved locally, the `use_wd` branch of the `Trainer` and of
`bin/train_vits`, and (`slow`) two updates of a step with the SLM branch
against the JAX step.

Every parameter is random, drawn from numpy seeds. Stated tolerances: the
resample atol 1e-4 against both `wetts_tpu.ops.resample.resample` and
`scipy.signal.resample_poly` (float64), its input gradient rtol 1e-4
(atol 1e-6); WavLM hidden states atol 2e-4; the SLM features atol 2e-4
and their waveform gradient atol 2e-4 * max|grad|; the WavLM
discriminator atol 1e-5; the two-update parity's metrics abs/rel 5e-4 and
parameters atol 1e-5.
"""

import copy
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from test_torch_train import (
    METRICS,
    TINY,
    make_dataset,
    parity_cfg,
    torch_batch,
    jax_batch,
    _tree_compare,
)
from chip_smoke import RecordingSummary
from test_torch_vits2_train import flax_tree
from torch_port_common import (  # noqa: F401 (drop_checkpoints)
    JaxConfig,
    drop_checkpoints,
    jax_discriminator,
    jax_synthesizer,
    patch_shared_draws,
    port_discriminator,
    port_synthesizer,
    train_batch,
)
from wetts_tpu.models import discriminators as jdisc
from wetts_tpu.models import wavlm as jwavlm
from wetts_tpu.ops.resample import resample as jax_resample
from wetts_tpu.utils.convert import convert_wavlm_discriminator
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.discriminators import WavLMDiscriminator
from wetts_tpu_torch.models.wavlm import (
    WavLMConfig,
    WavLMModel,
    make_slm_feature_fn,
)
from wetts_tpu_torch.ops.resample import resample
from wetts_tpu_torch.train.trainer import Trainer
from wetts_tpu_torch.utils.convert import wavlm_discriminator_from_jax

RATE_PAIRS = [(24000, 16000), (22050, 16000), (8000, 16000), (16000, 24000),
              (44100, 16000)]
SLM_METRICS = {"loss/slm_disc", "loss/slm_feat", "loss/slm_gen"}


# ---- resample --------------------------------------------------------------


@pytest.mark.parametrize("orig,target", RATE_PAIRS)
def test_resample_matches_jax_and_scipy(orig, target):
    rng = np.random.default_rng(orig + target)
    for t in (4410, 997):
        x = rng.standard_normal((2, t)).astype(np.float32)
        got = resample(torch.from_numpy(x), orig, target).numpy()
        want = resample_poly(x, target, orig, axis=-1)
        assert got.shape == want.shape == (2, -(-t * target // orig))
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_allclose(
            got, np.asarray(jax_resample(jnp.asarray(x), orig, target)),
            atol=1e-4)


def test_resample_at_equal_rates_returns_the_input():
    x = torch.randn(2, 100)
    assert resample(x, 16000, 16000) is x


@pytest.mark.parametrize("orig,target", [(24000, 16000), (22050, 16000)])
def test_resample_gradient_matches_jax(orig, target):
    """d sum(w * resample(x)) / dx against jax.grad."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1500)).astype(np.float32)
    n_out = -(-1500 * target // orig)
    w = rng.standard_normal((2, n_out)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * jax_resample(
        a, orig, target)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(w) * resample(xt, orig, target)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


# ---- WavLM -----------------------------------------------------------------


def random_wavlm(cfg: WavLMConfig, seed: int) -> WavLMModel:
    """A port WavLM with every tensor drawn from a numpy seed: norms' scales
    1 + N(0, 0.1^2), biases N(0, 0.1^2), the positional conv's g
    U(0.5, 1.5), other tensors N(0, 1 / fan_in)."""
    model = WavLMModel(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            module = model.get_submodule(name.rsplit(".", 1)[0]) if "." in \
                name else model
            if isinstance(module, (torch.nn.LayerNorm, torch.nn.GroupNorm)) \
                    and name.endswith("weight"):
                a = 1.0 + 0.1 * rng.standard_normal(p.shape)
            elif name.endswith("bias"):
                a = 0.1 * rng.standard_normal(p.shape)
            elif name.endswith("weight_g"):
                a = rng.uniform(0.5, 1.5, p.shape)
            else:
                fan_in = max(1, p[0].numel()) if p.ndim > 1 else p.numel()
                a = rng.standard_normal(p.shape) / np.sqrt(fan_in)
            p.copy_(torch.from_numpy(a.astype(np.float32)))
    return model.eval()


def jax_params_of(model: WavLMModel):
    """The port's (HF-named) state_dict through the JAX package's own
    `convert_hf_wavlm`."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()
          if k != "masked_spec_embed"}
    return jwavlm.convert_hf_wavlm(sd, jwavlm.WavLMConfig(
        **model.cfg.__dict__))


@pytest.mark.parametrize("n_pos", [16, 15])
def test_wavlm_hidden_states_match_jax(n_pos):
    """num_conv_pos_embeddings even (one frame trimmed) and odd."""
    cfg = WavLMConfig(**dict(WavLMConfig.tiny().__dict__,
                             num_conv_pos_embeddings=n_pos))
    model = random_wavlm(cfg, seed=n_pos)
    wav = (np.random.default_rng(1).standard_normal((2, 900)) * 0.2
           ).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(wav))
    jmodel = jwavlm.WavLMModel(jwavlm.WavLMConfig(**cfg.__dict__))
    want = jax.jit(jmodel.apply)({"params": jax_params_of(model)},
                                 jnp.asarray(wav))
    assert len(got) == len(want) == cfg.num_layers + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   err_msg=f"hidden state {i}")


def hf_wavlm(cfg: WavLMConfig):
    """transformers' WavLMModel at `cfg`, random (torch's seed 0), eval."""
    pytest.importorskip("transformers")
    from transformers import WavLMConfig as HFConfig
    from transformers.models.wavlm.modeling_wavlm import (
        WavLMModel as HFWavLM,
    )

    hf = HFConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride), conv_bias=cfg.conv_bias,
        num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        num_buckets=cfg.num_buckets, max_bucket_distance=cfg.max_distance,
        feat_extract_norm="group", do_stable_layer_norm=False,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, hidden_act="gelu",
        feat_extract_activation="gelu")
    torch.manual_seed(0)
    model = HFWavLM(hf).eval()
    with torch.no_grad():  # the LayerNorms off the identity too
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    return hf, model


def old_spelling(sd):
    """HF's state_dict with the positional conv's weight norm under the
    names of torch's older `weight_norm` (`weight_g` / `weight_v`), as a
    released `pytorch_model.bin` has them."""
    return {k.replace("parametrizations.weight.original0", "weight_g")
            .replace("parametrizations.weight.original1", "weight_v"): v
            for k, v in sd.items()}


@pytest.mark.parametrize("n_pos", [16, 15])
@pytest.mark.parametrize("spelling", ["parametrizations", "weight_g"])
def test_wavlm_matches_transformers(n_pos, spelling):
    """One `load_state_dict` of HF's own state_dict, in either spelling."""
    cfg = WavLMConfig(**dict(WavLMConfig.tiny().__dict__,
                             num_conv_pos_embeddings=n_pos))
    _, hf = hf_wavlm(cfg)
    sd = hf.state_dict()
    assert any("parametrizations" in k for k in sd)
    if spelling == "weight_g":
        sd = old_spelling(sd)
    model = WavLMModel(cfg)
    model.load_state_dict(sd)
    wav = (np.random.default_rng(2).standard_normal((2, 800)) * 0.2
           ).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(wav), output_hidden_states=True
                  ).hidden_states
        got = model.eval()(torch.from_numpy(wav))
    assert len(got) == len(want) == cfg.num_layers + 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4,
                                   err_msg=f"hidden state {i}")


def test_slm_features_and_their_gradient_match_jax():
    """make_slm_feature_fn at 24 kHz (a resample to 16 kHz first): the
    stacked features, and d sum(w * features) / d wav against jax.grad."""
    cfg = WavLMConfig.tiny()
    model = random_wavlm(cfg, seed=3)
    fn = make_slm_feature_fn(model, model_sr=24000, slm_sr=16000)
    assert not any(p.requires_grad for p in model.parameters())
    jfn = jax.jit(jwavlm.make_slm_feature_fn(
        jwavlm.WavLMConfig(**cfg.__dict__), jax_params_of(model),
        model_sr=24000, slm_sr=16000))
    rng = np.random.default_rng(4)
    wav = (rng.standard_normal((2, 1800, 1)) * 0.3).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(wav)))
    wt = torch.from_numpy(wav).requires_grad_(True)
    got = fn(wt)
    assert got.shape == want.shape
    assert got.shape[-1] == (cfg.num_layers + 1) * cfg.hidden_size
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4)

    w = rng.standard_normal(want.shape).astype(np.float32)
    want_grad = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
        jnp.asarray(w) * jfn(a))))(jnp.asarray(wav)))
    (torch.from_numpy(w) * got).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want_grad,
                               atol=2e-4 * np.abs(want_grad).max())


# ---- the WavLM discriminator ----------------------------------------------


def test_wavlm_discriminator_and_its_bridge_match_jax():
    """The port's logits against the JAX module's on one random tree
    (through `wavlm_discriminator_from_jax`), and back: the port's
    state_dict through the JAX package's `convert_wavlm_discriminator` is
    the same tree."""
    feats = (np.random.default_rng(5).standard_normal((2, 13, 3 * 32))
             ).astype(np.float32)
    jnet = jdisc.WavLMDiscriminator(32, 3, 8)
    tree = flax_tree(jnet, jnp.asarray(feats), seed=6)
    net = WavLMDiscriminator(32, 3, 8)
    net.load_state_dict(wavlm_discriminator_from_jax(tree))
    got = net(torch.from_numpy(feats))
    want = jnet.apply({"params": tree}, jnp.asarray(feats))
    assert got.shape == want.shape == (2, 13)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    back = convert_wavlm_discriminator(
        {k: v.numpy() for k, v in net.state_dict().items()})
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


# ---- the trainer: _load_slm, the use_wd branch -----------------------------


def save_hf_dir(path, model: WavLMModel) -> None:
    """A local HF WavLM directory as a model with a head saves it: every
    tensor under `wavlm.`, the weight norm in the spelling of torch's
    parametrizations, no `masked_spec_embed`, a head tensor to leave out;
    `config.json` with HF's keys."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(model.cfg.to_hf(), f)
    sd = {"wavlm." + k.replace("weight_g", "parametrizations.weight.original0")
          .replace("weight_v", "parametrizations.weight.original1"): v
          for k, v in model.state_dict().items() if k != "masked_spec_embed"}
    sd["projector.weight"] = torch.zeros(4, model.cfg.hidden_size)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))


def wd_config(tmp_path, **train):
    """TINY with `use_wd` at the tiny WavLM's geometry, a WavLM at 16 kHz
    behind a resample from TINY's 8 kHz, written as a config file."""
    cfg = copy.deepcopy(TINY)
    wcfg = WavLMConfig.tiny()
    cfg["model"].update(use_wd=True, slm_hidden=wcfg.hidden_size,
                        slm_nlayers=wcfg.num_layers + 1,
                        slm_initial_channel=8)
    cfg["train"].update(train)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def test_load_slm_reads_a_local_hf_dir_and_trains_the_branch(tmp_path):
    model = random_wavlm(WavLMConfig.tiny(), seed=8)
    slm_dir = str(tmp_path / "wavlm")
    save_hf_dir(slm_dir, model)
    manifest, pt, st = make_dataset(tmp_path, n=2)
    cfg, _ = wd_config(tmp_path)
    trainer = Trainer(Config.from_dict(cfg), str(tmp_path / "exp"), manifest,
                      pt, st, device="cpu", slm_model_dir=slm_dir,
                      summary=RecordingSummary())
    wav = torch.from_numpy((np.random.default_rng(9).standard_normal(
        (2, 1200, 1)) * 0.3).astype(np.float32))
    want = make_slm_feature_fn(model, 8000, 16000)(wav)
    torch.testing.assert_close(trainer.slm_feature_fn(wav), want, rtol=0,
                               atol=0)
    before = {k: v.clone() for k, v in
              trainer.state.net_wd.state_dict().items()}
    assert trainer.train(max_steps=1) == 1
    with open(os.path.join(trainer.model_dir, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert SLM_METRICS <= set(rec) and all(np.isfinite(v)
                                           for v in rec.values())
    moved = [k for k, v in trainer.state.net_wd.state_dict().items()
             if not torch.equal(v, before[k])]
    assert "pre.weight_v" in moved and "conv_post.weight_g" in moved


def test_use_wd_without_an_slm_dir_warns_and_trains_without_it(tmp_path,
                                                               caplog):
    """As the JAX `Trainer`: a warning, no WavLM discriminator, no SLM
    losses."""
    manifest, pt, st = make_dataset(tmp_path, n=2)
    cfg, _ = wd_config(tmp_path)
    with caplog.at_level(logging.WARNING):
        trainer = Trainer(Config.from_dict(cfg), str(tmp_path / "exp"),
                          manifest, pt, st, device="cpu",
                          summary=RecordingSummary())
    assert "no --slm_model dir given" in caplog.text
    assert trainer.state.net_wd is None and trainer.state.opt_wd is None
    assert trainer.train(max_steps=1) == 1
    with open(os.path.join(trainer.model_dir, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert not SLM_METRICS & set(rec) and set(METRICS) <= set(rec)


def test_train_cli_with_slm_model_in_bf16(tmp_path):
    """bin/train_vits --slm_model with `bf16_run`: the branch trains."""
    from wetts_tpu_torch.bin import train_vits

    slm_dir = str(tmp_path / "wavlm")
    save_hf_dir(slm_dir, random_wavlm(WavLMConfig.tiny(), seed=10))
    manifest, pt, st = make_dataset(tmp_path, n=2)
    _, config = wd_config(tmp_path, bf16_run=True)
    model_dir = str(tmp_path / "exp")
    train_vits.main(["-c", config, "-m", model_dir, "--train_data",
                     manifest, "--phone_table", pt, "--speaker_table", st,
                     "--max_steps", "1", "--device", "cpu", "--slm_model",
                     slm_dir])
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert SLM_METRICS <= set(rec) and all(np.isfinite(v)
                                           for v in rec.values())
    payload = torch.load(os.path.join(model_dir, "ckpt_1.pt"),
                         weights_only=True)
    assert {"net_wd", "opt_wd"} <= set(payload)


# ---- two updates with the SLM branch against the JAX step ------------------


@pytest.mark.slow  # the un-jitted JAX steps take minutes, as v1's do
def test_slm_two_step_update_parity(monkeypatch):
    """2 f32 updates of the port with the WavLM discriminator == 2 calls of
    the un-jitted `make_train_step(..., net_wd, slm_feature_fn,
    use_fast_decoder=False)` on the same weights and draws: metrics abs/rel
    5e-4, G, D and WavLM-D parameters atol 1e-5."""
    from wetts_tpu.train.state import GANTrainState as JaxTrainState
    from wetts_tpu.train.state import make_optimizer as jax_make_optimizer
    from wetts_tpu.train.step import make_train_step
    from wetts_tpu.utils.convert import (
        convert_discriminator,
        convert_synthesizer,
    )
    from wetts_tpu_torch.train.state import GANTrainState
    from wetts_tpu_torch.train.step import train_step

    wcfg = WavLMConfig.tiny()
    cfg = parity_cfg()
    cfg["model"].update(use_wd=True, slm_hidden=wcfg.hidden_size,
                        slm_nlayers=wcfg.num_layers + 1,
                        slm_initial_channel=8)
    jcfg = JaxConfig.from_dict(copy.deepcopy(cfg))
    pcfg = Config.from_dict(copy.deepcopy(cfg))
    model, params = jax_synthesizer(parity_cfg())
    net_d, params_d = jax_discriminator()
    wavlm = random_wavlm(wcfg, seed=11)
    slm_sr = 16000
    jfn = jwavlm.make_slm_feature_fn(jwavlm.WavLMConfig(**wcfg.__dict__),
                                     jax_params_of(wavlm), model_sr=8000,
                                     slm_sr=slm_sr)
    jnet_wd = jdisc.WavLMDiscriminator(wcfg.hidden_size, wcfg.num_layers + 1,
                                       8)
    feats = jnp.zeros((2, 7, wcfg.hidden_size * (wcfg.num_layers + 1)))
    params_wd = flax_tree(jnet_wd, feats, seed=12)
    port_wd = WavLMDiscriminator(wcfg.hidden_size, wcfg.num_layers + 1, 8)
    port_wd.load_state_dict(wavlm_discriminator_from_jax(params_wd))
    port_g = port_synthesizer(parity_cfg(), params)
    port_d = port_discriminator(params_d)
    patch_shared_draws(monkeypatch)
    batch = train_batch(parity_cfg())

    tx = jax_make_optimizer(jcfg)
    step_fn = make_train_step(jcfg, model, net_d, None, tx, jnet_wd, jfn,
                              use_fast_decoder=False)
    jstate = JaxTrainState.create(tx, params["params"], params_d["params"],
                                  None, params_wd)
    state = GANTrainState.create(pcfg, port_g, port_d, net_wd=port_wd)
    fn = make_slm_feature_fn(wavlm, 8000, slm_sr)
    rng = jax.random.PRNGKey(0)  # every draw is patched
    for i in range(2):
        jstate, want = step_fn(jstate, jax_batch(batch), rng)
        got = train_step(pcfg, state, torch_batch(batch), slm_feature_fn=fn)
        assert set(got) == set(want) == set(METRICS) | SLM_METRICS
        for key in want:
            assert float(got[key]) == pytest.approx(
                float(want[key]), abs=5e-4, rel=5e-4), f"step {i + 1} {key}"

    def numpy_sd(net):
        return {k: v.detach().numpy() for k, v in net.state_dict().items()}

    _tree_compare(convert_synthesizer(numpy_sd(port_g), jcfg),
                  jstate.params_g, 1e-5, "params_g")
    _tree_compare(convert_discriminator(numpy_sd(port_d)), jstate.params_d,
                  1e-5, "params_d")
    _tree_compare(convert_wavlm_discriminator(numpy_sd(port_wd)),
                  jstate.params_wd, 1e-5, "params_wd")

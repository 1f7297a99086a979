"""VITS2 training of the port against the JAX package, on the CPU in f32:
the multi-resolution and multi-period multi-resolution discriminators, both
duration discriminators (probabilities and gradients), their weight bridges
both ways, the training forward with noise-scaled MAS under shared draws,
the training step of tiny versions of both published VITS2 recipes, the
`Trainer` with its checkpoints, and (`slow`) two updates of a reduced VITS2
step against the JAX step.

Every parameter is random, but in the two-step parity, which starts from
the port's `init_weights_` as training does. The discriminators' flax trees
are drawn from numpy at the shapes `jax.eval_shape` gives for their `init`,
the synthesizer's from `chip_smoke.random_init_` on the port model
(LayerNorms perturbed too) carried to JAX by `convert_synthesizer`: a flax
init of these models takes tens of seconds and is not needed. Stated
tolerances: the waveform discriminators atol 1e-4, the duration
discriminators 1e-5 and their gradients rtol 1e-4 (atol 1e-5), the
forward's alignment and slice exactly equal and its audio within atol
2e-4, the two-step parity's metrics abs/rel 5e-4 and parameters atol 2e-5.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_init_
from test_torch_train import METRICS, make_dataset, torch_batch
from test_torch_vits2 import VOCOS
from torch_port_common import (
    patch_shared_draws,
    small_cfg_dict,
    train_batch,
)
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.models import discriminators as jdisc
from wetts_tpu.train.step import compute_spec as jax_compute_spec
from wetts_tpu.utils.convert import (
    convert_discriminator,
    convert_duration_discriminator,
    convert_synthesizer,
)
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models import discriminators
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.train import checkpoint as ckpt
from wetts_tpu_torch.train.state import GANTrainState
from wetts_tpu_torch.train.step import (
    build_models,
    eval_step,
    init_weights_,
    mas_noise_scale,
    train_step,
)
from wetts_tpu_torch.train.trainer import Trainer
from wetts_tpu_torch.utils.convert import (
    discriminator_from_jax,
    duration_discriminator_from_jax,
)

KEY = jax.random.PRNGKey(0)
FFT_SIZES = (2048, 1024, 512)
DUR_TYPES = {"dur_disc_1": (jdisc.DurationDiscriminatorV1,
                            discriminators.DurationDiscriminatorV1),
             "dur_disc_2": (jdisc.DurationDiscriminatorV2,
                            discriminators.DurationDiscriminatorV2)}
VITS2_METRICS = set(METRICS) | {"loss/dur_disc", "loss/dur_gen",
                                "train/mas_noise_scale"}


def flax_tree(module, *args, seed: int):
    """A random flax param tree of numpy arrays for module.init(*args),
    drawn at the shapes `jax.eval_shape` gives: weight-norm g U(0.5, 1.5),
    plain kernels N(0, 1 / fan_in), LayerNorm scales 1 + N(0, 0.1^2),
    biases N(0, 0.1^2), weight-norm v N(0, 1)."""
    shapes = jax.eval_shape(module.init, KEY, *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "g":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _wave(seed: int, t: int = 2100) -> np.ndarray:
    """[2, T, 1]; T above half the largest FFT (the reflect pad's need)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, 1)) * 0.3).astype(np.float32)


def _assert_maps(got_fmaps, want_fmaps, atol):
    assert len(got_fmaps) == len(want_fmaps)
    for a, w in zip(got_fmaps, want_fmaps):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   atol=atol)


# ---- the waveform discriminators -------------------------------------------


@pytest.fixture(scope="module")
def mpmrd():
    """(JAX MultiPeriodMultiResolutionDiscriminator, its random tree, the
    port's loaded with it)."""
    net = jdisc.MultiPeriodMultiResolutionDiscriminator()
    wav = jax.ShapeDtypeStruct((1, 256, 1), jnp.float32)
    tree = flax_tree(net, wav, wav, seed=3)
    port = discriminators.MultiPeriodMultiResolutionDiscriminator()
    port.load_state_dict(discriminator_from_jax(tree, use_mrd=True))
    return net, tree, port


@pytest.mark.parametrize("idx,n_fft", list(enumerate(FFT_SIZES)))
def test_resolution_discriminator(mpmrd, idx, n_fft):
    """DiscriminatorR at each FFT size: the logits and all 21 feature maps
    (4 per band, conv_post's) within atol 1e-4."""
    _, tree, port = mpmrd
    net = jdisc.DiscriminatorR(n_fft)
    y = _wave(idx)
    want_logits, want_fmaps = jax.jit(net.apply)(
        {"params": tree[f"disc_r_{n_fft}"]}, jnp.asarray(y))
    with torch.no_grad():
        logits, fmaps = port.discriminators[idx](torch.from_numpy(y))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4)
    assert len(fmaps) == 21
    _assert_maps(fmaps, want_fmaps, 1e-4)


def test_multi_period_multi_resolution_discriminator(mpmrd):
    """R(2048, 1024, 512) then P(2, 3, 5, 7, 11) on a real and a generated
    waveform: every logit and feature map within atol 1e-4."""
    net, tree, port = mpmrd
    y, y_hat = _wave(10), _wave(11)
    want = jax.jit(net.apply)({"params": tree}, jnp.asarray(y),
                              jnp.asarray(y_hat))
    with torch.no_grad():
        got = port(torch.from_numpy(y), torch.from_numpy(y_hat))
    for i in (0, 1):
        assert len(got[i]) == 8
        _assert_maps(got[i], want[i], 1e-4)
    for i in (2, 3):
        for fa, fw in zip(got[i], want[i]):
            _assert_maps(fa, fw, 1e-4)


# ---- the duration discriminators -------------------------------------------


@pytest.fixture(scope="module", params=list(DUR_TYPES))
def dur_pair(request):
    """(type, JAX module, its random tree, the port's loaded with it, the
    inputs: hidden [2, 7, 16], a ragged mask, two log-durations)."""
    jcls, pcls = DUR_TYPES[request.param]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    mask = np.ones((2, 7, 1), np.float32)
    mask[1, 5:] = 0.0
    dur_r, dur_hat = (rng.standard_normal((2, 7, 1)).astype(np.float32)
                      for _ in range(2))
    net = jcls(16, 16, 3, 0.1, gin_channels=8)
    tree = flax_tree(net, x, mask, dur_r, dur_hat, seed=5)
    port = pcls(16, 16, 3, 0.1, gin_channels=8)
    port.load_state_dict(duration_discriminator_from_jax(tree,
                                                         request.param))
    return request.param, net, tree, port, (x, mask, dur_r, dur_hat)


def test_duration_discriminator(dur_pair):
    """Both probabilities within atol 1e-5; d loss / d parameters and
    d loss / d dur_hat against jax.grad within rtol 1e-4 (atol 1e-5 for
    entries near zero, as tests/test_torch_train_modules.py holds the
    weight-norm gradients), for loss = sum of the probabilities times fixed
    random weights; the hidden states take no gradient."""
    dtype, net, tree, port, inputs = dur_pair
    rng = np.random.default_rng(6)
    c = [rng.standard_normal((2, 7, 1)).astype(np.float32) for _ in range(2)]

    def jloss(params, dur_hat):
        x, mask, dur_r, _ = inputs
        probs = net.apply({"params": params}, x, mask, dur_r, dur_hat)
        return sum(jnp.sum(p * w) for p, w in zip(probs, c)), probs

    (_, want), (want_g, want_dhat) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(tree, jnp.asarray(inputs[3]))
    x, mask, dur_r, dur_hat = (torch.tensor(a) for a in inputs)
    x.requires_grad_(True)
    dur_hat.requires_grad_(True)
    port.zero_grad()
    got = port(x, mask, dur_r, dur_hat)
    sum((p * torch.from_numpy(w)).sum() for p, w in zip(got, c)).backward()
    for p, w in zip(got, want):
        assert p.shape == (2, 7, 1)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    assert x.grad is None
    np.testing.assert_allclose(dur_hat.grad.numpy(), np.asarray(want_dhat),
                               rtol=1e-4, atol=1e-5)
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()
             if p.grad is not None}
    unused = {k for k, p in port.named_parameters() if p.grad is None}
    assert unused == ({"pre_out_norm_1.gamma", "pre_out_norm_1.beta",
                       "pre_out_norm_2.gamma", "pre_out_norm_2.beta"}
                      if dtype == "dur_disc_1" else set())
    got_g = convert_duration_discriminator(grads, dtype)
    want_flat = jax.tree_util.tree_leaves_with_path(want_g)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got_g))
    assert len(got_flat) == len(want_flat)
    for path, w in want_flat:
        np.testing.assert_allclose(got_flat[path], np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


# ---- the weight bridges ----------------------------------------------------


def _round_trip(tree, port, to_jax, from_jax):
    """port state_dict -> the JAX package's converter -> exactly `tree`, and
    `from_jax(tree)` -> exactly the port's tensors."""
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax(state)))
    want = jax.tree_util.tree_leaves_with_path(tree)
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    back = from_jax(tree)
    assert set(back) == set(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_mpmrd_bridge_round_trip(mpmrd):
    """Both ways exactly, under the reference's names
    (`discriminators.{i}.band_convs.{b}.{j}`); a stray leaf is refused."""
    _, tree, port = mpmrd
    assert "discriminators.2.band_convs.4.4.weight_v" in port.state_dict()
    _round_trip(tree, port,
                lambda sd: convert_discriminator(sd, use_mrd=True),
                lambda t: discriminator_from_jax(t, use_mrd=True))
    stray = copy.deepcopy(tree)
    stray["disc_r_512"]["stray"] = {"kernel": np.zeros((1, 2), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        discriminator_from_jax(stray, use_mrd=True)


def test_duration_discriminator_bridge_round_trip(dur_pair):
    """Both ways exactly; V1 keeps the reference's unused `pre_out_norm_*`
    (at the identity from JAX, dropped on the way back)."""
    dtype, _, tree, port, _ = dur_pair
    assert "output_layer.0.weight" in port.state_dict()
    assert "pre_out_norm_2.gamma" in port.state_dict()
    _round_trip(tree, port,
                lambda sd: convert_duration_discriminator(sd, dtype),
                lambda t: duration_discriminator_from_jax(t, dtype))


# ---- the training forward with noise-scaled MAS ----------------------------


def forward_cfg():
    """small_cfg as a VITS2 training config: the mel posterior encoder,
    `pre_conv` transformer flows, the Vocos decoder, noise-scaled MAS;
    dropout off."""
    cfg = small_cfg_dict(p_dropout=0.0, use_transformer_flows=True,
                         transformer_flow_type="pre_conv",
                         use_noise_scaled_mas=True,
                         use_mel_posterior_encoder=True, **VOCOS)
    cfg["data"].update(use_mel_posterior_encoder=True, n_mel_channels=20)
    return cfg


def randomized_port(cfg_dict, seed: int) -> Synthesizer:
    """The port model with every parameter random: `random_init_`, then
    each LayerNorm's gamma and beta perturbed."""
    model = random_init_(Synthesizer(Config.from_dict(copy.deepcopy(
        cfg_dict))), seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".gamma", ".beta")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def test_noise_scaled_forward_matches_jax(monkeypatch):
    """Synthesizer.forward at a noise scale that changes the alignment,
    with shared draws: `attn` and `ids_slice` exactly equal, the audio
    within atol 2e-4, the duration discriminator's inputs within 1e-4."""
    from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer

    cfg = forward_cfg()
    jcfg = JaxConfig.from_dict(copy.deepcopy(cfg))
    port = randomized_port(cfg, seed=7).train()
    params = convert_synthesizer(
        {k: v.detach().numpy() for k, v in port.state_dict().items()}, jcfg)
    model = JaxSynthesizer.from_config(jcfg)
    patch_shared_draws(monkeypatch)
    x, xl, wav, yl, sid = train_batch(cfg)
    spec = np.array(jax_compute_spec(jcfg, jnp.asarray(wav)))
    scale = 2.0
    want = jax.jit(model.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(xl),
        jnp.asarray(spec), jnp.asarray(yl), jnp.asarray(sid), scale,
        rngs={"noise": KEY, "dropout": KEY, "slice": KEY})
    feed = [torch.from_numpy(a) for a in (x, xl, spec, yl, sid)]
    with torch.no_grad():
        got = port(*feed, mas_noise_scale=scale)
        plain = port(*feed, mas_noise_scale=0.0)
    assert not torch.equal(got["attn"], plain["attn"])  # the noise acts
    assert set(got) == set(want)
    got = {k: v.detach().numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["attn"], np.asarray(want["attn"]))
    np.testing.assert_array_equal(got["ids_slice"],
                                  np.asarray(want["ids_slice"]))
    assert got["attn"].sum() == yl.sum()
    np.testing.assert_allclose(got["audio"], np.asarray(want["audio"]),
                               atol=2e-4)
    for key in ("l_length", "x_hidden", "logw", "logw_", "x_mask"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)


# ---- the training step against the JAX step --------------------------------


def parity_vits2_cfg():
    """forward_cfg with the multi-period multi-resolution discriminator on
    segments of 1280 samples, the V1 duration discriminator, the MAS noise
    at 2.0 falling by 0.5 a step, tests/test_torch_train.py:parity_cfg's
    large Adam eps, and lr 2e-3: at the default 2e-4 the duration
    discriminator's first update moves `loss/dur_gen` by less than the
    metrics' tolerance, so a generator term scored before that update
    would pass."""
    cfg = forward_cfg()
    cfg["train"].update(segment_size=1280, eps=1e-2, learning_rate=2e-3)
    cfg["model"].update(use_mrd_disc=True, use_duration_discriminator=True,
                        duration_discriminator_type="dur_disc_1",
                        mas_noise_scale_initial=2.0, noise_scale_delta=0.5)
    return cfg


@pytest.mark.slow  # the JAX step's jit takes minutes, as v1's steps do
def test_vits2_two_step_update_parity(monkeypatch):
    """2 updates of the port's VITS2 step == 2 calls of the jitted JAX
    `make_train_step(cfg, model, net_d, net_dur_d, tx)` under shared draws:
    the MAS noise scale taken at the step count before each update, D's
    update, then the duration discriminator's, then G's against both
    updated discriminators, `loss/dur_gen` included. Per-step metrics
    within abs/rel 5e-4, the updated G, MPMRD and duration-D parameters
    within atol 2e-5 through the JAX package's own converters, as
    tests/test_torch_train.py:test_two_step_update_parity holds v1. The
    weights are the port's `init_weights_` (the reference's distributions),
    carried to JAX."""
    from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer
    from wetts_tpu.train.state import GANTrainState as JaxTrainState
    from wetts_tpu.train.state import make_optimizer as jax_make_optimizer
    from wetts_tpu.train.step import make_train_step
    from test_torch_train import _tree_compare, jax_batch

    cfg = parity_vits2_cfg()
    jcfg = JaxConfig.from_dict(copy.deepcopy(cfg))
    pcfg = Config.from_dict(copy.deepcopy(cfg))
    nets = build_models(pcfg)[:3]  # no WavLM discriminator
    init_weights_(nets[0], nets[1], torch.Generator().manual_seed(0),
                  nets[2])
    assert type(nets[1]) is (
        discriminators.MultiPeriodMultiResolutionDiscriminator)

    def state_of(net):
        return {k: v.detach().numpy().copy()
                for k, v in net.state_dict().items()}

    def to_jax(net_g, net_d, net_dur_d):
        return (convert_synthesizer(state_of(net_g), jcfg),
                convert_discriminator(state_of(net_d), use_mrd=True),
                convert_duration_discriminator(state_of(net_dur_d),
                                               "dur_disc_1"))

    params = to_jax(*nets)
    model = JaxSynthesizer.from_config(jcfg)
    net_d = jdisc.MultiPeriodMultiResolutionDiscriminator()
    net_dur_d = jdisc.DurationDiscriminatorV1(32, 32, 3, 0.1,
                                              gin_channels=16)
    patch_shared_draws(monkeypatch)
    rng = np.random.default_rng(3)
    hop = cfg["data"]["hop_length"]
    batch = (rng.integers(1, cfg["num_phones"], size=(2, 9)),
             np.array([9, 7]),
             (rng.standard_normal((2, 96 * hop)) * 0.3).astype(np.float32),
             np.array([96, 88]), np.array([0, 1]))

    feed = torch_batch(batch)
    spec = torch.from_numpy(np.array(jax_compute_spec(
        jcfg, jnp.asarray(batch[2]))))
    with torch.no_grad():
        attn = [nets[0].train()(
            feed["phone_ids"], feed["text_lengths"], spec,
            feed["spec_lengths"], feed["sid"], mas_noise_scale=s)["attn"]
            for s in (0.0, 2.0)]
    assert not torch.equal(*attn)  # the noise moves the first alignment

    tx = jax_make_optimizer(jcfg)
    step_fn = jax.jit(make_train_step(jcfg, model, net_d, net_dur_d, tx))
    jstate = JaxTrainState.create(tx, *params)
    state = GANTrainState.create(pcfg, *nets)
    key = jax.random.PRNGKey(0)  # every draw is patched
    for i in range(2):
        jstate, want = step_fn(jstate, jax_batch(batch), key)
        got = train_step(pcfg, state, torch_batch(batch))
        assert set(got) == set(want) == VITS2_METRICS
        assert float(got["train/mas_noise_scale"]) == 2.0 - 0.5 * i
        for k in sorted(VITS2_METRICS):
            assert float(got[k]) == pytest.approx(
                float(want[k]), abs=5e-4, rel=5e-4), f"step {i + 1} {k}"
    assert state.step == 2

    got_g, got_d, got_dur = to_jax(state.net_g, state.net_d,
                                   state.net_dur_d)
    _tree_compare(got_g, jstate.params_g, 2e-5, "params_g")
    _tree_compare(got_d, jstate.params_d, 2e-5, "params_d")
    _tree_compare(got_dur, jstate.params_dur_d, 2e-5, "params_dur_d")


# ---- the training step -----------------------------------------------------


def published_tiny(name: str) -> dict:
    """A published VITS2 recipe as it stands, sizes shrunk and every flag
    untouched (tests/test_train_vits2.py:vits2_tiny_cfg): 8 kHz, hop 32,
    segments of 1280 samples (above half the resolution discriminator's
    largest FFT)."""
    with open(os.path.join("examples", "baker", "configs",
                           f"{name}.json")) as f:
        d = json.load(f)
    d["train"].update(segment_size=1280, batch_size=2, log_interval=1,
                      eval_interval=1000)
    d["data"].update(filter_length=128, hop_length=32, win_length=128,
                     sampling_rate=8000, n_mel_channels=20)
    d["model"].update(
        inter_channels=16, hidden_channels=16, filter_channels=32,
        n_layers=1, upsample_rates=[8, 4], upsample_kernel_sizes=[16, 8],
        upsample_initial_channel=32, resblock_kernel_sizes=[3],
        resblock_dilation_sizes=[[1, 3]], gin_channels=8)
    if d["model"].get("vocoder_type") == "vocos":
        d["model"].update(
            vocos_channels=16, vocos_h_channels=32, vocos_out_channels=130,
            vocos_num_layers=2,
            vocos_istft_config={"n_fft": 128, "hop_length": 32,
                                "win_length": 128, "center": True})
    d["num_phones"], d["num_speakers"] = 24, 3
    return d


def step_batch(cfg_dict):
    """train_batch's layout at 48 and 44 frames of hop 32."""
    rng = np.random.default_rng(3)
    hop = cfg_dict["data"]["hop_length"]
    x = rng.integers(1, cfg_dict["num_phones"], size=(2, 9))
    wav = (rng.standard_normal((2, 48 * hop)) * 0.3).astype(np.float32)
    return torch_batch((x, np.array([9, 7]), wav, np.array([48, 44]),
                        np.array([0, 1])))


@pytest.fixture(scope="module", params=["vits2_vocos_v1", "vits2_v1"])
def trained_vits2(request):
    """(name, cfg, state after one step from seeded weights, metrics, every
    parameter before the step, per network)."""
    cfg = Config.from_dict(published_tiny(request.param))
    net_g, net_d, net_dur_d, _ = build_models(cfg)
    init_weights_(net_g, net_d, torch.Generator().manual_seed(0), net_dur_d)
    nets = {"G": net_g, "D": net_d, "DUR": net_dur_d}
    before = {k: {n: p.detach().clone() for n, p in net.named_parameters()}
              for k, net in nets.items()}
    state = GANTrainState.create(cfg, net_g, net_d, net_dur_d)
    metrics = train_step(cfg, state, step_batch(published_tiny(request.param)),
                         torch.Generator().manual_seed(0))
    return request.param, cfg, state, metrics, before


def test_vits2_step_metrics_and_modules(trained_vits2):
    """The step's metrics are finite and named as the JAX step's, with the
    duration discriminator's losses and the MAS noise scale at step 0; the
    recipe's modules are built."""
    name, cfg, state, metrics, _ = trained_vits2
    assert set(metrics) == VITS2_METRICS and state.step == 1
    for k, v in metrics.items():
        assert v.ndim == 0 and torch.isfinite(v), k
    assert float(metrics["train/mas_noise_scale"]) == pytest.approx(
        cfg.model.mas_noise_scale_initial)
    want_d = (discriminators.MultiPeriodMultiResolutionDiscriminator
              if name == "vits2_vocos_v1"
              else discriminators.MultiPeriodDiscriminator)
    assert type(state.net_d) is want_d
    assert type(state.net_dur_d) is discriminators.DurationDiscriminatorV1


def test_vits2_step_moves_every_discriminator_parameter(trained_vits2):
    """Every parameter of D (MPMRD or MPD) and of the duration
    discriminator moves, but V1's `pre_out_norm_*`, which its forward never
    reads; in G, the SDP's flows (which the duration term reaches through
    logw), the flow and the decoder move."""
    name, _, state, _, before = trained_vits2
    nets = {"G": state.net_g, "D": state.net_d, "DUR": state.net_dur_d}
    for k in ("D", "DUR"):
        for n, p in nets[k].named_parameters():
            moved = not torch.equal(p.detach(), before[k][n])
            assert moved != n.startswith("pre_out_norm_"), (k, n)
    after = dict(state.net_g.named_parameters())
    dec = ("dec.layers.0.pw_conv1.weight" if name == "vits2_vocos_v1"
           else "dec.ups.0.weight_v")
    for n in ("dp.flows.1.proj.weight", "dp.post_flows.1.proj.weight",
              "flow.flows.0.pre_transformer.attn_layers.0.conv_q.weight",
              "enc_q.enc.in_layers.0.weight_v", dec):
        assert not torch.equal(after[n].detach(), before["G"][n]), n


def test_mas_noise_scale_schedule():
    """max(initial - delta * step, 0) of the step count before the update,
    as the step logs it; 0 without `use_noise_scaled_mas`."""
    cfg = Config.from_dict(published_tiny("vits2_vocos_v1"))
    m = cfg.model
    m.mas_noise_scale_initial, m.noise_scale_delta = 0.01, 0.004
    assert [mas_noise_scale(cfg, s) for s in (0, 1, 2, 3, 10)] == [
        max(0.01 - 0.004 * s, 0.0) for s in (0, 1, 2, 3, 10)]
    assert mas_noise_scale(cfg, 3) == 0.0
    net_g, net_d, net_dur_d, _ = build_models(cfg)
    state = GANTrainState.create(cfg, net_g, net_d, net_dur_d)
    state.step = 2
    metrics = train_step(cfg, state,
                         step_batch(published_tiny("vits2_vocos_v1")),
                         torch.Generator().manual_seed(1))
    assert float(metrics["train/mas_noise_scale"]) == pytest.approx(0.002)
    m.use_noise_scaled_mas = False
    assert mas_noise_scale(cfg, 0) == 0.0


def test_vits2_eval_step_draws_at_scale_zero(trained_vits2):
    """eval_step passes scale 0: its alignment is that of the plain MAS."""
    name, cfg, state, _, _ = trained_vits2
    batch = step_batch(published_tiny(name))
    seen = []
    handle = state.net_g.register_forward_hook(
        lambda module, args, kwargs, out: seen.append(
            kwargs["mas_noise_scale"]), with_kwargs=True)
    try:
        metrics = eval_step(cfg, state.net_g, batch,
                            torch.Generator().manual_seed(0))
    finally:
        handle.remove()
        state.net_g.train()
    assert seen == [0.0]
    assert all(torch.isfinite(v) for v in metrics.values())


# ---- Trainer ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["vits2_vocos_v1", "vits2_v1"])
def test_vits2_trainer_two_steps_resume_and_eval(tmp_path, name):
    """Two steps, a save, a resume that restores the duration
    discriminator and its optimiser exactly, a third step, an evaluation."""
    manifest, pt, st = make_dataset(tmp_path, n=4, hop=32)
    cfg_dict = published_tiny(name)
    model_dir = str(tmp_path / "exp")

    def trainer():
        return Trainer(Config.from_dict(copy.deepcopy(cfg_dict)), model_dir,
                       manifest, pt, st, val_manifest=manifest, device="cpu")

    first = trainer()
    assert first.train(max_steps=2) == 2
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(VITS2_METRICS <= set(r) for r in records)
    assert all(np.isfinite(r[k]) for r in records for k in VITS2_METRICS)
    assert records[1]["train/mas_noise_scale"] < records[0][
        "train/mas_noise_scale"]

    second = trainer()
    assert second.start_step == 2
    for a, b in ((first.state.net_dur_d, second.state.net_dur_d),
                 (first.state.net_d, second.state.net_d)):
        for (k, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(x, y), k
    want, got = (t.state.opt_dur_d.state_dict() for t in (first, second))
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(got["state"][i][k])), (i, k)
    assert int(got["state"][0]["step"]) == 2
    assert second.train(max_steps=3) == 3
    assert ckpt.saved_steps(model_dir) == [2, 3]
    second.evaluate(step=3, epoch=1, max_batches=1)
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    assert {"val/mel_l1", "val/kl", "val/dur"} <= set(last)
    assert all(np.isfinite(last[k]) for k in last)

"""The training slice's modules of the port, each against its `wetts_tpu`
counterpart on the CPU in f32: the same numpy-seeded inputs and parameters
(every parameter random) go through both. Also the two gradient repairs:
weight norm that is differentiable and refolds on `eval()`, and a decoder
whose gradient reaches through the MRF stages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    jax_discriminator,
    jax_synthesizer,
    patch_shared_draws,
    port_discriminator,
    port_synthesizer,
    randomize,
    sdp_pattern,
    small_cfg_dict,
)
from wetts_tpu.models import layers as jlayers
from wetts_tpu.ops import masking as jmasking
from wetts_tpu.ops import spectral as jspectral
from wetts_tpu.train import losses as jlosses
from wetts_tpu.utils.convert import convert_discriminator
from wetts_tpu_torch.models import layers
from wetts_tpu_torch.ops import masking, random, spectral
from wetts_tpu_torch.train import losses
from wetts_tpu_torch.utils.convert import discriminator_from_jax


def _bct(a):
    """numpy [B, T, C] -> torch [B, C, T]."""
    return torch.from_numpy(np.swapaxes(np.array(a), 1, 2).copy())


def _btc(t):
    return np.swapaxes(t.detach().numpy(), 1, 2)


@pytest.fixture(scope="module")
def pair():
    """(bound JAX model, port model) with identical random weights."""
    cfg = small_cfg_dict()
    model, params = jax_synthesizer(cfg)
    return model.bind(params, rngs={"noise": jax.random.PRNGKey(0)}), \
        port_synthesizer(cfg, params)


# ---- ops ------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,win", [(64, 16, 64), (128, 32, 96)])
def test_spectrogram(n_fft, hop, win):
    """torch.stft with the reference's reflect pad against the JAX package's
    framed DFT; atol 1e-4 on magnitudes of O(10)."""
    wav = np.random.default_rng(0).standard_normal((2, hop * 20)).astype(
        np.float32)
    want = jspectral.spectrogram(jnp.asarray(wav), n_fft, hop, win)
    got = spectral.spectrogram(torch.from_numpy(wav), n_fft, hop, win)
    assert got.shape == (2, 20, n_fft // 2 + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_mel_spectrogram_and_spec_to_mel():
    """Log-mel from the waveform and from the linear spectrogram; atol 1e-4
    on log-mel."""
    wav = (np.random.default_rng(1).standard_normal((2, 16 * 30)) * 0.3
           ).astype(np.float32)
    args = (64, 20, 22050, 16, 64, 0.0, None)
    want = jspectral.mel_spectrogram(jnp.asarray(wav), *args)
    got = spectral.mel_spectrogram(torch.from_numpy(wav), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    spec = np.array(jspectral.spectrogram(jnp.asarray(wav), 64, 16, 64))
    want = jspectral.spec_to_mel(jnp.asarray(spec), 64, 20, 22050, 0.0, 8000.0)
    got = spectral.spec_to_mel(torch.from_numpy(spec), 64, 20, 22050, 0.0,
                               8000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_mel_filterbank_and_window_are_the_jax_packages():
    np.testing.assert_array_equal(spectral.hann_window(64),
                                  jspectral.hann_window(64))
    np.testing.assert_array_equal(
        spectral.mel_filterbank(22050, 1024, 80, 0.0, None),
        jspectral.mel_filterbank(22050, 1024, 80, 0.0, None))


def test_slice_segments():
    x = np.random.default_rng(2).standard_normal((3, 20, 4)).astype(np.float32)
    ids = np.array([0, 7, 12])
    want = jmasking.slice_segments(jnp.asarray(x), jnp.asarray(ids), 8)
    got = masking.slice_segments(torch.from_numpy(x), torch.from_numpy(ids), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rand_slice_segments(monkeypatch):
    """Same uniform draws on both sides: the same float-to-int rule gives
    the same offsets, clamped at 0 for utterances shorter than a segment."""
    patch_shared_draws(monkeypatch)
    x = np.random.default_rng(3).standard_normal((4, 30, 2)).astype(np.float32)
    lengths = np.array([30, 17, 8, 5])
    want, want_ids = jmasking.rand_slice_segments(
        jnp.asarray(x), jnp.asarray(lengths), 8, jax.random.PRNGKey(0))
    got, got_ids = masking.rand_slice_segments(
        torch.from_numpy(x), torch.from_numpy(lengths), 8)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_ids.tolist()[2:] == [0, 0] and got_ids[0] > 0


def test_rand_slice_segments_stays_in_range():
    gen = torch.Generator().manual_seed(0)
    lengths = torch.tensor([30, 9, 8, 3])
    for _ in range(20):
        _, ids = masking.rand_slice_segments(torch.zeros(4, 30, 1), lengths,
                                             8, gen)
        assert (ids >= 0).all() and (ids <= (lengths - 8).clamp(min=0)).all()


# ---- modules --------------------------------------------------------------


def test_posterior_encoder(pair, monkeypatch):
    """pre, WN 5x1x16 with speaker conditioning, proj and the sample
    z = (m + eps * exp(logs)) * mask with shared eps; atol 2e-5."""
    bound, port = pair
    patch_shared_draws(monkeypatch)
    rng = np.random.default_rng(4)
    y = np.abs(rng.standard_normal((2, 20, 33))).astype(np.float32)
    yl = np.array([20, 14])
    g = bound._speaker(jnp.asarray([1, 2]))
    want = bound.enc_q(jnp.asarray(y), jnp.asarray(yl), g=g)
    with torch.no_grad():
        got = port.enc_q(_bct(y), torch.from_numpy(yl), g=_bct(np.asarray(g)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(_btc(a), np.asarray(w), atol=2e-5)


def test_sdp_forward_nll(pair, monkeypatch):
    """The stochastic duration predictor's training direction: posterior
    flows, the Log flow, every log-det (the spline's too), nll + logq per
    utterance; rtol 1e-4."""
    bound, port = pair
    patch_shared_draws(monkeypatch)
    rng = np.random.default_rng(5)
    x = rng.integers(1, 24, size=(2, 11))
    xl = np.array([11, 7])
    x_h, _, _, x_mask = bound.enc_p(jnp.asarray(x), jnp.asarray(xl))
    w = (rng.integers(1, 6, size=(2, 11, 1)) * np.asarray(x_mask)).astype(
        np.float32)
    g = bound._speaker(jnp.asarray([0, 2]))
    want = bound.dp(x_h, x_mask, jnp.asarray(w), g=g)
    with torch.no_grad():
        got = port.dp.nll(_bct(np.asarray(x_h)), _bct(np.asarray(x_mask)),
                          _bct(w), g=_bct(np.asarray(g)))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_sdp_stops_gradients_into_its_inputs(pair):
    _, port = pair
    x_h = torch.randn(2, 32, 6, requires_grad=True)
    g = torch.randn(2, 16, 1, requires_grad=True)
    mask = torch.ones(2, 1, 6)
    port.dp.nll(x_h, mask, torch.ones(2, 1, 6), g=g).sum().backward()
    assert x_h.grad is None and g.grad is None
    assert port.dp.pre.weight.grad is not None


def test_flow_forward_is_differentiable(pair):
    _, port = pair
    z = torch.randn(2, 32, 10, requires_grad=True)
    mask = torch.ones(2, 1, 10)
    port.zero_grad()
    port.flow(z, mask, g=torch.randn(2, 16, 1)).sum().backward()
    assert z.grad is not None and torch.isfinite(z.grad).all()
    wn = port.flow.flows[0].enc.in_layers[0]
    assert wn.weight_g.grad is not None and wn.weight_v.grad is not None


@pytest.fixture(scope="module")
def disc_pair():
    net_d, params = jax_discriminator()
    return net_d, params, port_discriminator(params)


def test_multi_period_discriminator(disc_pair):
    """1 scale + 5 period discriminators (a length that needs the reflect
    pad for every period): logits and every feature map; atol 1e-4."""
    net_d, params, port = disc_pair
    rng = np.random.default_rng(6)
    y = (rng.standard_normal((2, 301, 1)) * 0.5).astype(np.float32)
    y_hat = (rng.standard_normal((2, 301, 1)) * 0.5).astype(np.float32)
    want = net_d.apply(params, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = port(torch.from_numpy(y), torch.from_numpy(y_hat))
    for i in (0, 1):  # real and generated logits
        assert len(got[i]) == 6
        for a, w in zip(got[i], want[i]):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4)
    for i in (2, 3):  # feature maps
        for fa, fw in zip(got[i], want[i]):
            assert len(fa) == len(fw)
            for a, w in zip(fa, fw):
                np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                           atol=1e-4)


def test_discriminator_bridge_round_trip(disc_pair):
    """port state_dict -> convert_discriminator (the JAX package's own)
    gives back the JAX tree exactly; a stray leaf is refused."""
    _, params, port = disc_pair
    back = convert_discriminator(
        {k: v.numpy() for k, v in port.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
    tree = copy.deepcopy(params["params"])
    tree["disc_s"]["stray"] = {"kernel": np.zeros((1, 2, 3), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        discriminator_from_jax(tree)


# ---- losses ---------------------------------------------------------------


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def test_feature_loss():
    (jr, tr), (jg, tg) = (_both(_arrays(s, [(2, 9, 4), (2, 5, 3, 8)]))
                          for s in (0, 1))
    want = jlosses.feature_loss([jr, jr[:1]], [jg, jg[:1]])
    got = losses.feature_loss([tr, tr[:1]], [tg, tg[:1]])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_discriminator_loss():
    (jr, tr), (jg, tg) = (_both(_arrays(s, [(2, 30), (2, 17)]))
                          for s in (2, 3))
    want, want_r, want_g = jlosses.discriminator_loss(jr, jg)
    got, got_r, got_g = losses.discriminator_loss(tr, tg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose([float(v) for v in got_r + got_g],
                               [float(v) for v in want_r + want_g], rtol=1e-5)


def test_generator_loss():
    jg, tg = _both(_arrays(4, [(2, 30), (2, 17)]))
    want, _ = jlosses.generator_loss(jg)
    got, parts = losses.generator_loss(tg)
    assert len(parts) == 2
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_kl_loss():
    arrays = _arrays(5, [(2, 12, 6)] * 4)
    mask = np.ones((2, 12, 1), np.float32)
    mask[1, 8:] = 0
    jargs, targs = _both(arrays + [mask])
    np.testing.assert_allclose(float(losses.kl_loss(*targs)),
                               float(jlosses.kl_loss(*jargs)), rtol=1e-5)


def test_feature_loss_detaches_the_real_maps():
    real = torch.randn(2, 5, requires_grad=True)
    fake = torch.randn(2, 5, requires_grad=True)
    losses.feature_loss([[real]], [[fake]]).backward()
    assert real.grad is None and fake.grad is not None


# ---- the weight-norm repair -----------------------------------------------


def _wn_case(kind, seed):
    """(JAX module, its randomized params, the port's conv loaded with them,
    an input [B, T, C] / [B, H, W, C])."""
    rng = np.random.default_rng(seed)
    if kind == "conv1d":
        jmod = jlayers.Conv1d(6, 3, padding=1, weight_norm=True)
        x = rng.standard_normal((2, 10, 4)).astype(np.float32)
        port = layers.Conv1d(4, 6, 3, padding=1, weight_norm=True)
    elif kind == "conv_transpose1d":
        jmod = jlayers.ConvTranspose1d(6, 4, 2, padding=1, weight_norm=True)
        x = rng.standard_normal((2, 10, 4)).astype(np.float32)
        port = layers.ConvTranspose1d(4, 6, 4, 2, padding=1, weight_norm=True)
    else:
        jmod = jlayers.Conv2dTorch(6, (3, 1), (2, 1), (1, 0), weight_norm=True)
        x = rng.standard_normal((2, 9, 3, 4)).astype(np.float32)
        port = layers.Conv2d(4, 6, 3, 2, 1, weight_norm=True)
    params = randomize(jax.device_get(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed)["params"]
    v = np.asarray(params["v"])
    if kind == "conv1d":
        v_t = v.transpose(2, 1, 0)
    elif kind == "conv_transpose1d":
        v_t = v
    else:
        v_t = v.transpose(3, 2, 0, 1)
    port.load_state_dict({
        "weight_v": torch.from_numpy(np.ascontiguousarray(v_t)),
        "weight_g": torch.from_numpy(np.asarray(params["g"])).reshape(
            port.weight_g.shape),
        "bias": torch.from_numpy(np.asarray(params["bias"]))})
    return jmod, params, port, x, v_t.shape


@pytest.mark.parametrize("kind", ["conv1d", "conv_transpose1d", "conv2d"])
def test_weight_norm_gradients_match_jax(kind):
    """d loss / d weight_g, weight_v of one weight-normed conv against
    jax.grad, loss = sum(y * c) for a fixed random c; rtol 1e-4 (atol 1e-5
    for entries near zero)."""
    jmod, params, port, x, v_shape = _wn_case(kind, seed=7)
    want_y = jmod.apply({"params": params}, jnp.asarray(x))
    c = np.random.default_rng(8).standard_normal(want_y.shape).astype(
        np.float32)
    grads = jax.grad(lambda p: jnp.sum(
        jmod.apply({"params": p}, jnp.asarray(x)) * c))(params)

    port.train()
    x_t = torch.from_numpy(x)
    x_t = x_t.permute(0, 3, 1, 2) if kind == "conv2d" else x_t.transpose(1, 2)
    y = port(x_t)
    y = y.permute(0, 2, 3, 1) if kind == "conv2d" else y.transpose(1, 2)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=1e-5)
    (y * torch.from_numpy(c)).sum().backward()
    gv = np.asarray(grads["v"])
    if kind == "conv1d":
        gv = gv.transpose(2, 1, 0)
    elif kind == "conv2d":
        gv = gv.transpose(3, 2, 0, 1)
    np.testing.assert_allclose(port.weight_v.grad.numpy(), gv, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(port.weight_g.grad.numpy().reshape(-1),
                               np.asarray(grads["g"]), rtol=1e-4, atol=1e-5)


def test_weight_norm_buffer_refolds_on_eval():
    """In train() mode the kernel follows the parameters at once; the
    inference buffer is stale until eval() refolds it."""
    _, _, conv, x, _ = _wn_case("conv1d", seed=9)
    x_t = torch.from_numpy(x).transpose(1, 2)
    conv.eval()
    with torch.no_grad():
        before = conv(x_t)
        conv.train()
        conv.weight_g.mul_(2.0)  # an optimiser step
        stale = conv.weight.clone()
        live = conv(x_t)
        conv.eval()
        after = conv(x_t)
    assert not torch.equal(stale, conv.weight)
    torch.testing.assert_close(live, after)
    torch.testing.assert_close(
        after - conv.bias[None, :, None],
        2.0 * (before - conv.bias[None, :, None]))


def test_weight_norm_in_eval_mode_keeps_gradients_when_recording():
    """eval() with autograd recording: weight_g / weight_v still learn."""
    _, _, conv, x, _ = _wn_case("conv1d", seed=10)
    conv.eval()
    conv(torch.from_numpy(x).transpose(1, 2)).sum().backward()
    assert conv.weight_g.grad is not None and conv.weight_v.grad is not None
    with torch.no_grad():
        assert conv.kernel() is conv.weight


# ---- the decoder's gradient route -----------------------------------------


def test_decoder_gradient_reaches_through_the_mrf_stages(pair):
    """With gradients wanted the decoder runs the differentiable chain:
    conv_pre (upstream of every MRF stage), the upsample convs and the
    resblocks' weight_g / weight_v all get gradients, and the output equals
    the inference route's."""
    _, port = pair
    dec = copy.deepcopy(port.dec).train()
    z = torch.randn(2, 32, 12, requires_grad=True)
    g = torch.randn(2, 16, 1)
    out = dec(z, g=g)
    out.square().sum().backward()
    for p in (dec.conv_pre.weight, dec.ups[0].weight_g, dec.ups[0].weight_v,
              dec.resblocks[0].convs1[0].weight_g,
              dec.resblocks[-1].convs2[-1].weight_v, dec.conv_post.weight):
        assert p.grad is not None and p.grad.abs().sum() > 0
    assert z.grad is not None
    dec.eval()
    with torch.no_grad():
        assert not dec.gradient_wanted(z.detach())
        torch.testing.assert_close(dec(z.detach(), g=g), out.detach(),
                                   atol=1e-5, rtol=0)
    assert dec.gradient_wanted(z)  # eval mode, but autograd is recording


# ---- dropout and the draw module ------------------------------------------


def test_dropout_is_active_in_train_mode_only(pair):
    _, port = pair
    enc = copy.deepcopy(port.enc_p)
    x = torch.tensor([[3, 5, 7, 1, 2, 9]])
    xl = torch.tensor([6])
    with torch.no_grad():
        enc.eval()
        a = enc(x, xl, torch.Generator().manual_seed(0))[0]
        b = enc(x, xl, torch.Generator().manual_seed(1))[0]
        enc.train()
        c = enc(x, xl, torch.Generator().manual_seed(0))[0]
        d = enc(x, xl, torch.Generator().manual_seed(0))[0]
        e = enc(x, xl, torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, b)  # eval: deterministic
    assert not torch.equal(a, c)  # train: p_dropout 0.1 bites
    assert torch.equal(c, d) and not torch.equal(c, e)  # from the generator


def test_dropout_rates_follow_the_jax_modules(pair):
    """0.1 in the text encoder (config), 0.5 in the SDP's two DDSConv
    stacks, 0 in each ConvFlow's DDSConv and in WN."""
    _, port = pair
    assert port.enc_p.encoder.p_dropout == 0.1
    assert port.enc_p.encoder.attn_layers[0].p_dropout == 0.1
    assert port.enc_p.encoder.ffn_layers[0].p_dropout == 0.1
    assert port.dp.convs.p_dropout == port.dp.post_convs.p_dropout == 0.5
    assert port.dp.flows[1].convs.p_dropout == 0.0
    assert port.enc_q.enc.p_dropout == 0.0


def test_random_dropout_scales_and_zeroes():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(1000)
    y = random.dropout(x, 0.5, True, gen)
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 350 < int((y == 0).sum()) < 650
    assert random.dropout(x, 0.5, False, gen) is x
    assert random.dropout(x, 0.0, True, gen) is x


def test_sdp_pattern_is_the_update_parity_tests():
    """The shared SDP noise is tests/test_update_parity.py's pattern."""
    p = sdp_pattern(2, 5)
    assert p.shape == (2, 2, 5) and np.abs(p).min() > 1e-3
    np.testing.assert_allclose(p[1, 1, 2],
                               0.4 * np.sin(0.7 * 2 + 1.3 + 0.5 + 0.37),
                               rtol=1e-6)

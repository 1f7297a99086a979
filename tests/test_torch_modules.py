"""The port's model modules held against their wetts_tpu counterparts inside
one randomized small Synthesizer (tests/test_torch_parity.py:small_cfg):
TextEncoder, the stochastic duration predictor's reverse at
noise_scale_w = 0, DurationPredictor, WN, the coupling flow in both
directions and the HiFi-GAN Generator.

Both sides get the same numpy inputs and the same (randomized, nonzero)
parameters through the weight bridge. f32 on the CPU; each test states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import jax_synthesizer, port_synthesizer, \
    small_cfg_dict


@pytest.fixture(scope="module", params=[{}, {"use_sdp": False}],
                ids=["sdp", "dp"])
def pair(request):
    cfg = small_cfg_dict(**request.param)
    jmodel, params = jax_synthesizer(cfg)
    bound = jmodel.bind(params, rngs={"noise": jax.random.PRNGKey(0)})
    return bound, port_synthesizer(cfg, params)


def _bct(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a).transpose(0, 2, 1))


def _btc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 1)


def _text(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 24, size=(2, 11))
    return x, np.array([11, 7]), np.array([0, 2])


def _latent(c, t=24, seed=1):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, t, c)).astype(np.float32)
    mask = np.zeros((2, t, 1), np.float32)
    mask[0, :t] = 1
    mask[1, : t - 9] = 1
    return z, mask


def test_text_encoder(pair):
    """atol 2e-5: two transformer layers of f32."""
    bound, port = pair
    x, xl, _ = _text()
    want = bound.enc_p(jnp.asarray(x), jnp.asarray(xl))
    with torch.no_grad():
        got = port.enc_p(torch.from_numpy(x), torch.from_numpy(xl))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_btc(g), np.asarray(w), atol=2e-5)


def test_duration_predictor_reverse(pair):
    """SDP reverse at noise_scale_w = 0 (the reversed flow chain without its
    first ConvFlow, splines included), or the deterministic predictor;
    atol 2e-5 on log-durations."""
    bound, port = pair
    x, xl, sid = _text(3)
    x_h, _, _, x_mask = bound.enc_p(jnp.asarray(x), jnp.asarray(xl))
    g = bound._speaker(jnp.asarray(sid))
    if port.use_sdp:
        want = bound.dp(x_h, x_mask, g=g, reverse=True, noise_scale=0.0)
    else:
        want = bound.dp(x_h, x_mask, g=g)
    with torch.no_grad():
        args = (_bct(x_h), _bct(x_mask))
        kwargs = {"g": _bct(g)}
        if port.use_sdp:
            kwargs["noise_scale"] = 0.0
        got = port.dp(*args, **kwargs)
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=2e-5)


def test_wavenet(pair):
    """WN of the first coupling layer, with speaker conditioning and a
    ragged mask; atol 1e-5."""
    bound, port = pair
    h, mask = _latent(32)
    g = bound._speaker(jnp.asarray([1, 2]))
    want = bound.flow.flows[0].enc(jnp.asarray(h), jnp.asarray(mask), g=g)
    with torch.no_grad():
        got = port.flow.flows[0].enc(_bct(h), _bct(mask), g=_bct(g))
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_flow(pair, reverse):
    """The 4-coupling VITS1 flow with flips, both directions; atol 2e-5."""
    bound, port = pair
    z, mask = _latent(32, seed=2)
    g = bound._speaker(jnp.asarray([2, 0]))
    want = bound.flow(jnp.asarray(z), jnp.asarray(mask), g=g,
                      reverse=reverse)
    with torch.no_grad():
        got = port.flow(_bct(z), _bct(mask), g=_bct(g), reverse=reverse)
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=2e-5)


def test_generator(pair):
    """HiFi-GAN decoder (upsampling, MRF stages through mrf_stage's plain
    version, final slope 0.01, bias-free conv_post); atol 2e-5 on audio."""
    bound, port = pair
    z, _ = _latent(32, t=20, seed=4)
    g = bound._speaker(jnp.asarray([0, 1]))
    want = bound.dec(jnp.asarray(z), g=g)
    with torch.no_grad():
        got = port.dec(_bct(z), g=_bct(g))
    assert got.shape == (2, 1, 20 * 16)
    np.testing.assert_allclose(_btc(got), np.asarray(want), atol=2e-5)

"""The port's primitives held against wetts_tpu's: layers, masking, the
relative-position encoder and the rational-quadratic splines.

Inputs and parameters come from numpy seeds and go to both sides. Every
comparison is f32 on the CPU at atol 1e-5 (single layers: only the order of
f32 sums differs) unless a test states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import randomize
from wetts_tpu.models import attention as jattention
from wetts_tpu.models import layers as jlayers
from wetts_tpu.ops import masking as jmasking
from wetts_tpu.ops import splines as jsplines
from wetts_tpu_torch.models import attention, layers
from wetts_tpu_torch.ops import masking, splines
from wetts_tpu_torch.utils.convert import FlaxToTorch

KEY = jax.random.PRNGKey(0)


def _bct(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _init(module, *args, seed=1):
    params = module.init({"params": KEY}, *args)["params"]
    return randomize(jax.device_get(params), seed)


@pytest.mark.parametrize("k,d,weight_norm", [(1, 1, False), (3, 1, True),
                                              (5, 3, True), (7, 1, False)])
def test_conv1d(k, d, weight_norm):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 23, 6)).astype(np.float32)
    pad = jlayers.get_padding(k, d)
    jconv = jlayers.Conv1d(5, k, padding=pad, dilation=d,
                           weight_norm=weight_norm)
    params = _init(jconv, jnp.asarray(x))
    want = jconv.apply({"params": params}, jnp.asarray(x))
    conv = layers.Conv1d(6, 5, k, padding=layers.get_padding(k, d),
                         dilation=d, weight_norm=weight_norm)
    m = FlaxToTorch(params)
    m.conv((), "")
    conv.load_state_dict(m.state)
    with torch.no_grad():
        got = conv(_bct(x)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("u,k", [(4, 8), (2, 4), (8, 16)])
def test_conv_transpose1d_weight_norm(u, k):
    rng = np.random.default_rng(u)
    x = rng.standard_normal((2, 11, 8)).astype(np.float32)
    jconv = jlayers.ConvTranspose1d(4, k, stride=u, padding=(k - u) // 2,
                                    weight_norm=True)
    params = _init(jconv, jnp.asarray(x))
    want = jconv.apply({"params": params}, jnp.asarray(x))
    conv = layers.ConvTranspose1d(8, 4, k, u, padding=(k - u) // 2,
                                  weight_norm=True)
    m = FlaxToTorch(params)
    m.conv((), "", transpose=True)
    conv.load_state_dict(m.state)
    with torch.no_grad():
        got = conv(_bct(x)).numpy().transpose(0, 2, 1)
    assert got.shape == (2, 11 * u, 4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_layer_norm_and_dense():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    jln = jlayers.LayerNorm(12)
    p_ln = _init(jln, jnp.asarray(x))
    jdense = jlayers.Dense(7)
    p_dense = _init(jdense, jnp.asarray(x), seed=2)
    ln, dense = layers.LayerNorm(12), layers.Dense(12, 7)
    m = FlaxToTorch({"ln": p_ln, "dense": p_dense})
    m.layer_norm(("ln",), "ln")
    m.conv(("dense",), "dense")
    ln.load_state_dict({k[3:]: v for k, v in m.state.items()
                        if k.startswith("ln.")})
    dense.load_state_dict({k[6:]: v for k, v in m.state.items()
                           if k.startswith("dense.")})
    with torch.no_grad():
        got_ln = ln(_bct(x)).numpy().transpose(0, 2, 1)
        got_dense = dense(_bct(x)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(
        got_ln, np.asarray(jln.apply({"params": p_ln}, jnp.asarray(x))),
        atol=1e-5)
    np.testing.assert_allclose(
        got_dense,
        np.asarray(jdense.apply({"params": p_dense}, jnp.asarray(x))),
        atol=1e-5)


def test_gated_activation_and_padding():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 10, 8)).astype(np.float32)
    b = rng.standard_normal((2, 10, 8)).astype(np.float32)
    want = jlayers.fused_add_tanh_sigmoid_multiply(
        jnp.asarray(a), jnp.asarray(b), 4)
    got = layers.fused_add_tanh_sigmoid_multiply(_bct(a), _bct(b), 4)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=1e-6)
    for k in (3, 5, 7, 11):
        for d in (1, 2, 3, 5):
            assert layers.get_padding(k, d) == jlayers.get_padding(k, d)


def test_sequence_mask_and_generate_path():
    """Exact: integer arithmetic in float."""
    lengths = np.array([5, 1, 8])
    np.testing.assert_array_equal(
        masking.sequence_mask(torch.from_numpy(lengths), 8).numpy(),
        np.asarray(jmasking.sequence_mask(jnp.asarray(lengths), 8)))
    rng = np.random.default_rng(4)
    dur = rng.integers(0, 4, size=(3, 6)).astype(np.float32)
    mask = (rng.random((3, 6, 20)) > 0.2).astype(np.float32)
    want = jmasking.generate_path(jnp.asarray(dur), jnp.asarray(mask))
    got = masking.generate_path(torch.from_numpy(dur), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t", [3, 5, 13])
def test_encoder(t):
    """Relative-position encoder, shorter and longer than the window, with a
    ragged mask (the -1e4 fill); atol 2e-5 across two layers."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    lengths = np.array([t, max(1, t - 2)])
    x_mask = np.asarray(jmasking.sequence_mask(jnp.asarray(lengths), t))
    jenc = jattention.Encoder(16, 32, 2, 2, kernel_size=3)
    params = _init(jenc, jnp.asarray(x), jnp.asarray(x_mask[:, :, None]))
    want = jenc.apply({"params": params}, jnp.asarray(x),
                      jnp.asarray(x_mask[:, :, None]))
    enc = attention.Encoder(16, 32, 2, 2, kernel_size=3)
    m = FlaxToTorch(params)
    m.encoder((), "", 2)
    enc.load_state_dict(m.state)
    with torch.no_grad():
        got = enc(_bct(x), torch.tensor(x_mask)[:, None, :])
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_transform(inverse):
    """Linear-tail RQ spline, inside and outside the tail bound; atol and
    rtol 1e-5 on outputs (up to |5|) and log-det: a few f32 ulps."""
    rng = np.random.default_rng(5)
    shape, k = (3, 40), 10
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    uw = rng.standard_normal(shape + (k,)).astype(np.float32)
    uh = rng.standard_normal(shape + (k,)).astype(np.float32)
    ud = rng.standard_normal(shape + (k - 1,)).astype(np.float32)
    want = jsplines.piecewise_rational_quadratic_transform(
        *map(jnp.asarray, (x, uw, uh, ud)), inverse=inverse, tails="linear",
        tail_bound=5.0)
    got = splines.piecewise_rational_quadratic_transform(
        *map(torch.from_numpy, (x, uw, uh, ud)), inverse=inverse,
        tails="linear", tail_bound=5.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)

"""The port's int8 convolutions and int8 decoder (`models/quant.py`, the
"int8" route of `models/hifigan.py`) held against the `q8` path of
wetts_tpu/models/hifigan_fast.py.

Inputs and parameters come from numpy seeds. The integer sums are exact on
both sides, so a single conv agrees to f32 rounding (rtol 1e-5); each test
states its tolerance. On the CPU the wrappers run their plain versions.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import randomize
from wetts_tpu.models import hifigan_fast as jf
from wetts_tpu.models.hifigan import Generator as JaxGenerator
from wetts_tpu_torch.models import hifigan as port_hifigan
from wetts_tpu_torch.models.quant import (
    QuantConv1d,
    QuantConvTranspose1d,
    int8_conv1d,
    int8_conv_transpose1d,
    quantize_weight,
    row_scale,
    upsample_scale_per_phase,
)
from wetts_tpu_torch.utils.convert import FlaxToTorch

# tests/test_hifigan_fast.py:68-73: v1 topology scaled down, stages of 128,
# 64, 32 and 16 channels; the JAX package runs the first two upsamples
# plain (per-channel scales) and the last two blocked (per-phase scales)
GEN = dict(initial_channel=48, resblock="1", resblock_kernel_sizes=(3, 7),
           resblock_dilation_sizes=((1, 3, 5),) * 2,
           upsample_rates=(8, 8, 2, 2), upsample_initial_channel=256,
           upsample_kernel_sizes=(16, 16, 4, 4))
GIN = 16


def _w(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(
        np.float32)


@pytest.mark.parametrize("o,i,k", [(8, 16, 3), (32, 32, 11), (5, 7, 1)])
def test_quantize_weight_equals_jax(o, i, k):
    """int8 exactly; the scale within rel 1e-7 (one f32 division)."""
    w = _w((o, i, k), o)
    w[1] = 0.0  # a channel of zeros: the 1e-12 floor
    wq, scale = quantize_weight(torch.from_numpy(w))
    want_q, want_s = jf._quantize_kernel(jnp.asarray(w.transpose(2, 1, 0)))
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy().transpose(2, 1, 0),
                                  np.asarray(want_q))
    np.testing.assert_allclose(scale.numpy(), np.asarray(want_s), rtol=1e-7)


@pytest.mark.parametrize("ci,co,k,u,r_i", [(16, 8, 4, 2, 1), (8, 4, 4, 2, 2),
                                           (8, 4, 16, 8, 1), (6, 4, 7, 3, 2)])
def test_per_phase_scales_equal_the_blocked_kernel(ci, co, k, u, r_i):
    """Column (io, co) of the JAX package's blocked transposed-conv kernel
    holds the taps j = io + pd (mod u), so `_quantize_kernel` scales it per
    (io mod u, co): the port's per-phase scale, and the same int8 values."""
    pd = (k - u) // 2
    w = _w((ci, co, k), k)
    wq, scale = quantize_weight(torch.from_numpy(w), u, pd, per_phase=True)
    r_o = r_i * u
    wb, _, _ = jf.blocked_tconv_kernel(jnp.asarray(w), u, pd, r_i, r_o)
    want_q, want_s = jf._quantize_kernel(wb)
    assert scale.shape == (u, co)
    want_s = np.asarray(want_s).reshape(r_o, co)
    for io in range(r_o):
        np.testing.assert_allclose(scale[io % u].numpy(), want_s[io],
                                   rtol=1e-7)
    got_q, _, _ = jf.blocked_tconv_kernel(
        jnp.asarray(wq.numpy().astype(np.float32)), u, pd, r_i, r_o)
    np.testing.assert_array_equal(np.asarray(got_q).astype(np.int8),
                                  np.asarray(want_q))
    # per channel: every phase carries the scale over all taps
    _, flat = quantize_weight(torch.from_numpy(w), u, pd)
    want = np.maximum(np.abs(w).max(axis=(0, 2)), 1e-12) / 127.0
    np.testing.assert_allclose(flat.numpy(), np.tile(want, (u, 1)),
                               rtol=1e-7)


def test_upsample_scale_per_phase_follows_the_jax_decoder():
    # v1: the third and fourth upsamples are blocked
    assert upsample_scale_per_phase(512, (8, 8, 2, 2), 352) == \
        [False, False, True, True]
    # the scaled-down v1: 64 channels enter the blocked domain through a
    # plain transposed conv (u = 8 != 2), the later ones are blocked
    assert upsample_scale_per_phase(256, (8, 8, 2, 2), 20) == \
        [False, False, True, True]
    # v3 topology: 32 channels at u = 4 = 128 / 32
    assert upsample_scale_per_phase(256, (8, 8, 4), 20) == \
        [False, False, True]
    # all stages at 128 channels or more: never blocked
    assert upsample_scale_per_phase(512, (4, 2), 12) == [False, False]
    # an odd length keeps a 64-channel stage out of the blocked domain
    assert upsample_scale_per_phase(128, (3, 2), 5) == [False, False]
    assert upsample_scale_per_phase(128, (3, 4), 5) == [False, True]
    assert upsample_scale_per_phase(128, (3, 2), 6) == [False, True]


def _x(b, t, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    x[0] *= 30.0  # a loud row beside a quiet one
    return x


@pytest.mark.parametrize("c_in,c_out,k,d", [(16, 16, 3, 1), (32, 32, 7, 5),
                                            (8, 24, 11, 3)])
def test_int8_conv1d_matches_jax(c_in, c_out, k, d):
    """Against `_plain_conv(q8=True)` on f32 inputs: the int32 sums are
    exact, the dequantisation is two f32 products; rtol 1e-5."""
    w = _w((c_out, c_in, k), k)
    bias = _w((c_out,), 1) * 0.1
    x = _x(2, 50, c_in, 2)
    pad = (k - 1) * d // 2
    want = jf._plain_conv(
        jnp.asarray(x), {"kernel": jnp.asarray(w.transpose(2, 1, 0)),
                         "bias": jnp.asarray(bias)}, pad, d, q8=True)
    conv = QuantConv1d(torch.from_numpy(w), torch.from_numpy(bias))
    before = int8_conv1d.launches, row_scale.launches
    got = int8_conv1d(torch.from_numpy(x), conv, d)
    assert (int8_conv1d.launches, row_scale.launches) == before  # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("c_in,c_out,k,u", [(32, 16, 16, 8), (16, 8, 4, 2),
                                            (8, 8, 7, 3)])
def test_int8_conv_transpose1d_matches_jax(c_in, c_out, k, u):
    """Per channel against `_plain_tconv(q8=True)`; per phase against the
    blocked kernel the JAX decoder runs (`_conv` on `blocked_tconv_kernel`
    at r_i = 1, whose output [B, T, u * C] is [B, T * u, C]); rtol 1e-5."""
    pd = (k - u) // 2
    w = _w((c_in, c_out, k), u)
    bias = _w((c_out,), 3) * 0.1
    x = _x(2, 21, c_in, 4)
    p = {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}
    want = jf._plain_tconv(jnp.asarray(x), p, u, pd, q8=True)
    tw, tb = torch.from_numpy(w), torch.from_numpy(bias)
    got = int8_conv_transpose1d(
        torch.from_numpy(x), QuantConvTranspose1d(tw, tb, u, pd, False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if (k - u) % 2:
        return  # the blocked layout needs T_out = T * u
    wb, pl, pr = jf.blocked_tconv_kernel(jnp.asarray(w), u, pd, 1, u)
    want = jf._conv(jnp.asarray(x), wb, pl, pr, q8=True) + jnp.tile(
        jnp.asarray(bias), u)
    got = int8_conv_transpose1d(
        torch.from_numpy(x), QuantConvTranspose1d(tw, tb, u, pd, True))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).reshape(2, 21 * u, c_out), rtol=1e-5,
        atol=1e-6)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoders():
    """(JAX dec params, the port's Generator with the same weights)."""
    g = JaxGenerator(gin_channels=GIN, **GEN)
    params = g.init({"params": jax.random.PRNGKey(0)},
                    jnp.zeros((1, 8, GEN["initial_channel"])),
                    jnp.zeros((1, 1, GIN)))["params"]
    params = randomize(jax.device_get(params), 5)
    port = port_hifigan.Generator(gin_channels=GIN, **GEN)
    m = FlaxToTorch(params)
    m.generator((), "", types.SimpleNamespace(model=types.SimpleNamespace(
        **GEN)))
    m.check_all_used()
    port.load_state_dict(m.state)
    return params, port.eval()


def _jax_decode(params, x, spk, **kw):
    kwargs = {k: v for k, v in GEN.items() if k != "initial_channel"}
    return np.asarray(jf.fast_generator_apply(
        params, jnp.asarray(x), jnp.asarray(spk), **kwargs, **kw))


def _latents(seed, b=2, t=20):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, GEN["initial_channel"])).astype(
        np.float32), rng.standard_normal((b, 1, GIN)).astype(np.float32))


def _port_decode(port, x, spk, precision, dtype=torch.bfloat16):
    with torch.no_grad():
        out = port.infer(torch.from_numpy(x).transpose(1, 2),
                         torch.from_numpy(spk).transpose(1, 2),
                         port_hifigan._Form(port, precision, dtype))
    return out.transpose(1, 2).numpy()


def test_int8_decoder_matches_jax_in_f32_glue(decoders):
    """Against `fast_generator_apply(quantize=True, dtype=float32)`: the
    same int8 weights, scales (per channel and per phase) and integer sums,
    with f32 glue on both sides. Not exact: the f32 glue sums in another
    order (the JAX branch mean is (a + b) / 2, the port's a / 2 + b / 2), and
    where that moves an activation across a rounding boundary one quantised
    input changes by a step of 1 / 127 of its row's max, a small share of
    one of some thousand products. atol 1e-3 on a wave of magnitude 1; a
    wrong scale rule (per channel where JAX is per phase) shows as 1e-2."""
    params, port = decoders
    x, spk = _latents(1)
    want = _jax_decode(params, x, spk, quantize=True, dtype=jnp.float32)
    got = _port_decode(port, x, spk, "int8", torch.float32)
    assert got.shape == want.shape == (2, 20 * 256, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_int8_decoder_within_the_jax_bounds(decoders):
    """The serving form (bf16 glue) against JAX's (`quantize=True`) and
    against f32, with the bounds the JAX package sets its own int8 decoder
    (tests/test_hifigan_fast.py:137-140): max abs err < 3e-2 on the
    tanh-bounded wave, correlation > 0.99."""
    params, port = decoders
    x, spk = _latents(1)
    exact = _jax_decode(params, x, spk)
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2),
                   torch.from_numpy(spk).transpose(1, 2),
                   precision="int8").transpose(1, 2).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    for want in (exact, _jax_decode(params, x, spk, quantize=True)):
        assert np.abs(got - want).max() < 3e-2
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


def test_int8_decoder_batch_isolation(decoders):
    """As test_fast_int8_batch_isolation: activation scales are per batch
    row, so a quiet row decodes the same beside a 100x louder one (atol
    1e-6)."""
    _, port = decoders
    rng = np.random.default_rng(3)
    quiet = rng.standard_normal((1, 20, 48)).astype(np.float32)
    loud = 100.0 * rng.standard_normal((1, 20, 48)).astype(np.float32)
    spk = rng.standard_normal((1, 1, GIN)).astype(np.float32)
    alone = _port_decode(port, quiet, spk, "int8")
    batched = _port_decode(port, np.concatenate([quiet, loud]),
                           np.concatenate([spk, spk]), "int8")[:1]
    np.testing.assert_allclose(batched, alone, atol=1e-6)


def test_reduced_decoder_refuses_a_gradient(decoders):
    """bf16 / int8 are inference routes: they raise where a gradient is
    wanted, and an unknown precision raises on either route (when their
    weights are derived anew is held in tests/test_torch_derived.py)."""
    _, port = decoders
    x, spk = _latents(2, b=1, t=8)
    xt = torch.from_numpy(x).transpose(1, 2)
    gt = torch.from_numpy(spk).transpose(1, 2)
    for precision in ("bf16", "int8"):
        with pytest.raises(RuntimeError, match="no backward"):
            port(xt, gt, precision=precision)  # parameters require grad
    with pytest.raises(ValueError):
        port(xt, gt, precision="fp8")
    with torch.no_grad(), pytest.raises(ValueError):
        port(xt, gt, precision="fp8")

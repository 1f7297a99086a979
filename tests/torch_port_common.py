"""Shared fixtures of the PyTorch-port tests: small configs, a randomized
JAX Synthesizer, and the port model loaded with the same weights.

Inputs and parameters come from numpy seeds and go to both sides as numpy
arrays; every parameter gets a random value (the reference zero-initializes
the flow `post` and the ConvFlow `proj`, which once hid the spline path).
"""

from __future__ import annotations

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.utils.convert import params_from_jax

# Under pytest-xdist, torch's intra-op pool of each worker gets its share of
# the cores, not all of them: with every worker's pool as wide as the
# machine, a 3-step tiny Trainer test took 120 s beside six busy processes
# on 8 cores, and 14 s with one thread (7 s on an idle machine).
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def small_cfg_dict(**model_overrides):
    """tests/test_torch_parity.py:small_cfg as a dict (that module imports
    the torch reference oracle, which this tree does not carry)."""
    model = {
        "inter_channels": 32, "hidden_channels": 32, "filter_channels": 64,
        "n_heads": 2, "n_layers": 2, "kernel_size": 3, "p_dropout": 0.1,
        "resblock": "1", "resblock_kernel_sizes": [3, 5],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
        "upsample_rates": [4, 4], "upsample_initial_channel": 64,
        "upsample_kernel_sizes": [8, 8], "gin_channels": 16,
    }
    model.update(model_overrides)
    return {
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": model, "num_phones": 24, "num_speakers": 3}


def randomize(tree, seed: int):
    """Every leaf redrawn from a numpy seed at the leaf's own scale (mean and
    spread; 0.1 where the init is constant, e.g. zero-init or LN scale)."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        leaf = np.asarray(leaf, np.float32)
        std = float(leaf.std()) or 0.1
        return (float(leaf.mean()) + std * rng.standard_normal(leaf.shape)
                ).astype(np.float32)

    return jax.tree.map(draw, tree)


def jax_synthesizer(cfg_dict, seed: int = 0):
    """(JAX model, randomized numpy params {"params": ...}) for cfg_dict.
    Cached per config: callers must not mutate the params."""
    return _jax_synthesizer(json.dumps(cfg_dict, sort_keys=True), seed)


@functools.lru_cache(maxsize=None)
def _jax_synthesizer(cfg_json: str, seed: int):
    cfg = JaxConfig.from_dict(json.loads(cfg_json))
    model = JaxSynthesizer.from_config(cfg)
    key = jax.random.PRNGKey(seed)
    variables = model.init(
        {"params": key, "noise": key, "dropout": key, "slice": key},
        jnp.ones((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, 36, cfg.data.spec_channels)), jnp.array([36]),
        jnp.array([0]))
    return model, randomize(jax.device_get(variables), seed + 1)


def port_synthesizer(cfg_dict, jax_params) -> Synthesizer:
    """The port's Synthesizer loaded with the JAX params (strict load)."""
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    model = Synthesizer(cfg)
    model.load_state_dict(params_from_jax(jax_params, cfg))
    return model.eval()


# ---------------------------------------------------------------------------
# training fixtures: the discriminator pair and draws shared by both sides
# ---------------------------------------------------------------------------


def jax_discriminator(seed: int = 0):
    """(JAX MultiPeriodDiscriminator, randomized numpy params)."""
    return _jax_discriminator(seed)


@functools.lru_cache(maxsize=None)
def _jax_discriminator(seed: int):
    from wetts_tpu.models.discriminators import MultiPeriodDiscriminator

    net_d = MultiPeriodDiscriminator()
    wav = jnp.zeros((1, 256, 1))
    variables = net_d.init(jax.random.PRNGKey(seed), wav, wav)
    return net_d, randomize(jax.device_get(variables), seed + 1)


def port_discriminator(jax_params):
    """The port's MultiPeriodDiscriminator loaded with the JAX params."""
    from wetts_tpu_torch.models.discriminators import (
        MultiPeriodDiscriminator,
    )
    from wetts_tpu_torch.utils.convert import discriminator_from_jax

    net_d = MultiPeriodDiscriminator()
    net_d.load_state_dict(discriminator_from_jax(jax_params))
    return net_d


def sdp_pattern(b: int, t: int) -> np.ndarray:
    """The stochastic duration predictor's 2-channel noise, [B, 2, T]
    (tests/test_update_parity.py:_sdp_pattern): smooth, O(0.4) and non-zero,
    so that no spline input sits on a knot, where the two frameworks route
    the subgradient to different bins."""
    i = np.arange(2, dtype=np.float32)[None, :, None]
    bb = np.arange(b, dtype=np.float32)[:, None, None]
    tt = np.arange(t, dtype=np.float32)[None, None, :]
    return (0.4 * np.sin(0.7 * tt + 1.3 * i + 0.5 * bb + 0.37)).astype(
        np.float32)


def normal_pattern(b: int, c: int, t: int) -> np.ndarray:
    """Every other normal draw (the posterior sample), [B, C, T]."""
    cc = np.arange(c, dtype=np.float32)[None, :, None]
    bb = np.arange(b, dtype=np.float32)[:, None, None]
    tt = np.arange(t, dtype=np.float32)[None, None, :]
    return (0.5 * np.sin(0.31 * tt + 0.17 * cc + 0.9 * bb + 0.11)).astype(
        np.float32)


def uniform_pattern(b: int) -> np.ndarray:
    """The slice offsets' uniform draws in [0, 1), [B]."""
    return ((0.37 * (np.arange(b) + 1)) % 1.0).astype(np.float32)


def patch_shared_draws(monkeypatch) -> None:
    """Identical deterministic draws on both sides and no dropout: patches
    `jax.random.normal` / `uniform` and flax `Dropout` (nothing in
    `wetts_tpu` changes), and the port's one draw module `ops/random.py`.
    JAX draws are channel-last [B, T, C], the port's [B, C, T]. Build the
    JAX models first: their initialisers draw through `jax.random` too
    (flax re-traces them for their shapes on every apply, so draws of other
    ranks pass through to the real functions)."""
    import torch
    from flax import linen as fnn

    from wetts_tpu_torch.ops import random as port_random

    real_normal, real_uniform = jax.random.normal, jax.random.uniform

    def jnormal(key, shape=(), dtype=jnp.float32):
        if len(shape) != 3:
            return real_normal(key, shape, dtype)
        b, t, c = shape
        pat = sdp_pattern(b, t) if c == 2 else normal_pattern(b, c, t)
        return jnp.asarray(pat.transpose(0, 2, 1), dtype)

    def juniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if len(shape) != 1:
            return real_uniform(key, shape, dtype, minval, maxval)
        (b,) = shape
        return jnp.asarray(uniform_pattern(b), dtype)

    monkeypatch.setattr(jax.random, "normal", jnormal)
    monkeypatch.setattr(jax.random, "uniform", juniform)
    monkeypatch.setattr(
        fnn.Dropout, "__call__",
        lambda self, x, deterministic=None, rng=None: x)

    def pnormal(shape, device, dtype=torch.float32, generator=None):
        b, c, t = shape
        pat = sdp_pattern(b, t) if c == 2 else normal_pattern(b, c, t)
        return torch.from_numpy(pat).to(device, dtype)

    def puniform(shape, device, dtype=torch.float32, generator=None):
        (b,) = shape
        return torch.from_numpy(uniform_pattern(b)).to(device, dtype)

    monkeypatch.setattr(port_random, "normal", pnormal)
    monkeypatch.setattr(port_random, "uniform", puniform)
    monkeypatch.setattr(port_random, "dropout",
                        lambda x, p, training, generator=None: x)


def train_batch(cfg_dict, seed: int = 3):
    """(phone ids, text lengths, wav, spec lengths, speaker ids) as numpy:
    2 utterances of unequal text and spec lengths, full-length waveforms."""
    rng = np.random.default_rng(seed)
    b, t_text, frames = 2, 9, 24
    hop = cfg_dict["data"]["hop_length"]
    x = rng.integers(1, cfg_dict["num_phones"], size=(b, t_text))
    xl = np.array([t_text, t_text - 2])
    wav = (rng.standard_normal((b, frames * hop)) * 0.3).astype(np.float32)
    yl = np.array([frames, frames - 3])
    sid = np.array([0, 1])
    return x, xl, wav, yl, sid


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Delete a test's trainer checkpoints when it ends: every `Trainer`
    saves the full-width multi-period discriminator with its AdamW moments
    (some 0.5 GB a file, whatever the config's size), and pytest keeps the
    temporary directories of its last runs. Import it into a test module
    to use it there."""
    yield
    for path in tmp_path.rglob("ckpt_*.pt"):
        path.unlink()

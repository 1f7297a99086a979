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

import jax
import jax.numpy as jnp
import numpy as np

from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.utils.convert import params_from_jax


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

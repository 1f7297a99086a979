"""The slice as a whole: the port's Synthesizer.infer against the JAX one,
and the weight bridge in both directions.

Acceptance: at scales (0, 1, 0), equal y_lengths and audio within atol 2e-4
(the reference-parity tolerance of tests/test_torch_parity.py) for
small_cfg() and small_cfg(use_sdp=False), all parameters randomized.
"""

import copy

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torch_port_common import jax_synthesizer, port_synthesizer, \
    small_cfg_dict
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer
from wetts_tpu.utils.convert import convert_synthesizer
from wetts_tpu.utils.params_io import save_params_npz
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.utils.convert import params_from_jax
from wetts_tpu_torch.utils.params_io import load_params_npz


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("overrides", [{}, {"use_sdp": False}],
                         ids=["vits1_sdp", "vits1_dp"])
def test_infer_matches_jax(overrides):
    cfg = small_cfg_dict(**overrides)
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
        rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        audio, y_len, _ = port.infer(
            torch.from_numpy(x), torch.from_numpy(xl), torch.from_numpy(sid),
            0.0, 1.0, 0.0, max_frames)
    np.testing.assert_array_equal(y_len.numpy(), np.asarray(want_len))
    assert audio.shape == (3, max_frames * 16, 1)
    np.testing.assert_allclose(audio.numpy(), np.asarray(want_audio),
                               atol=2e-4)


def test_weight_bridge_round_trip():
    """port state_dict -> convert_synthesizer -> params_from_jax gives back
    the same tensors, and convert_synthesizer maps every port tensor onto
    exactly the JAX tree, the posterior encoder included."""
    cfg = small_cfg_dict()
    _, params = jax_synthesizer(cfg)
    port = port_synthesizer(cfg, params)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    tree = convert_synthesizer(state, JaxConfig.from_dict(copy.deepcopy(cfg)))
    want = dict(_leaves(params["params"]))
    got = dict(_leaves(tree))
    assert set(got) == set(want)
    for p, a in want.items():
        np.testing.assert_array_equal(got[p], a, err_msg="/".join(p))
    back = params_from_jax(tree, Config.from_dict(copy.deepcopy(cfg)))
    assert set(back) == set(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_params_from_jax_rejects_unmapped_leaves():
    cfg = small_cfg_dict()
    _, params = jax_synthesizer(cfg)
    tree = copy.deepcopy(params["params"])
    tree["dec"]["stray"] = {"kernel": np.zeros((1, 2, 3), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        params_from_jax(tree, Config.from_dict(copy.deepcopy(cfg)))


def test_params_npz_reader(tmp_path):
    """A bundle written by the JAX package's save_params_npz loads through
    the port's reader (no jax, no ml_dtypes) to the same arrays; bf16 leaves
    widen exactly to f32; a full model bundle loads into the port."""
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf16 = rng.standard_normal((5,)).astype(ml_dtypes.bfloat16)
    path = tmp_path / "params.npz"
    save_params_npz(str(path), {"a": {"kernel": f32}, "b": {"g": bf16}})
    tree = load_params_npz(str(path))
    np.testing.assert_array_equal(tree["a"]["kernel"], f32)
    assert tree["b"]["g"].dtype == np.float32
    np.testing.assert_array_equal(tree["b"]["g"], bf16.astype(np.float32))

    cfg = small_cfg_dict()
    _, params = jax_synthesizer(cfg)
    save_params_npz(str(tmp_path / "bundle.npz"), params)
    port = port_synthesizer(cfg, load_params_npz(str(tmp_path / "bundle.npz")))
    direct = port_synthesizer(cfg, params)
    for (k, v), (k2, v2) in zip(port.state_dict().items(),
                                direct.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k

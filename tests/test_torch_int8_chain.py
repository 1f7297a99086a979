"""K3's module: the port's `matmul_chain` (on the CPU, its plain version)
held against the Pallas kernel it replaces, tools/probe_int8_mxu.py:_chain.

The probe is a script, so it is loaded by path; its module globals M, K and
TM are set small and `pl.pallas_call` is wrapped with `interpret=True`, so
the kernel runs on the CPU. Nothing in the script changes. int8 is exact
(and also equal to a numpy statement of the chain); bf16 sums in another
order, so it is held within a relative bound.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wetts_tpu_torch.ops.int8_chain import (
    HOPS,
    matmul_chain,
    matmul_chain_reference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, K, TM = 32, 256, 16  # at K = 256 an int8 hop (>> 10) keeps its magnitude


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "probe_int8_mxu", os.path.join(ROOT, "tools", "probe_int8_mxu.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.CHAIN == HOPS == 16
    module.M, module.K, module.TM = M, K, TM
    return module


@pytest.fixture
def interpreted(probe, monkeypatch):
    """`pl.pallas_call(...)` of the probe module runs in interpret mode."""
    monkeypatch.setattr(probe, "pl", _Interpreted(probe.pl))
    return probe


class _Interpreted:
    """`jax.experimental.pallas` with `pallas_call(..., interpret=True)`."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        if name == "pallas_call":
            return functools.partial(self._pl.pallas_call, interpret=True)
        return getattr(self._pl, name)


def numpy_chain(a, w, hops):
    a, w = a.astype(np.int64), w.astype(np.int64)
    for _ in range(hops):
        a = np.clip((a @ w) >> 10, -127, 127)
    return a.astype(np.int8)


def test_int8_chain_equals_pallas_and_numpy(interpreted):
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 127, (M, K), dtype=np.int8)
    w = rng.integers(-127, 127, (K, K), dtype=np.int8)
    want = np.asarray(interpreted._chain(jnp.asarray(a), jnp.asarray(w),
                                         jnp.int8))
    before = matmul_chain.launches
    got = matmul_chain(torch.from_numpy(a), torch.from_numpy(w))
    assert matmul_chain.launches == before  # a CPU tensor: the plain version
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(want, numpy_chain(a, w, HOPS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 50  # not saturated away


def test_bf16_chain_matches_pallas(interpreted):
    """f32 sums in another order, rounded to bf16 after each of 16 hops:
    within 2 ** -5 of max |want| (4 bf16 steps at the largest value). `w`
    is scaled by 32 / sqrt(K), so a hop keeps the magnitude at this K."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((K, K)) * 32 / np.sqrt(K)
                          ).astype(np.float32)).to(torch.bfloat16)
    want = np.asarray(interpreted._chain(
        jnp.asarray(a.float().numpy(), jnp.bfloat16),
        jnp.asarray(w.float().numpy(), jnp.bfloat16),
        jnp.bfloat16).astype(jnp.float32))
    got = matmul_chain(a, w)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert 0.1 < scale < 1e4
    assert np.abs(got - want).max() <= 2.0 ** -5 * scale
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("hops", [0, 1, 5])
def test_chain_hops_and_checks(hops):
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 127, (7, 24), dtype=np.int8)
    w = rng.integers(-127, 127, (24, 24), dtype=np.int8)
    got = matmul_chain_reference(torch.from_numpy(a), torch.from_numpy(w),
                                 hops)
    np.testing.assert_array_equal(got.numpy(), numpy_chain(a, w, hops))
    with pytest.raises(ValueError):
        matmul_chain(torch.from_numpy(a), torch.from_numpy(w[:, :8]))
    with pytest.raises(ValueError):
        matmul_chain(torch.from_numpy(a).float(), torch.from_numpy(w).float())

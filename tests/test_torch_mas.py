"""Monotonic alignment search: the port's plain version (what `maximum_path`
runs on a CPU tensor, and kernel K2's oracle on the card) against the JAX
package's scan, its Pallas kernel in interpret mode and the numpy oracle of
tests/test_mas.py. MAS is exact: every comparison is `assert_array_equal`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_mas import mas_oracle
from wetts_tpu.ops.mas import maximum_path_scan
from wetts_tpu.ops.mas_pallas import maximum_path_pallas
from wetts_tpu_torch.ops.mas import maximum_path, maximum_path_reference

CASES = {
    "full": dict(seed=0, b=3, t_spec=40, t_text=17, ragged=False),
    "ragged": dict(seed=1, b=6, t_spec=64, t_text=23, ragged=True),
    "square": dict(seed=2, b=2, t_spec=9, t_text=9, ragged=False),
    "one_by_one": dict(seed=3, b=2, t_spec=1, t_text=1, ragged=False),
}


def make_case(seed, b, t_spec, t_text, ragged):
    """(neg_cent, mask, spec lengths, text lengths), as tests/test_mas.py
    draws them."""
    rng = np.random.default_rng(seed)
    neg_cent = rng.standard_normal((b, t_spec, t_text)).astype(np.float32) * 3
    if ragged:
        t_ys = rng.integers(t_text, t_spec + 1, size=b)
        t_xs = np.minimum(rng.integers(1, t_text + 1, size=b), t_ys)
    else:
        t_ys = np.full(b, t_spec)
        t_xs = np.full(b, t_text)
    mask = np.zeros((b, t_spec, t_text), np.float32)
    for i in range(b):
        mask[i, : t_ys[i], : t_xs[i]] = 1
    return neg_cent, mask, t_ys, t_xs


def port_path(neg_cent, mask):
    return maximum_path_reference(torch.from_numpy(neg_cent),
                                  torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_numpy_oracle(case):
    neg_cent, mask, t_ys, t_xs = make_case(**CASES[case])
    np.testing.assert_array_equal(
        port_path(neg_cent, mask),
        mas_oracle(neg_cent, t_ys, t_xs).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_jax_scan(case):
    neg_cent, mask, _, _ = make_case(**CASES[case])
    want = maximum_path_scan(jnp.asarray(neg_cent), jnp.asarray(mask))
    np.testing.assert_array_equal(port_path(neg_cent, mask), np.asarray(want))


@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_pallas_kernel_interpreted(case):
    """The TPU kernel K2 replaces, run in Pallas interpret mode."""
    neg_cent, mask, _, _ = make_case(**CASES[case])
    want = maximum_path_pallas(jnp.asarray(neg_cent), jnp.asarray(mask),
                               interpret=True)
    np.testing.assert_array_equal(port_path(neg_cent, mask), np.asarray(want))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 16), b=st.integers(1, 4),
       t_text=st.integers(1, 12), extra=st.integers(0, 20),
       ragged=st.booleans(), ties=st.booleans())
def test_reference_equals_oracle_on_drawn_cases(seed, b, t_text, extra,
                                                ragged, ties):
    """Drawn shapes; with `ties` the scores are small integers, so equal
    candidates are common and the strict `<` tie rule decides."""
    neg_cent, mask, t_ys, t_xs = make_case(seed, b, t_text + extra, t_text,
                                           ragged)
    if ties:
        neg_cent = np.round(neg_cent / 3).astype(np.float32)
    np.testing.assert_array_equal(
        port_path(neg_cent, mask),
        mas_oracle(neg_cent, t_ys, t_xs).astype(np.float32))


def test_path_properties():
    """One text position per frame, durations sum to t_spec, monotonic from
    the first to the last position."""
    rng = np.random.default_rng(4)
    b, t_spec, t_text = 4, 50, 20
    neg_cent = rng.standard_normal((b, t_spec, t_text)).astype(np.float32)
    path = port_path(neg_cent, np.ones((b, t_spec, t_text), np.float32))
    assert (path.sum(-1) == 1).all()
    assert (path.sum(1).sum(-1) == t_spec).all()
    arg = path.argmax(-1)
    assert (np.diff(arg, axis=1) >= 0).all()
    assert (arg[:, 0] == 0).all() and (arg[:, -1] == t_text - 1).all()


def test_empty_mask_clamps_lengths_to_one():
    """An all-zero mask: lengths clamp to 1 as in the JAX package, and the
    final `* mask` leaves an all-zero path."""
    neg_cent = np.ones((2, 5, 3), np.float32)
    mask = np.zeros((2, 5, 3), np.float32)
    want = maximum_path_scan(jnp.asarray(neg_cent), jnp.asarray(mask))
    got = port_path(neg_cent, mask)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got.any()


def test_wrapper_on_cpu_runs_the_plain_version_without_grad():
    neg_cent, mask, _, _ = make_case(**CASES["ragged"])
    nc = torch.from_numpy(neg_cent).requires_grad_(True)
    before = maximum_path.launches
    got = maximum_path(nc, torch.from_numpy(mask))
    assert maximum_path.launches == before  # only kernel launches count
    assert not got.requires_grad and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), port_path(neg_cent, mask))


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(2, 5, 3), torch.zeros(2, 5, 4))
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(5, 3), torch.zeros(5, 3))

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
from wetts_tpu.ops.mas import maximum_path as jax_maximum_path
from wetts_tpu.ops.mas import maximum_path_scan
from wetts_tpu.ops.mas_pallas import maximum_path_pallas
from wetts_tpu_torch.ops.mas import (
    kernel_inputs,
    maximum_path,
    maximum_path_reference,
)

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


# What the fused wrapper takes besides f32 scores and an f32 mask: the plain
# version (its oracle) must take the same and agree with the JAX package.
INPUT_KINDS = ("bool", "holes", "bool_holes", "bf16", "non_contiguous")


def make_input_case(kind, seed=21, b=4, t_spec=48, t_text=19):
    """(torch scores, torch mask, numpy scores, numpy mask) from one numpy
    draw: the numpy pair is what the JAX side gets. Holes knock out a fifth
    of each valid corner but row 0 and column 0 (they set the lengths), so
    the -1e9 fill decides there."""
    neg_cent, mask, _, _ = make_case(seed, b, t_spec, t_text, ragged=True)
    if "holes" in kind:
        holes = np.random.default_rng(seed + 1).random(mask.shape) < 0.2
        holes[:, 0, :] = False
        holes[:, :, 0] = False
        mask = mask * ~holes
    nc_t, mask_t = torch.from_numpy(neg_cent), torch.from_numpy(mask)
    if "bool" in kind:
        mask_t = mask_t.bool()
    if kind == "bf16":
        nc_t = nc_t.bfloat16()
        neg_cent = nc_t.float().numpy()  # bf16 values, exact in f32
    if kind == "non_contiguous":
        nc_t = nc_t.transpose(1, 2).contiguous().transpose(1, 2)
        assert not nc_t.is_contiguous()
    return nc_t, mask_t, neg_cent, mask


@pytest.mark.parametrize("kind", INPUT_KINDS)
def test_reference_takes_wrapper_inputs_like_jax_maximum_path(kind):
    nc_t, mask_t, neg_cent, mask = make_input_case(kind)
    want = jax_maximum_path(jnp.asarray(neg_cent), jnp.asarray(mask))
    got = maximum_path_reference(nc_t, mask_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", INPUT_KINDS)
def test_reference_takes_wrapper_inputs_like_pallas_kernel(kind):
    """The same cases through the TPU kernel in interpret mode, given the
    JAX types (a bool mask as bool, bf16 scores as bf16)."""
    nc_t, mask_t, neg_cent, mask = make_input_case(kind, seed=31)
    nc_j = jnp.asarray(neg_cent)
    if kind == "bf16":
        nc_j = nc_j.astype(jnp.bfloat16)
    mask_j = jnp.asarray(mask.astype(bool) if "bool" in kind else mask)
    want = maximum_path_pallas(nc_j, mask_j, interpret=True)
    np.testing.assert_array_equal(
        maximum_path_reference(nc_t, mask_t).numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", INPUT_KINDS)
def test_wrapper_on_cpu_takes_wrapper_inputs(kind):
    nc_t, mask_t, _, _ = make_input_case(kind, seed=41)
    before = maximum_path.launches
    got = maximum_path(nc_t, mask_t)
    assert maximum_path.launches == before
    assert torch.equal(got, maximum_path_reference(nc_t.float().contiguous(),
                                                   mask_t.float()))


def test_holes_change_the_path():
    """The hole case is not vacuous: the fill moves the path off a hole."""
    nc_t, mask_t, _, _ = make_input_case("holes")
    _, full_mask, _, _ = make_input_case("full")
    with_holes = maximum_path_reference(nc_t, mask_t)
    without = maximum_path_reference(nc_t, full_mask)
    assert not torch.equal(with_holes, without)


@pytest.mark.parametrize("kind", ["f32", "bool", "bf16", "non_contiguous",
                                  "int_mask", "bool_offset"])
def test_kernel_inputs_copy_only_what_the_kernel_cannot_read(kind):
    """f32 contiguous scores and an f32 or bool mask (at any byte offset)
    reach the kernel as they are (no copy, so no launch on the card); other
    scores become f32 contiguous, other masks f32."""
    nc = torch.randn(2, 8, 5)
    mask = torch.ones(2, 8, 5)
    if kind == "bool":
        mask = mask.bool()
    if kind == "bf16":
        nc = nc.bfloat16()
    if kind == "non_contiguous":
        nc = nc.transpose(1, 2).contiguous().transpose(1, 2)
    if kind == "int_mask":
        mask = mask.int()
    if kind == "bool_offset":
        mask = torch.ones(81, dtype=torch.bool)[1:].view(2, 8, 5)
    got_nc, got_mask = kernel_inputs(nc, mask)
    assert got_nc.dtype == torch.float32 and got_nc.is_contiguous()
    assert torch.equal(got_nc, nc.float())
    assert (got_nc.data_ptr() == nc.data_ptr()) == (kind not in (
        "bf16", "non_contiguous"))
    assert got_mask.is_contiguous() and torch.equal(got_mask.float(),
                                                    mask.float())
    assert got_mask.dtype == (torch.bool if kind.startswith("bool")
                              else torch.float32)
    assert (got_mask.data_ptr() == mask.data_ptr()) == (kind != "int_mask")


# Shapes where K2's walk is easy to get wrong: ties (the strict `<`
# decides), an index that crosses a 32-column word inside a 32-row round,
# and the diagonal (t_spec == t_text: the index steps on every row). The
# card tests hold K2 to the plain version on the same shapes.
WALK_EDGES = [
    (51, 100, 17, False), (52, 150, 100, False), (53, 90, 70, True),
    (54, 33, 33, True), (55, 1, 1, False), (56, 200, 5, True),
    (57, 65, 65, False),
]


@pytest.mark.parametrize("seed,t_spec,t_text,ties", WALK_EDGES)
def test_reference_equals_jax_maximum_path_on_walk_edges(seed, t_spec, t_text,
                                                         ties):
    neg_cent, mask, _, _ = make_case(seed, 1, t_spec, t_text, ragged=False)
    if ties:
        neg_cent = np.round(neg_cent / 3).astype(np.float32)
    want = jax_maximum_path(jnp.asarray(neg_cent), jnp.asarray(mask))
    np.testing.assert_array_equal(port_path(neg_cent, mask), np.asarray(want))

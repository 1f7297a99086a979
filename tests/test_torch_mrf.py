"""K1's module: the port's `mrf_stage` (on the CPU, its plain version) held
against the Pallas kernel it replaces and against the eager JAX ResBlocks.

Tolerance atol 2e-4 / rtol 1e-4, as tests/test_mrf_pallas.py: f32 on both
sides, with sums taken in another order (block-Toeplitz products on the
Pallas side, direct convolutions here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import randomize
from wetts_tpu.models.hifigan import Generator, ResBlock1, ResBlock2
from wetts_tpu.models.mrf_pallas import mrf_stage_pallas
from wetts_tpu_torch.models import hifigan as port_hifigan
from wetts_tpu_torch.models.mrf import mrf_stage, mrf_stage_reference
from wetts_tpu_torch.utils.convert import FlaxToTorch

TOPOLOGIES = [  # tests/test_mrf_pallas.py:37-41
    ("1", (3, 7, 11), ((1, 3, 5),) * 3, 32, 4),   # reference v1 tail stage
    ("1", (3, 7), ((1, 3, 5),) * 2, 64, 2),
    ("2", (3, 5), ((1, 2), (2, 6)), 32, 4),       # v3 topology
]
TB = 700  # blocks; not a multiple of the Pallas kernel's TILE


def _stage(resblock, kernel_sizes, dilations, ch, seed=0):
    """Randomized JAX params of one stage, and the port's folded convs."""
    g = Generator(
        initial_channel=ch * 2, resblock=resblock,
        resblock_kernel_sizes=kernel_sizes,
        resblock_dilation_sizes=dilations,
        upsample_rates=(2,), upsample_initial_channel=ch * 2,
        upsample_kernel_sizes=(4,), gin_channels=8)
    params = g.init({"params": jax.random.PRNGKey(seed)},
                    jnp.zeros((1, 8, ch * 2)), jnp.zeros((1, 1, 8)))["params"]
    params = randomize(jax.device_get(params), seed + 1)
    jax_stage = [params[f"resblock_0_{j}"] for j in range(len(kernel_sizes))]
    res_cls = (port_hifigan.ResBlock1 if resblock == "1"
               else port_hifigan.ResBlock2)
    port_stage = []
    for p, k, dils in zip(jax_stage, kernel_sizes, dilations):
        block = res_cls(ch, k, dils)
        m = FlaxToTorch(p)
        for i in range(len(dils)):
            if resblock == "1":
                m.conv((f"conv1_{i}",), f"convs1.{i}")
                m.conv((f"conv2_{i}",), f"convs2.{i}")
            else:
                m.conv((f"conv_{i}",), f"convs.{i}")
        block.load_state_dict(m.state)
        port_stage.append(block.folded_convs())
    return jax_stage, port_stage


@pytest.mark.parametrize("resblock,kernel_sizes,dilations,ch,r", TOPOLOGIES)
def test_mrf_stage_matches_pallas(resblock, kernel_sizes, dilations, ch, r):
    jax_stage, port_stage = _stage(resblock, kernel_sizes, dilations, ch)
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, TB * r, ch)).astype(np.float32)

    want = mrf_stage_pallas(jnp.asarray(h.reshape(2, TB, r * ch)), jax_stage,
                            resblock, kernel_sizes, dilations, r,
                            interpret=True)
    with torch.no_grad():
        got = mrf_stage(torch.from_numpy(h), port_stage, resblock,
                        kernel_sizes, dilations)
    assert got.shape == h.shape
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).reshape(h.shape), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("resblock,kernel_sizes,dilations,ch,r", TOPOLOGIES)
def test_mrf_stage_matches_eager_resblocks(resblock, kernel_sizes, dilations,
                                           ch, r):
    """At r = 1: the mean of the JAX ResBlock modules' outputs."""
    jax_stage, port_stage = _stage(resblock, kernel_sizes, dilations, ch,
                                   seed=3)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, TB, ch)).astype(np.float32)
    res_cls = ResBlock1 if resblock == "1" else ResBlock2
    want = sum(res_cls(ch, k, tuple(d)).apply({"params": p}, jnp.asarray(h))
               for p, k, d in zip(jax_stage, kernel_sizes, dilations))
    want = np.asarray(want) / len(kernel_sizes)
    with torch.no_grad():
        got = mrf_stage(torch.from_numpy(h), port_stage, resblock,
                        kernel_sizes, dilations)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


def test_mrf_stage_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    _, port_stage = _stage("2", (3,), ((1, 3),), 8)
    h = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, 50, 8)).astype(
            np.float32))
    before = mrf_stage.launches
    with torch.no_grad():
        got = mrf_stage(h, port_stage, "2", (3,), ((1, 3),))
        want = mrf_stage_reference(h, port_stage, "2", (3,), ((1, 3),))
    assert torch.equal(got, want)
    assert mrf_stage.launches == before


def test_mrf_stage_rejects_a_wrong_topology():
    _, port_stage = _stage("1", (3,), ((1, 3),), 8)
    h = torch.zeros(1, 20, 8)
    with pytest.raises(ValueError):
        mrf_stage(h, port_stage, "2", (3,), ((1, 3),))
    with pytest.raises(ValueError):
        mrf_stage(h[..., :4], port_stage, "1", (3,), ((1, 3),))

"""Kernel K1 on the card: the CUDA MRF kernel against its plain PyTorch
version at VITS-base stage shapes, and the port's synthesis on the GPU
against the CPU.

Needs an NVIDIA GPU with nvcc; skips elsewhere (a CUDA kernel has no CPU
mode). Imports nothing of JAX, so on a machine without JAX run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

f32 on both sides with TF32 off (cuDNN would otherwise run the plain
version's convolutions in TF32).
"""

import pytest
import torch

from chip_smoke import random_init_
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.mrf import mrf_stage, mrf_stage_reference
from wetts_tpu_torch.models.synthesizer import Synthesizer

pytestmark = pytest.mark.cuda

KERNEL_SIZES, DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3  # v1 resblocks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the MRF kernel has no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        saved


def _stage(c, kind, gen):
    convs_per_d = 2 if kind == "1" else 1
    return [[(torch.randn(c, c, k, generator=gen) / (c * k) ** 0.5,
              torch.randn(c, generator=gen) * 0.1)
             for _ in range(len(d) * convs_per_d)]
            for k, d in zip(KERNEL_SIZES, DILATIONS)]


@pytest.mark.parametrize("c,t", [(256, 768), (128, 6144), (64, 12288),
                                 (32, 24576)])
@pytest.mark.parametrize("kind", ["1", "2"])
def test_mrf_kernel_matches_plain(cuda, c, t, kind):
    """v1 stage widths at a 96-frame bucket, batch 2; max |kernel - plain|
    <= 1e-4 * max(1, max |plain|): f32 sums of up to C*k products taken in
    another order."""
    gen = torch.Generator().manual_seed(c)
    stage = [[(w.to(cuda), b.to(cuda)) for w, b in br]
             for br in _stage(c, kind, gen)]
    h = torch.randn(2, t, c, generator=gen).to(cuda)
    before = mrf_stage.launches
    got = mrf_stage(h, stage, kind, KERNEL_SIZES, DILATIONS)
    torch.cuda.synchronize()
    assert mrf_stage.launches - before == 9 * (2 if kind == "1" else 1)
    want = mrf_stage_reference(h, stage, kind, KERNEL_SIZES, DILATIONS)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale


def test_mrf_kernel_refuses_what_it_cannot_run(cuda):
    gen = torch.Generator().manual_seed(0)
    stage = [[(w.to(cuda), b.to(cuda)) for w, b in br]
             for br in _stage(6, "2", gen)]
    with pytest.raises(ValueError):  # C % 4 != 0
        mrf_stage(torch.zeros(1, 40, 6, device=cuda), stage, "2",
                  KERNEL_SIZES, DILATIONS)
    with pytest.raises(ValueError):  # not f32
        mrf_stage(torch.zeros(1, 40, 6, device=cuda, dtype=torch.float16),
                  stage, "2", KERNEL_SIZES, DILATIONS)
    stage = [[(torch.zeros(8, 8, 13, device=cuda),
               torch.zeros(8, device=cuda))]]
    with pytest.raises(ValueError):  # no kernel instance for 13 taps
        mrf_stage(torch.zeros(1, 40, 8, device=cuda), stage, "2", (13,),
                  ((1,),))


def test_infer_on_gpu_matches_cpu(cuda):
    """Synthesizer.infer through the kernel on the GPU against the plain
    path on the CPU, small config, scales (0, 1, 0); atol 2e-4."""
    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 32, "hidden_channels": 32,
                  "filter_channels": 64, "n_layers": 2,
                  "resblock_kernel_sizes": [3, 5],
                  "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 64,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 16},
        "num_phones": 24, "num_speakers": 3})
    model = random_init_(Synthesizer(cfg), 0).eval()
    x = torch.tensor([[3, 5, 7, 1, 2, 9, 11, 4], [6, 2, 8, 8, 1, 0, 0, 0]])
    xl, sid = torch.tensor([8, 5]), torch.tensor([0, 2])
    with torch.inference_mode():
        want, want_len, _ = model.infer(x, xl, sid, 0.0, 1.0, 0.0, 80)
        model.to(cuda)
        before = mrf_stage.launches
        got, got_len, _ = model.infer(x.to(cuda), xl.to(cuda),
                                      sid.to(cuda), 0.0, 1.0, 0.0, 80)
    assert mrf_stage.launches - before == 2 * 2 * 6
    assert torch.equal(got_len.cpu(), want_len)
    assert (got.cpu() - want).abs().max().item() <= 2e-4

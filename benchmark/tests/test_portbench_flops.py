"""The benchmark's arithmetic of work (benchmark/flops.py), which `mfu` and
`k1_roofline.*` divide by, against torch.utils.flop_counter.FlopCounterMode
over the reference's modules at small widths on the CPU, and against hand
counts of one MRF stage.

FlopCounterMode counts the convolutions and products as executed; the
benchmark counts the algorithm's work. They agree wherever the two are the
same: the reference computes 2n - 1 relative positions for n phones, of
which the window's 2w + 1 = 9 are nonzero, so the two agree at n = 5; and
the prior's expansion (a product with a 0/1 path, the algorithm's gather)
is outside the modules counted here.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.system import build_reference, make_weights
from benchmark.tests.tiny import tiny_config


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return counter.get_total_flops()


def model_for(name):
    cfg = tiny_config(name)
    ref = build_reference(cfg, "cpu")
    ref.load_state_dict(make_weights(
        {k: v.shape for k, v in ref.state_dict().items()}, 1, "cpu"))
    return cfg, ref


@pytest.mark.parametrize("name", ["vits_v1", "vits2_vocos_v1"])
@pytest.mark.parametrize("frames", [7, 40])
def test_decoder(name, frames):
    cfg, ref = model_for(name)
    m = cfg["model"]
    z = torch.randn(1, m["inter_channels"], frames)
    g = ref.speaker(torch.tensor([1]))
    assert counted(lambda: ref.decode(z, g)) == flops.decoder(m, frames)


@pytest.mark.parametrize("name", ["vits_v1", "vits2_vocos_v1"])
@pytest.mark.parametrize("frames", [9, 33])
def test_flow(name, frames):
    cfg, ref = model_for(name)
    m = cfg["model"]
    z = torch.randn(1, m["inter_channels"], frames)
    mask = torch.ones(1, 1, frames)
    g = ref.speaker(torch.tensor([0]))
    assert counted(lambda: ref.flow_reverse(z, mask, g)) == (
        flops.flow_reverse(m, frames))


@pytest.mark.parametrize("name", ["vits_v1", "vits2_vocos_v1"])
def test_text_side(name):
    """Text encoder and duration predictor at n = 5 phones, where the
    2n - 1 relative positions are the window's 2w + 1."""
    cfg, ref = model_for(name)
    m = cfg["model"]
    n = 5
    x = torch.randint(1, cfg["num_phones"], (1, n))
    lengths = torch.tensor([n])
    g = ref.speaker(torch.tensor([0]))

    def text():
        h, _, _, x_mask = ref.enc_p(x, lengths)
        ref.dp(h, x_mask, g, 0.8, torch.Generator().manual_seed(0))

    want = (flops.encoder(m["hidden_channels"], m["filter_channels"],
                          m["n_layers"], m["kernel_size"], n, 4)
            + flops.conv(m["hidden_channels"], 2 * m["inter_channels"], 1, n)
            + flops.duration_reverse(m["hidden_channels"], m["gin_channels"],
                                     n))
    assert counted(text) == want


def test_request_is_the_sum_of_its_parts():
    cfg = tiny_config("vits_v1")
    m = cfg["model"]
    n, t = 30, 170
    text = (flops.encoder(m["hidden_channels"], m["filter_channels"],
                          m["n_layers"], m["kernel_size"], n, 4)
            + flops.conv(m["hidden_channels"], 2 * m["inter_channels"], 1, n)
            + flops.duration_reverse(m["hidden_channels"],
                                     m["gin_channels"], n))
    assert flops.request_flops(cfg, n, t) == (
        text + flops.flow_reverse(m, t) + flops.decoder(m, t))


def test_mrf_stage_by_hand():
    """One stage of one branch of kernel 3, dilations (1, 3): four convs of
    three taps: 2 * C * C * 12 per sample; the input and output once, twelve
    taps of C x C weights and four biases."""
    ops, nbytes = flops.mrf_stage_cost(2, 100, 4, [3], [[1, 3]])
    assert ops == 2 * 4 * 4 * 12 * 2 * 100
    assert nbytes == 4 * 2 * 2 * 100 * 4 + 4 * 4 * 4 * 12 + 4 * 4 * 4


def test_mrf_stage_against_counter():
    """The published v1 stage's work, at C = 8, against the counter over the
    reference's three ResBlock1 branches."""
    from benchmark.reference.vits import ResBlock1

    m = tiny_config("vits_v1")["model"]
    m = dict(m, resblock_kernel_sizes=[3, 7, 11],
             resblock_dilation_sizes=[[1, 3, 5]] * 3)
    blocks = [ResBlock1(8, k, d) for k, d in zip(
        m["resblock_kernel_sizes"], m["resblock_dilation_sizes"])]
    for b in blocks:
        for p in b.parameters():
            torch.nn.init.uniform_(p, 0.5, 1.0)
    x = torch.randn(3, 8, 50)
    ops, _ = flops.mrf_stage_cost(3, 50, 8, m["resblock_kernel_sizes"],
                                  m["resblock_dilation_sizes"])
    assert counted(lambda: [b(x) for b in blocks]) == ops
    assert flops.mrf_taps(m) == 2 * 3 * (3 + 7 + 11)


def test_published_decoder_per_frame():
    """VITS-base's HiFi-GAN needs about 6.1e8 FLOPs per latent frame, its
    MRF stages 5.9e8 of them."""
    from benchmark.system import load_config

    m = load_config("vits_v1")["model"]
    per_frame = flops.decoder(m, 1000) / 1000
    assert 6.0e8 < per_frame < 6.3e8
    ops, _ = flops.decoder_mrf_cost(m, 1, 1000)
    assert 5.8e8 < ops / 1000 < 6.0e8

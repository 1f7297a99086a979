"""Probe: the Vocos decoder's backbone on this GPU, on its module path
(cuDNN f32 convs, TF32 off) and on the hand-written kernels of
`csrc/vocos_backbone.cu` (`models/vocos_backbone.py`). The quick loop for
work on that source.

At vits2_vocos_v1.json's widths (192 -> 512 channels, 8 ConvNeXt layers of
1536, 1026 out, a speaker vector of 256), seeded random weights, rows x
latent frames of 8 x 1152 (the batch cell's most common decode: the
backbone runs over 1153 frames) and 8 x 704:
- the backbone on both paths: device ms (launches queued behind a sleep),
  the host's us to issue the kernels' chain, the f32-equivalent TFLOP/s of
  its 1x1 convs, and the kernels' share of
  their bound, the backbone's operations at 165 TFLOP/s (3 TF32 products
  per f32 product at 495);
- the kernels' output against the module path's, as the largest gap over
  the largest magnitude, beside the same for the module path under TF32
  (a single TF32 pass: the control the split has to beat);
- each GEMM of the chain and the row kernel alone: device ms, TFLOP/s or
  GB/s, and the launches of one backbone.
Prints the card's name and power limit, ptxas's register report and one
JSON line per shape.

    python -m wetts_tpu_torch.tools.probe_vocos

Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import json
import subprocess

import torch

from wetts_tpu_torch.models import vocos_backbone as vb
from wetts_tpu_torch.models.vocos import VocosGenerator
from wetts_tpu_torch.utils import cuda_build
from wetts_tpu_torch.utils.profiling import device_ms, host_us

WIDTHS = dict(in_channels=192, channels=512, h_channels=1536,
              out_channels=1026, num_layers=8, gin_channels=256)
SHAPES = ((8, 1152), (8, 704))  # (rows, latent frames)
SPLIT_TF32_FLOPS = 495e12 / 3


def random_decoder(seed: int = 0) -> VocosGenerator:
    """The published widths with U(-1/sqrt(fan_in), +) weights, LayerNorm
    gains 1 and shifts 0, on the card."""
    dec = VocosGenerator(**WIDTHS)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "beta"):
                continue
            fan_in = p.numel() // p.shape[0] if p.ndim > 1 else p.numel()
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                    * fan_in ** -0.5)
    return dec.cuda().eval()


def backbone_flops(rows: int, t1: int) -> float:
    w = WIDTHS
    c, h = w["channels"], w["h_channels"]
    per_frame = (w["in_channels"] * c + w["num_layers"] * 2 * c * h
                 + c * w["out_channels"])
    return 2.0 * rows * t1 * per_frame


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@torch.inference_mode()
def probe_shape(dec: VocosGenerator, rows: int, frames: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(rows * frames)
    z = torch.randn(rows, frames, WIDTHS["in_channels"], device="cuda",
                    generator=gen)
    g = torch.randn(rows, WIDTHS["gin_channels"], 1, device="cuda",
                    generator=gen)
    x = z.transpose(1, 2)
    t1 = frames + 1
    flops = backbone_flops(rows, t1)
    want = dec.backbone_modules(x, g).transpose(1, 2)
    got = vb.backbone(dec, x, g)
    torch.backends.cudnn.allow_tf32 = True
    tf32 = dec.backbone_modules(x, g).transpose(1, 2)
    torch.backends.cudnn.allow_tf32 = False
    launches = (vb.gemm.launches, vb.rownorm.launches)
    vb.backbone(dec, x, g)
    launches = (vb.gemm.launches - launches[0],
                vb.rownorm.launches - launches[1])
    module_ms = device_ms(lambda: dec.backbone_modules(x, g), 5)
    fused_ms = device_ms(lambda: vb.backbone(dec, x, g), 20)
    fused_host_us = host_us(lambda: vb.backbone(dec, x, g), 20)
    row = {"rows": rows, "frames": frames, "gflop": flops / 1e9,
           "module_ms": module_ms, "fused_ms": fused_ms,
           "fused_host_us": fused_host_us,
           "module_tflops": flops / module_ms / 1e9,
           "fused_tflops": flops / fused_ms / 1e9,
           "bound_ms": flops / SPLIT_TF32_FLOPS * 1e3,
           "fused_share_of_bound": flops / SPLIT_TF32_FLOPS * 1e3 / fused_ms,
           "rel_gap": rel_gap(got, want), "rel_gap_tf32": rel_gap(tf32, want),
           "gemm_launches": launches[0], "rownorm_launches": launches[1]}
    # each GEMM of the chain and the row kernel alone
    m = rows * t1
    packed = dec.packed_weights()
    layer = dec.layers[0]
    a512 = torch.randn(m, 512, device="cuda", generator=gen)
    a1536 = torch.randn(m, 1536, device="cuda", generator=gen)
    a192 = torch.randn(m, 192, device="cuda", generator=gen)
    res = torch.randn(m, 512, device="cuda", generator=gen)
    cond = torch.randn(rows, 512, device="cuda", generator=gen)
    gemms = {
        "in_conv": (a192, dec.in_conv, packed[0], vb.BIAS, cond, None),
        "pw_conv1": (a512, layer.pw_conv1, packed[1], vb.GELU, None, None),
        "pw_conv2": (a1536, layer.pw_conv2, packed[2], vb.RESIDUAL,
                     layer.scale, res),
        "out_conv": (a512, dec.out_conv, packed[-1], vb.BIAS, None, None)}
    for name, (a, conv, pk, mode, aux, out) in gemms.items():
        w = conv.weight[:, :, 0]
        ms = device_ms(lambda: vb.gemm(a, w, pk, conv.bias, mode, aux, t1,
                                       out), 20)
        want = a @ w.T + conv.bias
        got = vb.gemm(a, w, pk, conv.bias, vb.BIAS)
        row[f"{name}_ms"] = ms
        row[f"{name}_tflops"] = 2.0 * m * w.shape[0] * w.shape[1] / ms / 1e9
        row[f"{name}_rel_gap"] = rel_gap(got, want)
    ms = device_ms(lambda: vb.rownorm(a512, t1, layer.norm, layer.dw_conv),
                   50)
    row["rownorm_ms"] = ms
    row["rownorm_gbps"] = 2 * 4 * m * 512 / ms / 1e6
    return row


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    cuda_build.build("vocos_backbone")
    print("\n".join(line for line in
                    cuda_build.compiler_log("vocos_backbone").splitlines()
                    if "registers" in line or "spill" in line))
    dec = random_decoder()
    for rows, frames in SHAPES:
        print(json.dumps(probe_shape(dec, rows, frames)), flush=True)


if __name__ == "__main__":
    main()

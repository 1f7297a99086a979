"""Probe of Q2, the int8 upsample (`csrc/int8_mrf_conv.cu`,
`int8_conv_transpose1d`), and Q0, the row scale (`csrc/int8_conv.cu`).

    python -m wetts_tpu_torch.tools.probe_q2 [--config CONFIG]

At the four upsamples of a model config (`examples/baker/configs/v1.json` by
default: batch 4 at the 352-frame decode bucket, bf16, seeded random
weights, one quiet batch row), per upsample:
- `device_ms`: the kernel with the decoder's scale work (the first
  upsample after its Q0 launch, the others finishing the abs-max the stage
  before took; each taking its output's abs-max), `conv_device_ms` the
  kernel given a finished scale, `library_device_ms` one
  `F.conv_transpose1d` in bf16 (a yardstick the port never calls): device
  time between CUDA events with the launches queued behind a sleep on the
  stream, so that the host's time to launch them is hidden;
- `host_us`, `library_host_us`: the host's time to make one call;
- `ms`, `library_ms`: back to back, as `chip_smoke.py` times them (the
  larger of the device's and the host's time per call).
And Q0 alone at conv_pre's output shape, and the host's time for the
parts of a wrapper call (`host_parts_us`). One JSON line; needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.nn.functional as F

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models import quant
from wetts_tpu_torch.models.layers import LRELU_SLOPE
from wetts_tpu_torch.models.quant import (
    QuantConvTranspose1d,
    int8_conv_transpose1d,
    int8_conv_transpose1d_reference,
    row_scale,
    upsample_scale_per_phase,
)
from wetts_tpu_torch.utils.profiling import cuda_ms, device_ms, host_us

BATCH, FRAME_BUCKET, SEED = 4, 352, 1234
REPS = 50
V1_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "examples", "baker", "configs", "v1.json")


@torch.no_grad()
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=V1_CONFIG)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_q2 needs a CUDA device")
    gen_cfg = Config.from_json(args.config).model
    initial = gen_cfg.upsample_initial_channel
    rates, kernels = gen_cfg.upsample_rates, gen_cfg.upsample_kernel_sizes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    per_phase = upsample_scale_per_phase(initial, rates, FRAME_BUCKET)
    rows = []
    t_in = FRAME_BUCKET
    x0 = None
    for i, (u, k) in enumerate(zip(rates, kernels)):
        c_in, c_out = initial // 2 ** i, initial // 2 ** (i + 1)
        w = torch.randn(c_in, c_out, k, device="cuda", generator=gen) / (
            c_in * k / u) ** 0.5
        bias = 0.1 * torch.randn(c_out, device="cuda", generator=gen)
        up = QuantConvTranspose1d(w, bias, u, (k - u) // 2, per_phase[i],
                                  torch.bfloat16)
        x = torch.randn(BATCH, t_in, c_in, device="cuda",
                        generator=gen).to(torch.bfloat16)
        x[1] *= 0.01
        x0 = x if x0 is None else x0
        x_amax = F.leaky_relu(x, LRELU_SLOPE).abs().amax(dim=(1, 2)).float()
        sx = row_scale(x, LRELU_SLOPE)
        amax = torch.zeros(BATCH, device="cuda")
        got = int8_conv_transpose1d(x, up, LRELU_SLOPE, x_amax=x_amax)
        want = int8_conv_transpose1d_reference(x, up, LRELU_SLOPE)
        err = (got.float() - want.float()).abs().max().item()
        w_f = w.to(torch.bfloat16)
        xt = x.transpose(1, 2).contiguous()

        def kernel(first=i == 0):
            if first:
                int8_conv_transpose1d(x, up, LRELU_SLOPE,
                                      sx=row_scale(x, LRELU_SLOPE),
                                      amax_out=amax)
            else:
                int8_conv_transpose1d(x, up, LRELU_SLOPE, x_amax=x_amax,
                                      amax_out=amax)

        def conv():
            int8_conv_transpose1d(x, up, LRELU_SLOPE, sx=sx)

        def library():
            F.conv_transpose1d(xt, w_f, stride=u, padding=(k - u) // 2)

        rows.append({
            "stage": i, "T_in": t_in, "C_in": c_in, "C_out": c_out, "u": u,
            "k": k, "max_abs_err": err,
            "device_ms": device_ms(kernel),
            "conv_device_ms": device_ms(conv),
            "library_device_ms": device_ms(library),
            "host_us": host_us(kernel), "conv_host_us": host_us(conv),
            "library_host_us": host_us(library),
            "ms": cuda_ms(kernel, REPS),
            "library_ms": cuda_ms(library, REPS)})
        t_in = up.out_length(t_in)
    host_parts = {
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(x0.device).cuda_stream),
        "empty_out": host_us(lambda: torch.empty(
            BATCH, FRAME_BUCKET * rates[0], initial // 2, device="cuda",
            dtype=torch.bfloat16)),
        "check_input": host_us(lambda: quant._check_cuda_input(
            x0, None, "probe")),
        "row_scale": host_us(lambda: row_scale(x0, LRELU_SLOPE))}
    q0 = {"shape": list(x0.shape),
          "device_ms": device_ms(lambda: row_scale(x0, LRELU_SLOPE)),
          "host_us": host_us(lambda: row_scale(x0, LRELU_SLOPE)),
          "ms": cuda_ms(lambda: row_scale(x0, LRELU_SLOPE), REPS)}
    total = {key: sum(r[key] for r in rows)
             for key in ("device_ms", "conv_device_ms", "library_device_ms",
                         "ms", "library_ms")}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "upsamples": rows, "q0": q0, "total": total,
                      "host_parts_us": host_parts}))


if __name__ == "__main__":
    main()

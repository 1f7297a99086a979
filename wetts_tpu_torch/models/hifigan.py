"""HiFi-GAN waveform decoder (port of wetts_tpu/models/hifigan.py; reference
wetts/vits/model/decoders.py:15-218).

conv_pre(7) [+ cond(g)] -> per upsample stage: leaky_relu(0.1) ->
weight-normed ConvTranspose upsample -> MRF stage (the mean of the resblock
branches) -> leaky_relu(0.01, torch's default, decoders.py:78) ->
conv_post(7, no bias) -> tanh.

The MRF stages take one of two routes, chosen by whether a gradient is
wanted and by nothing else (never by whether the kernel built or launched):

- inference (eval mode and autograd not recording into the decoder): the
  decoder runs on its weights at the call's precision (`form`), and every
  stage goes through `mrf.mrf_stage`, which launches kernel K1 on the GPU
  with the stage's weights packed into the layout the kernel streams; under
  `torch.export` each stage is one node of the operator `mrf.mrf_stage_op`,
  whose GPU kernel is the same launcher;
- training (`train()` mode, or autograd recording with an input or parameter
  that requires grad): every stage runs `mrf.mrf_stage_reference`, the
  differentiable F.conv1d chain, on kernels computed from
  `weight_g`/`weight_v`. K1 has no backward, as the Pallas kernel it replaces
  has no VJP and the JAX package pins its differentiable path on the
  training route.

conv_pre, cond, the upsample convs and conv_post lay outside any Pallas
kernel in the JAX package and stay F.conv1d / F.conv_transpose1d.

Inference runs at one of three precisions (`forward(..., precision=)`, the
`dtype` / `quantize` arguments of wetts_tpu/models/hifigan_fast.py:209-323),
which is an argument of the call and no config knob:

- "f32": the folded weights as they are;
- "bf16": weight norm is folded in f32 and the folded kernels are cast;
  every conv runs in bf16, the MRF stages through K1's bf16 instance; the
  output is cast back to f32;
- "int8": as "bf16", but the upsample convs and every MRF conv are int8 with
  dynamic activation scales (`models/quant.py`); conv_pre, cond and
  conv_post stay in bf16. One `row_scale` of conv_pre's output is the only
  pass that finds a scale: every later one is the abs-max that the conv
  storing the input took in its epilogue.

The weights at each precision are derived from the folded buffers and kept
by the rule of `layers.DerivedWeights`. Asking for a reduced precision where
a gradient is wanted raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wetts_tpu_torch.models.layers import (
    LRELU_SLOPE,
    Conv1d,
    ConvTranspose1d,
    DerivedWeights,
    WeightNormed,
    get_padding,
)
from wetts_tpu_torch.models.mrf import (
    Branch,
    check_stage,
    mrf_stage,
    mrf_stage_as_op,
    mrf_stage_int8,
    mrf_stage_reference,
    pack_stage,
    quantize_stage,
)
from wetts_tpu_torch.models.quant import (
    QuantConvTranspose1d,
    int8_conv_transpose1d,
    row_scale,
    upsample_scale_per_phase,
)
from wetts_tpu_torch.utils.profiling import StageTimes


class _Form:
    """The decoder's inference weights at one precision from the folded f32
    tensors, (weight, bias) pairs in `dtype`, the glue's type ("f32" keeps
    the tensors themselves). "f32" and "bf16" hold every conv's, the MRF
    stages checked and, on a card, in K1's layout (`packed`); "int8" holds
    quantised MRF stages and, made at first use, each upsample's kernel
    with per-channel or per-phase scales."""

    def __init__(self, gen: "Generator", precision: str,
                 dtype: torch.dtype):
        def cast(conv):
            return (conv.weight.to(dtype),
                    None if conv.bias is None else conv.bias.to(dtype))

        self.precision, self.dtype = precision, dtype
        self.conv_pre = cast(gen.conv_pre)
        self.cond = cast(gen.cond) if hasattr(gen, "cond") else None
        self.conv_post = cast(gen.conv_post)
        stages = [gen.stage_convs(i) for i in range(len(gen.ups))]
        if precision == "int8":
            self.stages = [quantize_stage(stage, dtype) for stage in stages]
            self.ups: Dict = {}
        else:
            self.stages = [[[(w.to(dtype), b.to(dtype)) for w, b in convs]
                            for convs in stage] for stage in stages]
            for stage in self.stages:
                check_stage(stage, gen.resblock, gen.kernel_sizes,
                            gen.dilations)
            self.packed = [pack_stage(stage) if stage[0][0][0].is_cuda
                           else None for stage in self.stages]
            self.ups = {i: cast(up) for i, up in enumerate(gen.ups)}

    def quantized_up(self, gen: "Generator", i: int, per_phase: bool
                     ) -> QuantConvTranspose1d:
        if (i, per_phase) not in self.ups:
            up = gen.ups[i]
            self.ups[i, per_phase] = QuantConvTranspose1d(
                up.weight.detach(), up.bias.detach(), up.stride, up.padding,
                per_phase, self.dtype)
        return self.ups[i, per_phase]


class ResBlock1(nn.Module):
    """Parameters of one ResBlock1 branch: per dilation d, a dilated conv
    (convs1) and a plain conv (convs2), weight-normed."""

    def __init__(self, channels: int, kernel_size: int,
                 dilation: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilation])
        self.convs2 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size,
                   padding=get_padding(kernel_size, 1), weight_norm=True)
            for _ in dilation])

    def folded_convs(self) -> Branch:
        out = []
        for c1, c2 in zip(self.convs1, self.convs2):
            out += [(c1.weight, c1.bias), (c2.weight, c2.bias)]
        return out

    def live_convs(self) -> Branch:
        out = []
        for c1, c2 in zip(self.convs1, self.convs2):
            out += [(c1.kernel(), c1.bias), (c2.kernel(), c2.bias)]
        return out


class ResBlock2(nn.Module):
    """Parameters of one ResBlock2 branch: one dilated conv per dilation."""

    def __init__(self, channels: int, kernel_size: int,
                 dilation: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilation])

    def folded_convs(self) -> Branch:
        return [(c.weight, c.bias) for c in self.convs]

    def live_convs(self) -> Branch:
        return [(c.kernel(), c.bias) for c in self.convs]


class Generator(DerivedWeights):
    """Latent [B, C_inter, T] -> waveform [B, 1, T * prod(upsample_rates)]."""

    precisions = ("f32", "bf16", "int8")

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int],
                 upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int],
                 gin_channels: int = 0):
        super().__init__()
        self.resblock = resblock
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_initial_channel = upsample_initial_channel
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3)
        if gin_channels != 0:
            self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for u, k in zip(upsample_rates, upsample_kernel_sizes):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, u,
                                            padding=(k - u) // 2,
                                            weight_norm=True))
            ch //= 2
            for rk, rd in zip(self.kernel_sizes, self.dilations):
                self.resblocks.append(res_cls(ch, rk, rd))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def stage_convs(self, i: int) -> List[Branch]:
        """Stage i's folded (weight, bias) pairs, one list per branch."""
        n = len(self.kernel_sizes)
        return [rb.folded_convs() for rb in self.resblocks[i * n:(i + 1) * n]]

    def _check(self, precision: str) -> None:
        if precision not in self.precisions:
            raise ValueError(f"precision must be one of {self.precisions}, "
                             f"got {precision!r}")

    def form(self, precision: str) -> _Form:
        """The inference weights at `precision` (`DerivedWeights`' rule),
        derived from every conv's folded weight and bias."""
        self._check(precision)
        dtype = torch.float32 if precision == "f32" else torch.bfloat16
        return self.derived(
            precision, lambda: [(m, n) for m in self.modules()
                                if isinstance(m, WeightNormed)
                                for n in ("weight", "bias")
                                if getattr(m, n) is not None],
            lambda: _Form(self, precision, dtype))

    prepare = form

    def gradient_wanted(self, *inputs: Optional[torch.Tensor]) -> bool:
        """Whether the decoder must be differentiable for this call: in
        train() mode (where the folded buffers may be stale), or when
        autograd is recording and an input or a parameter requires grad."""
        return self.training or (torch.is_grad_enabled() and (
            any(t is not None and t.requires_grad for t in inputs)
            or any(p.requires_grad for p in self.parameters())))

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None,
                precision: str = "f32",
                stages: Optional[StageTimes] = None) -> torch.Tensor:
        """x [B, C, T] latent, g [B, gin, 1] or None -> [B, 1, T * hop] in
        f32. `stages` (the decoders' common call) gets no stage of its own."""
        if not self.gradient_wanted(x, g):
            return self.infer(x, g, self.form(precision))
        if precision != "f32":
            self._check(precision)
            raise RuntimeError(
                f"the {precision} decoder is an inference route and has "
                "no backward: call eval() and run under torch.no_grad()")
        x = self.conv_pre(x)
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g)
        n = len(self.kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            stage = [rb.live_convs()
                     for rb in self.resblocks[i * n:(i + 1) * n]]
            x = mrf_stage_reference(
                x.transpose(1, 2), stage, self.resblock,
                self.kernel_sizes, self.dilations).transpose(1, 2)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)

    def infer(self, x: torch.Tensor, g: Optional[torch.Tensor],
              form: _Form) -> torch.Tensor:
        """The inference route on `form`'s weights (the tests also run an
        int8 form with f32 glue, to hold its arithmetic against the JAX
        package's closely). Returns f32."""
        x = F.conv1d(x.to(form.dtype), *form.conv_pre, padding=3)
        if g is not None and form.cond is not None:
            x = x + F.conv1d(g.to(form.dtype), *form.cond)
        if form.precision == "int8":
            per_phase = upsample_scale_per_phase(
                self.upsample_initial_channel, self.upsample_rates,
                x.shape[2])
            h = x.transpose(1, 2).contiguous()  # [B, T, C] from here on
            # one row scale, of conv_pre's output; every later scale is an
            # abs-max that the conv storing the input took in its epilogue:
            # each upsample's for its stage, each stage's last conv's for
            # the next upsample (rows of one zeroed buffer)
            n = len(form.stages)
            amax = torch.zeros(2 * n - 1, h.shape[0], device=h.device,
                               dtype=torch.float32)
            sx, x_amax = row_scale(h, LRELU_SLOPE), None
            for i, stage in enumerate(form.stages):
                h = int8_conv_transpose1d(
                    h, form.quantized_up(self, i, per_phase[i]), LRELU_SLOPE,
                    sx=sx, x_amax=x_amax, amax_out=amax[2 * i])
                sx, x_amax = None, amax[2 * i + 1] if i + 1 < n else None
                h = mrf_stage_int8(h, stage, self.resblock, self.dilations,
                                   x_amax=amax[2 * i], amax_out=x_amax)
            x = h.transpose(1, 2)
        else:
            # under torch.export the stage is one operator node; else the
            # launcher, without the operator's host time (models/mrf.py)
            exporting = torch.compiler.is_exporting()
            for i, (up, stage, pk) in enumerate(zip(self.ups, form.stages,
                                                    form.packed)):
                x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE),
                                       *form.ups[i], stride=up.stride,
                                       padding=up.padding)
                h = x.transpose(1, 2).contiguous()
                if exporting:
                    h = mrf_stage_as_op(h, stage, self.resblock,
                                        self.kernel_sizes, self.dilations,
                                        pk)
                else:
                    h = mrf_stage(h, stage, self.resblock, self.kernel_sizes,
                                  self.dilations, checked=True, packed=pk)
                x = h.transpose(1, 2)
        x = F.conv1d(F.leaky_relu(x, 0.01), *form.conv_post, padding=3)
        return torch.tanh(x).float()

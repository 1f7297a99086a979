"""HiFi-GAN waveform decoder (port of wetts_tpu/models/hifigan.py; reference
wetts/vits/model/decoders.py:15-218).

conv_pre(7) [+ cond(g)] -> per upsample stage: leaky_relu(0.1) ->
weight-normed ConvTranspose upsample -> MRF stage (the mean of the resblock
branches) -> leaky_relu(0.01, torch's default, decoders.py:78) ->
conv_post(7, no bias) -> tanh.

The MRF stages take one of two routes, chosen by whether a gradient is
wanted and by nothing else (never by whether the kernel built or launched):

- inference (eval mode and autograd not recording into the decoder): every
  stage goes through `mrf.mrf_stage`, which launches kernel K1 on the GPU
  with the folded weights, packed once into the layout the kernel streams
  (`packed_stages`) and packed anew after `eval()`, `.to()` or
  `load_state_dict`;
- training (`train()` mode, or autograd recording with an input or parameter
  that requires grad): every stage runs `mrf.mrf_stage_reference`, the
  differentiable F.conv1d chain, on kernels computed from
  `weight_g`/`weight_v`. K1 has no backward, as the Pallas kernel it replaces
  has no VJP and the JAX package pins its differentiable path on the
  training route.

conv_pre, cond, the upsample convs and conv_post lay outside any Pallas
kernel in the JAX package and stay F.conv1d / F.conv_transpose1d.

Inference also runs at a reduced precision (`forward(..., precision=)`, the
`dtype` / `quantize` arguments of wetts_tpu/models/hifigan_fast.py:209-323),
which is an argument of the call and no config knob:

- "bf16": weight norm is folded in f32 and the folded kernels are cast;
  every conv runs in bf16, the MRF stages through K1's bf16 instance; the
  output is cast back to f32;
- "int8": as "bf16", but the upsample convs and every MRF conv are int8 with
  dynamic activation scales (`models/quant.py`); conv_pre, cond and
  conv_post stay in bf16.

The cast and quantised weights are derived once and kept until the module's
tensors are moved, cast, reloaded or refolded (`eval()`). Asking for a
reduced precision where a gradient is wanted raises.
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
    get_padding,
)
from wetts_tpu_torch.models.mrf import (
    Branch,
    check_stage,
    mrf_stage,
    mrf_stage_int8,
    mrf_stage_reference,
    pack_stage,
    quantize_stage,
)
from wetts_tpu_torch.models.quant import (
    QuantConvTranspose1d,
    int8_conv_transpose1d,
    upsample_scale_per_phase,
)

PRECISIONS = ("f32", "bf16", "int8")


def _forget_stages(module: "Generator", _incompatible_keys) -> None:
    module._forget()


class _Reduced:
    """The decoder's weights at a reduced precision, derived from the folded
    f32 buffers: bf16 copies of conv_pre / cond / conv_post and, for "bf16",
    of the upsamples and the MRF stages; for "int8" the quantised MRF stages
    and, made at first use, each upsample's kernel with per-channel or
    per-phase scales. `packed` holds the bf16 MRF stages as K1 streams
    them."""

    def __init__(self, gen: "Generator", precision: str,
                 dtype: torch.dtype = torch.bfloat16):
        def cast(conv):
            return (conv.weight.detach().to(dtype),
                    None if conv.bias is None
                    else conv.bias.detach().to(dtype))

        self.dtype = dtype
        self.conv_pre = cast(gen.conv_pre)
        self.cond = cast(gen.cond) if hasattr(gen, "cond") else None
        self.conv_post = cast(gen.conv_post)
        stages = [gen.stage_convs(i) for i in range(len(gen.ups))]
        if precision == "int8":
            self.stages = [quantize_stage(stage, dtype) for stage in stages]
            self.ups: Dict = {}
        else:
            self.stages = [[[(w.detach().to(dtype), b.detach().to(dtype))
                             for w, b in convs] for convs in stage]
                           for stage in stages]
            for stage in self.stages:
                check_stage(stage, gen.resblock, gen.kernel_sizes,
                            gen.dilations)
            self.packed = [pack_stage(stage) for stage in self.stages]
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


class Generator(nn.Module):
    """Latent [B, C_inter, T] -> waveform [B, 1, T * prod(upsample_rates)]."""

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
        self._checked_stages: Optional[List[List[Branch]]] = None
        self._packed_stages: Optional[List[List[Branch]]] = None
        self._reduced: Dict[str, _Reduced] = {}
        self.register_load_state_dict_post_hook(_forget_stages)

    def _forget(self) -> None:
        self._checked_stages = None
        self._packed_stages = None
        self._reduced = {}

    def stage_convs(self, i: int) -> List[Branch]:
        """Stage i's folded (weight, bias) pairs, one list per branch."""
        n = len(self.kernel_sizes)
        return [rb.folded_convs() for rb in self.resblocks[i * n:(i + 1) * n]]

    def checked_stages(self) -> List[List[Branch]]:
        """Every stage's folded pairs, passed through `check_stage` once and
        kept until the module's tensors are moved, cast or reloaded (folding
        writes the kept tensors in place)."""
        if self._checked_stages is None:
            stages = [self.stage_convs(i) for i in range(len(self.ups))]
            for stage in stages:
                check_stage(stage, self.resblock, self.kernel_sizes,
                            self.dilations)
            self._checked_stages = stages
        return self._checked_stages

    def packed_stages(self) -> List[List[Branch]]:
        """Every checked stage with its weights in K1's layout
        (`mrf.pack_stage`): copies, so they are kept only until the folded
        buffers change (`eval()` refolds them) or move."""
        if self._packed_stages is None:
            self._packed_stages = [pack_stage(stage)
                                   for stage in self.checked_stages()]
        return self._packed_stages

    def _apply(self, fn, *args, **kwargs):
        self._forget()
        return super()._apply(fn, *args, **kwargs)

    def train(self, mode: bool = True):
        """`eval()` refolds the weight-norm buffers; what was derived from
        them (K1's packed weights, the reduced precisions) is derived anew
        at its next use."""
        self._packed_stages = None
        self._reduced = {}
        return super().train(mode)

    def reduced(self, precision: str) -> _Reduced:
        """The weights at "bf16" or "int8", derived once and kept."""
        if precision not in self._reduced:
            self._reduced[precision] = _Reduced(self, precision)
        return self._reduced[precision]

    def gradient_wanted(self, x: torch.Tensor) -> bool:
        """Whether the decoder must be differentiable for this call: in
        train() mode (where the folded buffers may be stale), or when
        autograd is recording and `x` or a parameter requires grad."""
        return self.training or (torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad
                                   for p in self.parameters())))

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None,
                precision: str = "f32") -> torch.Tensor:
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        if precision != "f32":
            if self.gradient_wanted(x):
                raise RuntimeError(
                    f"the {precision} decoder is an inference route and has "
                    "no backward: call eval() and run under torch.no_grad()")
            return self._forward_reduced(x, g, precision)
        x = self.conv_pre(x)
        if g is not None and hasattr(self, "cond"):
            x = x + self.cond(g)
        n = len(self.kernel_sizes)
        if self.gradient_wanted(x):
            for i, up in enumerate(self.ups):
                x = up(F.leaky_relu(x, LRELU_SLOPE))
                stage = [rb.live_convs()
                         for rb in self.resblocks[i * n:(i + 1) * n]]
                x = mrf_stage_reference(
                    x.transpose(1, 2), stage, self.resblock,
                    self.kernel_sizes, self.dilations).transpose(1, 2)
        else:
            stages = self.checked_stages()
            packed = (self.packed_stages() if x.is_cuda
                      else [None] * len(stages))
            for up, stage, pk in zip(self.ups, stages, packed):
                x = up(F.leaky_relu(x, LRELU_SLOPE))
                h = mrf_stage(x.transpose(1, 2).contiguous(), stage,
                              self.resblock, self.kernel_sizes,
                              self.dilations, checked=True, packed=pk)
                x = h.transpose(1, 2)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)

    def _forward_reduced(self, x: torch.Tensor, g: Optional[torch.Tensor],
                         precision: str,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The inference route at "bf16" or "int8" (`dtype` is the type of
        the glue; the tests also run it in f32 to hold the int8 arithmetic
        against the JAX package's closely). Returns f32."""
        red = (self.reduced(precision) if dtype == torch.bfloat16
               else _Reduced(self, precision, dtype))
        x = F.conv1d(x.to(dtype), *red.conv_pre, padding=3)
        if g is not None and red.cond is not None:
            x = x + F.conv1d(g.to(dtype), *red.cond)
        if precision == "int8":
            per_phase = upsample_scale_per_phase(
                self.upsample_initial_channel, self.upsample_rates,
                x.shape[2])
            h = x.transpose(1, 2).contiguous()  # [B, T, C] from here on
            for i, stage in enumerate(red.stages):
                h = int8_conv_transpose1d(
                    h, red.quantized_up(self, i, per_phase[i]), LRELU_SLOPE)
                h = mrf_stage_int8(h, stage, self.resblock, self.dilations)
            x = h.transpose(1, 2)
        else:
            for i, (up, stage) in enumerate(zip(self.ups, red.stages)):
                x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE),
                                       *red.ups[i], stride=up.stride,
                                       padding=up.padding)
                h = mrf_stage(x.transpose(1, 2).contiguous(), stage,
                              self.resblock, self.kernel_sizes,
                              self.dilations, checked=True,
                              packed=red.packed[i])
                x = h.transpose(1, 2)
        x = F.conv1d(F.leaky_relu(x, 0.01), *red.conv_post, padding=3)
        return torch.tanh(x).float()

"""Convolution / normalization primitives (port of wetts_tpu/models/layers.py).

Activations inside the port's modules are `[B, C, T]`, PyTorch's own
convolution layout. Parameters keep the reference `SynthesizerTrn`'s
state_dict names and shapes (torch Conv1d `weight` [O, I, K],
ConvTranspose1d `weight` [I, O, K], LayerNorm `gamma`/`beta`), and a
weight-normed conv keeps `weight_g`/`weight_v`.

Weight norm has one arithmetic, that of the JAX package:
`v * (g / max(||v||, 1e-12))`, the norm per output channel of a conv and
per input channel of a transposed conv (torch weight_norm dim=0), and two
routes to it (`WeightNormed.kernel`):

- where a gradient is wanted (the module is in `train()` mode, or autograd
  is recording and `weight_v`/`weight_g` require grad) the kernel is
  computed from the two parameters inside `forward`, so both learn;
- otherwise (inference) the module uses `weight`, a non-persistent buffer
  that holds the folded kernel. The buffer is refolded whenever the
  parameters can have changed under it: when a state_dict is loaded, and
  whenever the module enters eval mode (`eval()` / `train(False)`). So after
  optimiser steps, `model.eval()` is what brings the inference path, and the
  CUDA kernels that read the buffer by pointer, up to date.

`DerivedWeights` keeps what inference derives from them, by one rule.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def fold_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, the norm over every axis but the first."""
    norm = torch.sqrt((v * v).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return v * (g.reshape(-1, *([1] * (v.ndim - 1)))
                / torch.clamp_min(norm, 1e-12))


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor,
                                    n_channels: int) -> torch.Tensor:
    """Gated activation tanh(s[:n]) * sigmoid(s[n:]) of s = a + b over the
    channel axis (reference commons.py:98-105)."""
    s = a + b
    return torch.tanh(s[:, :n_channels]) * torch.sigmoid(s[:, n_channels:])


def _refold(module: nn.Module, _incompatible_keys) -> None:
    module.fold_()


class WeightNormed(nn.Module):
    """Holds `weight_g`/`weight_v` and their folded `weight`."""

    weight_norm = False

    def _init_weight(self, shape, g_len: int, weight_norm: bool):
        self.weight_norm = weight_norm
        if weight_norm:
            self.weight_g = nn.Parameter(
                torch.zeros(g_len, *([1] * (len(shape) - 1))))
            self.weight_v = nn.Parameter(torch.zeros(shape))
            self.register_buffer("weight", torch.zeros(shape),
                                 persistent=False)
            self.register_load_state_dict_post_hook(_refold)
        else:
            self.weight = nn.Parameter(torch.zeros(shape))

    @torch.no_grad()
    def fold_(self) -> None:
        """Recompute the folded kernel from weight_g/weight_v."""
        if self.weight_norm:
            self.weight.copy_(fold_weight_norm(self.weight_v, self.weight_g))

    def train(self, mode: bool = True):
        """Entering eval mode refolds the inference buffer."""
        super().train(mode)
        if not mode:
            self.fold_()
        return self

    def kernel(self) -> torch.Tensor:
        """The convolution kernel: differentiable in weight_g/weight_v where
        a gradient is wanted, the folded buffer otherwise."""
        if self.weight_norm and (self.training or (
                torch.is_grad_enabled()
                and (self.weight_v.requires_grad
                     or self.weight_g.requires_grad))):
            return fold_weight_norm(self.weight_v, self.weight_g)
        return self.weight


class _Kept:
    """A derived value's sources: where each is held (a module's parameter or
    buffer dict, a name), the tensor, and its version where it keeps one. A
    `.data =` swap keeps both, so it goes unseen (none outside `_apply`)."""

    def __init__(self, sources: List[Tuple[nn.Module, str]]):
        self.dicts = [m._parameters if n in m._parameters else m._buffers
                      for m, n in sources]
        self.names = [n for _, n in sources]
        self.tensors = list(map(operator.getitem, self.dicts, self.names))
        self.tracked = [t for t in self.tensors if not t.is_inference()]
        self.versions = [t._version for t in self.tracked]

    def current(self) -> bool:
        return (all(map(operator.is_, map(operator.getitem, self.dicts,
                                          self.names), self.tensors))
                and [t._version for t in self.tracked] == self.versions)


class DerivedWeights(nn.Module):
    """A module that keeps values derived from its tensors for inference
    (`derived`), by one rule: a value is made at its first lookup, and made
    anew at the next once a source tensor has been replaced or written in
    place (for an inference tensor, which keeps no version counter, only a
    replacement counts; `WeightNormed`'s refold writes in place, so it
    alone makes what was derived from the folded buffers stale). Moves,
    casts (`_apply`) and loads drop every value, and copies and pickles
    carry none. While `torch.export` traces, which swaps stand-ins in for
    the tensors, a kept value is used as it is and none is kept. A lookup
    reads each source's slot and version and nothing more (some 35 us for
    the 157 of VITS-base's decoder on one core of a Xeon host)."""

    def __init__(self):
        super().__init__()
        self._derived: Dict[str, Tuple[_Kept, Any]] = {}

    def derived(self, name: str,
                sources: Callable[[], List[Tuple[nn.Module, str]]],
                make: Callable[[], Any]) -> Any:
        """The value kept under `name`, or `make()` (without autograd).
        `sources()` gives its source tensors as (module, attribute name)
        pairs, when it is made."""
        kept = self._derived.get(name)
        exporting = torch.compiler.is_exporting()
        if kept is not None and (exporting or kept[0].current()):
            return kept[1]
        with torch.no_grad():
            if exporting:
                return make()
            kept = self._derived[name] = (_Kept(sources()), make())
        return kept[1]

    def _apply(self, fn, *args, **kwargs):
        self._derived.clear()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._derived.clear()
        super()._load_from_state_dict(*args, **kwargs)

    def __getstate__(self):
        return dict(super().__getstate__(), _derived={})


class Conv1d(WeightNormed):
    """torch.nn.Conv1d on [B, C, T] with integer padding, optional weight
    norm (`weight_g` [O, 1, 1], `weight_v` [O, I/groups, K])."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True,
                 weight_norm: bool = False, stride: int = 1):
        super().__init__()
        self.padding, self.dilation, self.groups = padding, dilation, groups
        self.stride = stride
        self._init_weight((out_channels, in_channels // groups, kernel_size),
                          out_channels, weight_norm)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.kernel(), self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class Dense(Conv1d):
    """1x1 projection over channels (the JAX `Dense`; the reference's
    `Conv1d(c_in, c_out, 1)` in attention, weight [O, I, 1])."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)


class ConvTranspose1d(WeightNormed):
    """torch.nn.ConvTranspose1d on [B, C, T]; weight [C_in, C_out, K], weight
    norm per in-channel (`weight_g` [C_in, 1, 1])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_weight((in_channels, out_channels, kernel_size),
                          in_channels, weight_norm)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.kernel(), self.bias,
                                  stride=self.stride, padding=self.padding)


def _pair(v) -> tuple:
    """An int k as (k, 1), the period discriminator's (k, 1) geometry; a
    pair as it is."""
    return (v, 1) if isinstance(v, int) else tuple(v)


class Conv2d(WeightNormed):
    """torch.nn.Conv2d on [B, C, H, W]. An int kernel size k, stride s or
    padding p means (k, 1), (s, 1), (p, 0): the period discriminator's
    convolution; the resolution discriminator's take pairs. weight
    [O, I, kh, kw]; weight norm per out-channel (`weight_g` [O, 1, 1, 1])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.stride = _pair(stride)
        self.padding = (padding, 0) if isinstance(padding, int) else tuple(
            padding)
        self._init_weight((out_channels, in_channels, *_pair(kernel_size)),
                          out_channels, weight_norm)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel(), self.bias, stride=self.stride,
                        padding=self.padding)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T] (eps 1e-5, reference
    normalization.py:6-19)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma,
                         self.beta, 1e-5)
        return x.transpose(1, -1)

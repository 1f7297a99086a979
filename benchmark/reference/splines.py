"""Piecewise rational-quadratic spline flows (Durkan et al., NeurIPS 2019).

A frozen copy of the port's plain spline code (reference
wetts/vits/utils/transforms.py:10-206): forward and inverse with linear
tails and log-abs-det, as the stochastic duration predictor's ConvFlow
coupling uses them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _search_bins(x: torch.Tensor, locations: torch.Tensor) -> torch.Tensor:
    """Index of the bin containing x. locations: [..., K+1] ascending edges;
    the top edge is nudged so x == top maps into the last bin."""
    locations = torch.cat(
        [locations[..., :-1], locations[..., -1:] + 1e-6], dim=-1)
    idx = (x[..., None] >= locations).sum(dim=-1) - 1
    return idx.clamp(0, locations.shape[-1] - 2)


def _normalize_bins(unnormalized: torch.Tensor, num_bins: int,
                    min_size: float, left: float, right: float):
    """Softmax bin sizes with a minimum, then cumulative edges on
    [left, right]."""
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_size + (1.0 - min_size * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (right - left) * cum + left
    cum = torch.cat([torch.full_like(cum[..., :1], left), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], right)], dim=-1)
    return cum[..., 1:] - cum[..., :-1], cum


def rational_quadratic_spline(inputs, unnormalized_widths,
                              unnormalized_heights, unnormalized_derivatives,
                              inverse=False, left=0.0, right=1.0, bottom=0.0,
                              top=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                              min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                              min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Monotonic RQ spline over [left, right] -> [bottom, top].

    inputs [...]; unnormalized_{widths,heights} [..., K];
    unnormalized_derivatives [..., K+1]. Returns (outputs, logabsdet).
    """
    num_bins = unnormalized_widths.shape[-1]
    widths, cumwidths = _normalize_bins(
        unnormalized_widths, num_bins, min_bin_width, left, right)
    heights, cumheights = _normalize_bins(
        unnormalized_heights, num_bins, min_bin_height, bottom, top)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _search_bins(inputs, cumheights if inverse else cumwidths)
    bin_idx = bin_idx[..., None]

    def g(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    in_w, in_cw = g(widths), g(cumwidths)
    in_h, in_ch = g(heights), g(cumheights)
    d_k, d_k1 = g(derivatives), g(derivatives[..., 1:])
    delta = in_h / in_w

    if inverse:
        y = inputs - in_ch
        dsum = d_k1 + d_k - 2.0 * delta
        a = in_h * (delta - d_k) + y * dsum
        b = in_h * d_k - y * dsum
        c = -delta * y
        disc = b * b - 4.0 * a * c
        root = 2.0 * c / (-b - torch.sqrt(torch.clamp_min(disc, 0.0)))
        outputs = root * in_w + in_cw
        one_m = root * (1.0 - root)
        denom = delta + dsum * one_m
        dnum = delta * delta * (d_k1 * root * root + 2.0 * delta * one_m
                                + d_k * (1.0 - root) ** 2)
        logabsdet = -(torch.log(dnum) - 2.0 * torch.log(denom))
    else:
        xi = (inputs - in_cw) / in_w
        one_m = xi * (1.0 - xi)
        dsum = d_k1 + d_k - 2.0 * delta
        denom = delta + dsum * one_m
        outputs = in_ch + in_h * (delta * xi * xi + d_k * one_m) / denom
        dnum = delta * delta * (d_k1 * xi * xi + 2.0 * delta * one_m
                                + d_k * (1.0 - xi) ** 2)
        logabsdet = torch.log(dnum) - 2.0 * torch.log(denom)
    return outputs, logabsdet


def unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, tail_bound=5.0,
        min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Identity outside [-tail_bound, tail_bound], RQ spline inside; the
    boundary derivatives are pinned to 1 (reference transforms.py:59-82)."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1.0 - min_derivative))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1),
                                     value=constant)
    safe = inputs.clamp(-tail_bound, tail_bound)
    out_in, ld_in = rational_quadratic_spline(
        safe, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse, left=-tail_bound,
        right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    outputs = torch.where(inside, out_in, inputs)
    logabsdet = torch.where(inside, ld_in, torch.zeros_like(ld_in))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, tails=None, tail_bound=1.0,
        min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Dispatcher mirroring the reference API (transforms.py:10-42)."""
    if tails is None:
        return rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, inverse=inverse,
            min_bin_width=min_bin_width, min_bin_height=min_bin_height,
            min_derivative=min_derivative)
    if tails != "linear":
        raise ValueError(f"unsupported tails: {tails}")
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse, tail_bound=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)

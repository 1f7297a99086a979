"""Every random draw of the port goes through this module: the posterior
sample, the stochastic duration predictor's noise, the training slice
offsets and the dropout masks. Each takes the caller's explicit
`torch.Generator` (None means torch's global generator of the device).

Keeping the draws in one place lets a test that compares the port with the
JAX package replace them with a shared deterministic pattern, as it patches
`jax.random` on the other side; no module carries a "noise=" argument.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def normal(shape: Sequence[int], device, dtype=torch.float32,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard normal draws of `shape`."""
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=dtype)


def uniform(shape: Sequence[int], device, dtype=torch.float32,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform draws in [0, 1) of `shape`."""
    return torch.rand(tuple(shape), generator=generator, device=device,
                      dtype=dtype)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: zero with probability p, scale the rest by
    1 / (1 - p); the identity unless `training` and p > 0."""
    if not training or p <= 0.0:
        return x
    keep = uniform(x.shape, x.device, x.dtype, generator) >= p
    return x * keep / (1.0 - p)

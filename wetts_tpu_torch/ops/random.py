"""Every random draw of the port goes through this module: the posterior
sample, the stochastic duration predictor's noise, the training slice
offsets, the noise-scaled MAS's noise and the dropout masks. Each takes the
caller's explicit `torch.Generator` (None means torch's global generator of
the device).

Keeping the draws in one place lets a test that compares the port with the
JAX package replace them with a shared deterministic pattern, as it patches
`jax.random` on the other side; no module carries a "noise=" argument.

Two contexts change where the values come from:
- inside a data-parallel step (`parallel.mesh.sharded(rank, world)`) every
  draw, whose leading dimension is the batch, draws the global batch's
  shape (that dimension times `world`) from the generator, which every
  rank holds at the same state, and keeps this rank's rows: N ranks draw
  what one rank draws for the global batch;
- inside `supplied(draws)` the draws are handed out from `draws` in order
  instead (a graph export takes the noise as inputs: a traced graph cannot
  take a generator).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence

import torch

from wetts_tpu_torch.parallel.mesh import current_shard

# the draws still to hand out inside `supplied`, else None
_SUPPLY: Optional[Iterator[torch.Tensor]] = None


@contextlib.contextmanager
def supplied(draws: Sequence[torch.Tensor]):
    """Inside, `normal` and `uniform` return the tensors of `draws` in order
    (each must have the shape asked for); raises on leaving if any is left
    over."""
    global _SUPPLY
    saved, it = _SUPPLY, iter(list(draws))
    _SUPPLY = it
    try:
        yield
        left = sum(1 for _ in it)
        if left:
            raise ValueError(f"{left} supplied draws were not used")
    finally:
        _SUPPLY = saved


def from_generator() -> bool:
    """True where every draw comes from the caller's generator alone, as it
    is asked for: outside `supplied` and outside a data-parallel step."""
    return _SUPPLY is None and current_shard()[1] == 1


def _draw(fn: Callable, shape: Sequence[int], device, dtype,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    shape = tuple(shape)
    if _SUPPLY is not None:
        t = next(_SUPPLY, None)
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"a draw of {shape} was asked for, the next "
                             f"supplied one is "
                             f"{None if t is None else tuple(t.shape)}")
        return t.to(device=device, dtype=dtype)
    rank, world = current_shard()
    if world == 1:
        return fn(shape, generator=generator, device=device, dtype=dtype)
    b = shape[0]
    full = fn((b * world,) + shape[1:], generator=generator, device=device,
              dtype=dtype)
    return full[rank * b:(rank + 1) * b]


def normal(shape: Sequence[int], device, dtype=torch.float32,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard normal draws of `shape`."""
    return _draw(torch.randn, shape, device, dtype, generator)


def uniform(shape: Sequence[int], device, dtype=torch.float32,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform draws in [0, 1) of `shape`."""
    return _draw(torch.rand, shape, device, dtype, generator)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: zero with probability p, scale the rest by
    1 / (1 - p); the identity unless `training` and p > 0."""
    if not training or p <= 0.0:
        return x
    keep = uniform(x.shape, x.device, x.dtype, generator) >= p
    return x * keep / (1.0 - p)

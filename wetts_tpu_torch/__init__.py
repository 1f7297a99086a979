"""wetts_tpu_torch: the PyTorch/CUDA port of wetts_tpu.

A second package beside the JAX one, with the same layout (`models/`,
`ops/`, `serving/`, `utils/`, `text/`) and the same public `[B, T, C]`
layout, so each module can be held against its JAX counterpart. It imports
`torch` and never `jax` or anything of `wetts_tpu`.

The kernels written for the TPU in Pallas become kernels written by hand for
Hopper under `csrc/`; each sits beside its plain PyTorch version, which the
CPU runs.
"""

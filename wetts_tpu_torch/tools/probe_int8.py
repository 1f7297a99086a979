"""Probe: how fast is a chain of int8 x int8 -> int32 tensor-core products
on this GPU, against the same chain in bf16?

The twin of tools/probe_int8_mxu.py: 16 dependent `[8192, 1024] x
[1024, 1024]` products with a requantisation between them
(`ops/int8_chain.py:matmul_chain`, kernel K3: one launch per hop, with the
wrapper's packing of the operands), timed with CUDA events over 10 chains,
best of 3. Prints the card's name and power limit, then one
JSON line with the keys of the TPU probe (`shape`, `chain`, `device`,
`bf16_ms`, `bf16_tflops`, `int8_ms`, `int8_tops`, `int8_speedup`) plus
`card`.

    python -m wetts_tpu_torch.tools.probe_int8

Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from wetts_tpu_torch.ops.int8_chain import HOPS, matmul_chain

M, K = 8192, 1024


def chain_inputs(dtype: torch.dtype, m: int = M, k: int = K, seed: int = 0):
    """The TPU probe's operands: uniform integers in [-127, 127) for int8,
    standard normals for bf16 (so a hop's `/ 32` keeps their magnitude)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        def draw(shape):
            return torch.randint(-127, 127, shape, device="cuda",
                                 generator=gen, dtype=torch.int8)
    else:
        def draw(shape):
            return torch.randn(shape, device="cuda", generator=gen
                               ).to(torch.bfloat16)
    return draw((m, k)), draw((k, k))


def time_chain(fn, iters: int = 10, rounds: int = 3) -> float:
    """Best mean device milliseconds of fn() over `rounds` runs of `iters`
    launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def chain_rate(ms: float, m: int = M, k: int = K, hops: int = HOPS) -> float:
    """Tera-operations per second of the chain at `ms` per launch."""
    return 2 * m * k * k * hops / (ms * 1e-3) / 1e12


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_int8: no CUDA device", file=sys.stderr)
        return 1
    out = {"shape": [M, K, K], "chain": HOPS,
           "device": torch.cuda.get_device_name(0), "card": card()}
    print(out["card"])
    a, w = chain_inputs(torch.bfloat16)
    ms = time_chain(lambda: matmul_chain(a, w))
    out["bf16_ms"], out["bf16_tflops"] = round(ms, 3), round(chain_rate(ms), 1)
    a, w = chain_inputs(torch.int8)
    ms = time_chain(lambda: matmul_chain(a, w))
    out["int8_ms"], out["int8_tops"] = round(ms, 3), round(chain_rate(ms), 1)
    out["int8_speedup"] = round(out["bf16_ms"] / out["int8_ms"], 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

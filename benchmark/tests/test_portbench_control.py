"""On the card: each cell's control comes out as not correct.

The control is the reference computed with TF32 on, the nearest precision
below the configurations' float32, put in the program's place on the
calls of a short window at the cell's own load. The program's own numbers
on the same window hold the cell's limits; the control's fail at least one.
Run on a machine with an NVIDIA GPU:

    python -m pytest benchmark/tests/test_portbench_control.py -m cuda
"""

import gc
import time

import pytest

from benchmark import harness
from benchmark.calls import load_limits
from benchmark.system import load_config
from benchmark.traffic import load_mix

BENCH = harness.load_benchmark()
WINDOW_S = 3.0


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_limits(name, cuda):
    cell = {w["name"]: w for w in BENCH["workloads"]}[name]
    mix = load_mix(cell["traffic"])
    run = harness.Run(name=name, cell=cell, cfg=load_config(cell["config"]),
                      mix=mix, seed=424242, seconds=WINDOW_S, trace=False,
                      device=cuda, t_start=time.perf_counter())
    driver = harness.load_module("drivers", mix["driver"])
    state = driver.setup(run)
    harness.settle(cuda)
    driver.window(run, state)
    gc.unfreeze()
    limits = load_limits(name)
    program = driver.check(run, state)
    control = driver.check(run, state, control=True)
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control

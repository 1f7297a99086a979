"""The benchmark of the PyTorch and CUDA port, `wetts_tpu_torch`.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Each configuration, traffic mix, driver and metric is a file of its
own under this directory, found by the name `BENCHMARK.json` gives it.
Nothing here imports JAX or the JAX package.
"""

import os

# the checkout's root: BENCHMARK.json, this directory and the program
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

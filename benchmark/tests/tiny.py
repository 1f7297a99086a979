"""Small configurations and mixes that a CPU test run can hold, made from
the benchmark's own files by shrinking every width."""

from __future__ import annotations

import copy

from benchmark.system import load_config

TINY_MODEL = {"inter_channels": 16, "hidden_channels": 16,
              "filter_channels": 32, "n_heads": 2, "n_layers": 2,
              "upsample_initial_channel": 32, "gin_channels": 8,
              "resblock_kernel_sizes": [3, 5],
              "resblock_dilation_sizes": [[1, 3], [1, 3]],
              "vocos_channels": 16, "vocos_h_channels": 32,
              "vocos_num_layers": 2}


def tiny_config(name: str, num_phones: int = 24) -> dict:
    cfg = copy.deepcopy(load_config(name))
    cfg["model"].update(TINY_MODEL)
    cfg["num_phones"] = num_phones
    cfg["num_speakers"] = 2
    return cfg


def tiny_batch_mix() -> dict:
    return {"driver": "closed_batch",
            "phones": {"dist": "lognormal", "median": 8, "sigma": 0.35,
                       "min": 4, "max": 14},
            "batch": 2, "pool": 16, "probe": 8, "warm_calls": 1,
            "check_calls": 2}


def tiny_serve_mix() -> dict:
    return {"driver": "open_loop",
            "phones": {"dist": "lognormal", "median": 8, "sigma": 0.35,
                       "min": 4, "max": 14},
            "rate_per_s": 20.0, "pool": 256, "probe": 8, "max_batch": 4,
            "max_delay_s": 0.005, "warm_calls": 4, "warm_s": 0.3,
            "check_calls": 3, "order": "fixed"}


def tiny_stream_mix() -> dict:
    return {"driver": "closed_stream", "clients": 2,
            "bert": {"hidden_size": 32, "num_layers": 2, "num_heads": 2,
                     "intermediate_size": 64},
            "think_s": 0.01,
            "clauses": {"dist": "uniform", "min": 1, "max": 3},
            "hanzi": {"dist": "uniform", "min": 3, "max": 6},
            "pool": 64, "block": 40, "pad": 10, "warm_streams": 1,
            "check_streams": 3}

"""The drivers' shared pieces: the recorder around the engine's batch entry,
the decoder's input shapes read at the module boundary, the sample of calls
checked, the control, and the comparison of recorded calls with the
reference.

The recorder replaces `engine.synthesize_ids_batch` on the instance with a
wrapper that calls the method, so the batcher's dispatcher and the drivers
go through it alike. Per call of the window it keeps the rows, the
speakers, the state of the engine's noise generator before and after, the
answers' lengths and the host times, and the answers themselves of every
call or, where it is given a sample's size, only of the calls that the
check will compare; inside a traced slice it opens the benchmark's span
around the call.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from benchmark import ROOT
from benchmark.reference import serving as ref_serving
from benchmark.system import build_reference


class CallRecorder:
    """With `keep` (n, rng), the answers of n calls of the window are held,
    the call with the longest answer and n - 1 drawn uniformly from all
    calls as they come (reservoir sampling from rng); `picked()` names
    them. Without it every call's answers are held. A window of a closed
    batch loop returns gigabytes of audio, and holding all of it would make
    the host fault in fresh pages all through the window."""

    def __init__(self, engine, tracer, keep=None):
        self.recording = False
        self.calls: List[dict] = []
        self.keep = keep
        self.sample: List[int] = []
        self.longest: Optional[int] = None
        method = engine.synthesize_ids_batch
        generator = engine.generator

        def recorded(ids_list, sids):
            if not self.recording:
                with tracer.span("synthesize_ids_batch"):
                    return method(ids_list, sids)
            call = {"ids": [list(i) for i in ids_list], "sids": list(sids),
                    "state": generator.get_state(), "t0": time.perf_counter()}
            audios = method(ids_list, sids)
            call["t1"] = time.perf_counter()
            call["state_after"] = generator.get_state()
            call["samples"] = [int(a.shape[0]) for a in audios]
            call["audio"] = audios
            self.calls.append(call)
            if self.keep is not None:
                self.thin(len(self.calls) - 1)
            return audios

        engine.synthesize_ids_batch = recorded

    def thin(self, i: int) -> None:
        """Take call i into the sample or the longest, and drop the answers
        of the call that either leaves."""
        n, rng = self.keep
        calls, out = self.calls, []
        if len(self.sample) < n - 1:
            self.sample.append(i)
        else:
            j = int(rng.integers(0, i + 1))
            if j < n - 1:
                out.append(self.sample[j])
                self.sample[j] = i
            else:
                out.append(i)
        if (self.longest is None or max(calls[i]["samples"])
                > max(calls[self.longest]["samples"])):
            out.append(self.longest)
            self.longest = i
        for k in out:
            if k is not None and k != self.longest and k not in self.sample:
                calls[k].pop("audio", None)

    def picked(self) -> List[int]:
        """The calls whose answers are held, in window order."""
        if self.keep is None:
            return list(range(len(self.calls)))
        if self.longest is None:
            return []
        return sorted(set(self.sample) | {self.longest})


def record_decoder_shapes(engine, tracer, shapes: list) -> None:
    """Append the input shape [B, C, frames] of every decoder call made
    while the tracer records."""
    def hook(_module, args):
        if tracer.active:
            shapes.append(tuple(args[0].shape))

    engine.model.dec.register_forward_pre_hook(hook)


def load_limits(cell: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "limits", f"{cell}.json"),
              encoding="utf8") as f:
        return json.load(f)


def sample_calls(calls: List[dict], n: int, rng: np.random.Generator
                 ) -> List[int]:
    """n calls drawn from the seed, the one with the longest answer always
    among them, in window order."""
    if not calls:
        return []
    longest = max(range(len(calls)), key=lambda k: max(calls[k]["samples"]))
    rest = [k for k in range(len(calls)) if k != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[int(k)] for k in pick])


def free_program(state: dict) -> None:
    """Stop the batcher's dispatcher, where there is one, and drop the
    program's engine and model and their device memory."""
    if "batcher" in state:
        state["batcher"].shutdown()
    for key in ("engine", "batcher", "recorder"):
        state.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def scales(run):
    """The engine's (noise_scale, length_scale, noise_scale_w): the
    configuration's, with the length scale set-up calibrated."""
    a = run.cfg["assumed"]
    return a["noise_scale"], run.record["length_scale"], a["noise_scale_w"]


@contextlib.contextmanager
def tf32():
    """TF32 on for matrix products and convolutions: the nearest precision
    below the configurations' float32, the control's."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def control_answers(run, model, calls: List[dict], picked: List[int]):
    """The control in the program's place: the reference under TF32 on
    every picked call (its rows, speakers and noise)."""
    answers = [None] * len(calls)
    with tf32():
        for k in picked:
            gen = torch.Generator(device=run.device)
            gen.set_state(calls[k]["state"])
            answers[k] = ref_serving.synthesize(
                model, calls[k]["ids"], calls[k]["sids"], scales(run), gen,
                run.device)
    return answers


def compare_calls(run, model, calls: List[dict], picked: List[int],
                  answers: Optional[List[List[np.ndarray]]] = None) -> dict:
    """Replay each picked call through the reference: rows whose realized
    length differs, and rows the program left out or added, the widest gap
    between the program's and the reference's samples, and calls after
    which the program's generator stands elsewhere than the reference's
    replay of its draws."""
    len_mismatch = draw_mismatch = rows = 0
    worst = 0.0
    for k in picked:
        call = calls[k]
        gen = torch.Generator(device=run.device)
        gen.set_state(call["state"])
        want = ref_serving.synthesize(model, call["ids"], call["sids"],
                                      scales(run), gen, run.device)
        if not torch.equal(gen.get_state(), call["state_after"]):
            draw_mismatch += 1
        got = call["audio"] if answers is None else answers[k]
        len_mismatch += abs(len(got) - len(want))
        for g, w in zip(got, want):
            rows += 1
            if g.shape != w.shape:
                len_mismatch += 1
                continue
            worst = max(worst, float(np.max(np.abs(g - w))) if g.size
                        else 0.0)
    return {"rows_compared": rows, "len_mismatch": len_mismatch,
            "draw_mismatch": draw_mismatch, "audio_max_abs": worst}

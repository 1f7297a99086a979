"""The Vocos cell's two readers, `vocos_roofline.*` and `istft_ms.*`, on
hand-built window records: nothing to read without the program's device
stage or counters (a program without them, as before they existed) or for
a HiFi-GAN configuration, and hand-computed values otherwise; the
backbone's bytes against a hand count at the published widths and its
weights against the reference decoder's parameters."""

import pytest
import torch

from benchmark import flops, harness, vocos_cost
from benchmark.harness import Run
from benchmark.peaks import PEAK_BYTES, PEAK_FLOPS
from benchmark.system import build_reference, load_config
from benchmark.tests.tiny import tiny_config

ROOFLINE = harness.load_module("metrics", "vocos_roofline.batch")
ISTFT = harness.load_module("metrics", "istft_ms.batch")
CELL = "vits2_vocos_v1.batch"


def run_with(stage_times, config="vits2_vocos_v1"):
    run = Run(name=CELL, cell={}, cfg=load_config(config), mix={}, seed=0,
              seconds=1.0, trace=True, device=None, t_start=0.0)
    if stage_times is not None:
        run.record["stage_times"] = stage_times
    return run


def stage(n, total_s):
    return {"n": n, "total_s": total_s, "mean_ms": 1e3 * total_s / n,
            "p50_ms": 0.0, "p99_ms": 0.0}


def counter(n, count):
    return {"n": n, "count": count, "total_s": 0.0, "mean_ms": 0.0,
            "p50_ms": 0.0, "p99_ms": 0.0}


# 100 decodes of 8 rows at 704 padded frames; the backbone 3 ms a decode,
# the iSTFT 0.25 ms
WINDOW = {"encode": stage(100, 0.9), "flow": stage(100, 0.5),
          "decode": stage(100, 0.6), "vocos": stage(100, 0.3),
          "istft": stage(100, 0.025), "decode_rows": counter(100, 800),
          "decode_frames": counter(100, 800 * 704)}


@pytest.mark.parametrize("missing", [
    None, "vocos", "decode_rows", "decode_frames"])
def test_roofline_needs_the_stage_and_both_counters(missing):
    if missing is None:
        run = run_with(None)
    else:
        run = run_with({k: v for k, v in WINDOW.items() if k != missing})
    assert ROOFLINE.read(run) is None


@pytest.mark.parametrize("stage_times", [
    None, {}, {k: v for k, v in WINDOW.items() if k != "istft"}])
def test_istft_needs_its_stage(stage_times):
    assert ISTFT.read(run_with(stage_times)) is None


def test_nothing_to_read_for_hifigan():
    assert ROOFLINE.read(run_with(WINDOW, "vits_v1")) is None


def test_roofline_by_hand():
    # the published widths: 192 -> 512 (+ 256 cond) -> 8 x (dw 3, 512 ->
    # 1536 -> 512) -> 1026, over t + 1 frames a row
    m = load_config("vits2_vocos_v1")["model"]
    rows, frames = 800, 800 * 704
    layer = 2 * 512 * 3 + 2 * 512 * 1536 + 2 * 1536 * 512
    per_frame = 2 * 192 * 512 + 8 * layer + 2 * 512 * 1026
    ops = per_frame * (frames + rows) + rows * 2 * 256 * 512
    assert vocos_cost.backbone_cost(m, 100, rows, frames)[0] == ops
    assert ops == rows * flops.decoder(m, 704)
    nbytes = 4 * ((192 + 1026) * (frames + rows)
                  + 100 * vocos_cost.weights(m))
    want = 100.0 * max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) / 0.3
    assert ROOFLINE.read(run_with(WINDOW)) == pytest.approx(want, rel=1e-12)
    # compute-bound: a decode's 149.1 GFLOP take 0.151 ms at the peak,
    # its 81.0 MB 0.024 ms; 100 x 0.151 ms of the backbone's 300 ms
    assert ops == 100 * 149_110_341_632
    assert nbytes == 100 * 81_025_096
    assert ROOFLINE.read(run_with(WINDOW)) == pytest.approx(
        100.0 * 100 * 149_110_341_632 / 989e12 / 0.3, rel=1e-12)


def test_istft_by_hand():
    assert ISTFT.read(run_with(WINDOW)) == pytest.approx(0.25)


def test_bytes_by_hand_at_one_shape():
    """One decode of 8 rows at 352 frames: the input [8, 192, 353] read,
    the output [8, 1026, 353] written and 13,386,754 parameters read, four
    bytes each."""
    m = load_config("vits2_vocos_v1")["model"]
    params = (192 * 512 + 512 + 256 * 512 + 512 + 2 * 512
              + 8 * (3 * 512 + 512 + 2 * 512 + 512 * 1536 + 1536
                     + 1536 * 512 + 512 + 512)
              + 2 * 512 + 512 * 1026 + 1026)
    assert vocos_cost.weights(m) == params == 13_386_754
    _, nbytes = vocos_cost.backbone_cost(m, 1, 8, 8 * 352)
    assert nbytes == 4 * (8 * 192 * 353 + 8 * 1026 * 353 + params)


def test_weights_are_the_reference_decoders():
    """Every parameter of the reference's Vocos but the iSTFT's (it has
    none), at tiny widths."""
    cfg = tiny_config("vits2_vocos_v1")
    ref = build_reference(cfg, "cpu")
    assert vocos_cost.weights(cfg["model"]) == sum(
        p.numel() for p in ref.dec.parameters())
    assert not any(isinstance(b, torch.nn.Parameter)
                   for b in ref.dec.buffers())


def test_the_vocos_cell_reports_them_traced():
    bench = harness.load_benchmark()
    traced = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    untraced = {m["name"] for m in harness.cell_metrics(bench, CELL, False)}
    assert {"vocos_roofline.batch", "istft_ms.batch", "mfu",
            "encode_flow_ms.batch", "decode_ms.batch", "device_idle.batch",
            "graph_hit.batch"} == traced
    assert untraced == {"audio_s_per_s", "setup_s"}
    assert not {"vocos_roofline.batch", "istft_ms.batch"} & {
        m["name"] for m in harness.cell_metrics(bench, "vits_v1.batch",
                                                True)}

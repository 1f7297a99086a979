"""The engine's CUDA graphs on the card: the encode and the flow replayed
from graphs against the same engine's eager stages (`_encode_flow_eager`),
at VITS-base's and VITS2-Vocos's full widths, B = 1 and 8, two text
buckets, f32 and `half`: equal latents, lengths and audio, and the noise
generator in the same state after every call; a repeated key replays
without a capture; a latent handed out survives the next replay.

Needs an NVIDIA GPU; skips elsewhere (a CUDA graph has no CPU mode).
Imports nothing of JAX, so on a machine without JAX run it as

    python -m pytest --noconftest -m cuda -s tests/test_torch_engine_graphs.py

f32 with TF32 off, as the benchmark runs.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import random_init_
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.serving.engine import SynthesisEngine

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"vits_v1": "v1.json", "vits2_vocos_v1": "vits2_vocos_v1.json"}
N_PHONES, N_SPEAKERS = 64, 4
PHONES = {"sil": 0, **{f"p{i}": i for i in range(1, N_PHONES)}}
SPEAKERS = {f"spk{i}": i for i in range(N_SPEAKERS)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        saved


def engines(name: str, precision: str, seed: int = 5, noise=(0.667, 0.8)):
    """(graphed engine, eager engine): one model at the published widths,
    the same generator seed, the second held to its eager stages."""
    cfg = Config.from_json(os.path.join(ROOT, "examples", "baker", "configs",
                                        CONFIGS[name]))
    cfg.num_phones, cfg.num_speakers = N_PHONES, N_SPEAKERS
    model = random_init_(Synthesizer(cfg), 1234)
    # random weights predict about a frame a phone; length_scale 5 brings
    # the frames near speech's
    made = [SynthesisEngine(cfg, model, PHONES, SPEAKERS, seed=seed,
                            noise_scale=noise[0], length_scale=5.0,
                            noise_scale_w=noise[1],
                            precision={"half": "bf16"}.get(precision,
                                                           precision))
            for _ in range(2)]
    made[1]._encode_flow = made[1]._encode_flow_eager
    return made


def batch(rng, b: int, lo: int, hi: int):
    ids = [[0] + [int(i) for i in rng.integers(1, N_PHONES,
                                               int(rng.integers(lo, hi)))]
           for _ in range(b)]
    return ids, [int(s) for s in rng.integers(0, N_SPEAKERS, b)]


@pytest.mark.parametrize("name,precision", [
    ("vits_v1", "f32"), ("vits_v1", "half"), ("vits2_vocos_v1", "f32")])
def test_graphed_stages_equal_the_eager_ones(cuda, name, precision):
    """Per key (B 1 and 8; text buckets 32 and 128) three calls of other
    rows: the eager first, the capture, a replay. Each call's z, y_len and
    g and then its audio through `synthesize_ids_batch` against the eager
    engine's, and both generators' states after each."""
    graphed, eager = engines(name, precision)
    rng = np.random.default_rng(11)
    worst_audio = 0.0
    for b in (1, 8):
        for lo, hi in ((16, 31), (70, 127)):
            for _ in range(3):
                ids, sids = batch(rng, b, lo, hi)
                z, y_len, g = graphed._encode_flow(ids, sids)
                want_z, want_len, want_g = eager._encode_flow(ids, sids)
                assert torch.equal(y_len, want_len)
                assert z.dtype == want_z.dtype and torch.equal(z, want_z), (
                    (z.float() - want_z.float()).abs().max().item())
                assert (g is None) == (want_g is None)
                assert g is None or torch.equal(g, want_g)
                assert torch.equal(graphed.generator.get_state(),
                                   eager.generator.get_state())
                got = graphed.synthesize_ids_batch(ids, sids)
                want = eager.synthesize_ids_batch(ids, sids)
                assert [a.shape for a in got] == [a.shape for a in want]
                for a, w in zip(got, want):
                    worst_audio = max(worst_audio,
                                      float(np.abs(a - w).max()))
                assert torch.equal(graphed.generator.get_state(),
                                   eager.generator.get_state())
    rep = graphed.stage_times.report()
    calls = 2 * 2 * 3 * 2  # B, buckets, rows, calls a row
    print(f"\ngraphs {name} {precision}: audio max |graphed - eager| "
          f"{worst_audio!r}; captures {rep['graph_capture']['n']}, "
          f"replays {rep['graph_replay']['n']} of {2 * calls} stages")
    assert worst_audio == 0.0
    assert rep["encode"]["n"] == calls
    assert rep["graph_replay"]["n"] >= calls


def test_a_repeated_key_replays_without_a_capture(cuda):
    # no noise: every call of the rows realizes the same lengths, so the
    # same frame bucket
    graphed, _ = engines("vits_v1", "f32", noise=(0.0, 0.0))
    rng = np.random.default_rng(3)
    ids, sids = batch(rng, 8, 70, 127)
    for _ in range(2):
        graphed._encode_flow(ids, sids)
    rep = graphed.stage_times.report()
    captures, replays = rep["graph_capture"]["n"], rep["graph_replay"]["n"]
    assert captures == 2 and replays == 2
    graphed._encode_flow(ids, sids)
    rep = graphed.stage_times.report()
    assert rep["graph_capture"]["n"] == captures
    assert rep["graph_replay"]["n"] == replays + 2


def test_a_returned_z_survives_the_next_replay(cuda):
    """The rows of a replayed call, then the same rows in reverse order:
    the same key and frame bucket (no noise), so both graphs replay and
    rewrite their outputs; the first call's z and g stay as they were."""
    graphed, _ = engines("vits_v1", "f32", noise=(0.0, 0.0))
    rng = np.random.default_rng(4)
    ids, sids = batch(rng, 8, 70, 127)
    for _ in range(2):  # eager, then the capture
        graphed._encode_flow(ids, sids)
    z, _, g = graphed._encode_flow(ids, sids)
    z_was, g_was = z.clone(), g.clone()
    z_next, _, _ = graphed._encode_flow(ids[::-1], sids[::-1])
    torch.cuda.synchronize()
    assert graphed.stage_times.report()["graph_replay"]["n"] == 6
    assert not torch.equal(z_next, z_was)
    assert torch.equal(z, z_was) and torch.equal(g, g_was)

"""Data parallelism in the port (`parallel/mesh.py`, `train/step.py`,
`train/trainer.py`, `bin/train_vits.py --multihost`) on the CPU over gloo.

- Two ranks of 4 rows each take one step of the JAX DP test's
  configuration (tests/test_dp_equivalence.py: `_dryrun_config` with the
  duration and WavLM discriminators on, its stand-in feature function, Adam
  eps 1e-2, text lengths [16, 14, 16, 12, 16, 15, 13, 16]) and must equal
  one rank on the 8 rows at that test's bounds: metrics rel 2e-4,
  parameters max abs 2e-6. A second case turns on the noise-scaled MAS
  at 2.0, whose noise scales with the std of the global batch's scores
  (a tenth more or less moves the alignment), and cuts the rows' frames
  unequally between the ranks (82 and 93 valid frames), so that a mean
  of the ranks' KL terms would not be the global batch's.
- The same two ranks under tests/torch_port_common.py's shared draws
  (each rank's rows of the global batch's pattern, through
  `ops/random.py`) against the JAX package on the global batch: the loss
  terms that divide by a mask sum or take the batch's mean (the KL, the
  duration loss, the mel loss) against the JAX forward and its losses, and
  (`slow`, the JAX step's jit takes minutes) every metric and parameter
  against one call of the jitted JAX step, at the JAX DP test's bounds.
- A draw inside `sharded(rank, world)` equals the rank's rows of the
  one-rank draw of the global batch.
- Ranks whose batches differ in shape raise in `train_step`; the trainer
  pads every rank's text to the widest rank's.
- `bin/train_vits --device cpu --multihost` as two processes takes a step
  on a corpus whose ranks pad their text to different widths: both exit 0,
  rank 0 alone writes the checkpoint, both ranks hold the same parameters.
"""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# __graft_entry__._dryrun_config, the configuration of the JAX DP test
DRYRUN = {
    "train": {"segment_size": 256, "batch_size": 8, "eps": 1e-2},
    "data": {"filter_length": 128, "hop_length": 16, "win_length": 128,
             "n_mel_channels": 20},
    "model": {
        "inter_channels": 32, "hidden_channels": 32,
        "filter_channels": 64, "n_heads": 2, "n_layers": 1,
        "kernel_size": 3, "p_dropout": 0.1, "resblock": "2",
        "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1, 3]],
        "upsample_rates": [4, 4], "upsample_initial_channel": 64,
        "upsample_kernel_sizes": [8, 8], "gin_channels": 16,
        "use_duration_discriminator": True, "use_wd": True,
        "slm_hidden": 8, "slm_nlayers": 2, "slm_initial_channel": 8,
    },
    "num_phones": 128, "num_speakers": 4,
}
# case -> (the model's overrides, frames cut from each row's 24)
CASES = {
    "jax_dp_test": ({}, [0] * 8),
    "noise_scaled_mas_unequal_frames": (
        {"use_noise_scaled_mas": True, "mas_noise_scale_initial": 2.0},
        [0, 6, 0, 8, 0, 1, 0, 2]),
}
TEXT_LENGTHS = [16, 14, 16, 12, 16, 15, 13, 16]
WORLD = 2


def config_dict(case: str) -> dict:
    d = copy.deepcopy(DRYRUN)
    d["model"].update(CASES[case][0])
    return d


def config(case: str):
    from wetts_tpu_torch.config import Config

    return Config.from_dict(config_dict(case))


def global_batch(cfg, case: str = "jax_dp_test") -> dict:
    b = len(TEXT_LENGTHS)
    t_spec = cfg.train.segment_size // cfg.data.hop_length + 8
    rnd = np.random.default_rng(7)
    return {
        "phone_ids": torch.from_numpy(rnd.integers(
            1, cfg.num_phones, (b, 16))).long(),
        "text_lengths": torch.tensor(TEXT_LENGTHS),
        "wav": torch.from_numpy((rnd.standard_normal(
            (b, t_spec * cfg.data.hop_length)) * 0.2).astype(np.float32)),
        "spec_lengths": t_spec - torch.tensor(CASES[case][1]),
        "sid": torch.arange(b) % cfg.num_speakers,
    }


def slm_projection(cfg) -> np.ndarray:
    feat = cfg.model.slm_hidden * cfg.model.slm_nlayers
    return (np.sin(np.arange(64 * feat, dtype=np.float32))
            .reshape(64, feat) * 0.1)


def slm_feature_fn(cfg):
    """The JAX DP test's stand-in for the frozen WavLM: frame, project."""
    proj = torch.from_numpy(slm_projection(cfg))

    def fn(wav):
        b, t = wav.shape[0], wav.shape[1]
        return wav[:, :(t // 64) * 64, 0].reshape(b, t // 64, 64) @ proj

    return fn


def initial_state(cfg):
    from wetts_tpu_torch.train.state import GANTrainState
    from wetts_tpu_torch.train.step import build_models, init_weights_

    net_g, net_d, net_dur_d, net_wd = build_models(cfg)
    init_weights_(net_g, net_d, torch.Generator().manual_seed(0), net_dur_d,
                  net_wd)
    return GANTrainState.create(cfg, net_g, net_d, net_dur_d, net_wd)


def one_step(case: str, rows: slice):
    """One step from the seeded init on `rows` of the global batch, with
    the step's generator and torch's default one seeded alike."""
    from wetts_tpu_torch.train.step import train_step

    cfg = config(case)
    state = initial_state(cfg)
    batch = {k: v[rows] for k, v in global_batch(cfg, case).items()}
    torch.manual_seed(5)
    metrics = train_step(cfg, state, batch, torch.Generator().manual_seed(3),
                         slm_feature_fn=slm_feature_fn(cfg))
    params = {f"{name}.{k}": v.detach().clone()
              for name, net, _ in state.nets()
              for k, v in net.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, params


def share_the_shared_draws() -> None:
    """tests/torch_port_common.py:patch_shared_draws's port side (the same
    patterns, no dropout), drawn through `ops/random.py`'s `_draw`: inside
    a sharded step a rank gets its rows of the global batch's pattern."""
    from torch_port_common import normal_pattern, sdp_pattern, uniform_pattern

    from wetts_tpu_torch.ops import random as port_random

    def source(pattern):
        def draw(shape, generator=None, device=None, dtype=None):
            return torch.from_numpy(pattern(*shape)).to(device, dtype)
        return draw

    def normal_of(b, c, t):
        return sdp_pattern(b, t) if c == 2 else normal_pattern(b, c, t)

    port_random.normal = (
        lambda shape, device, dtype=torch.float32, generator=None:
        port_random._draw(source(normal_of), shape, device, dtype, generator))
    port_random.uniform = (
        lambda shape, device, dtype=torch.float32, generator=None:
        port_random._draw(source(uniform_pattern), shape, device, dtype,
                          generator))
    port_random.dropout = lambda x, p, training, generator=None: x


def _rank(rank: int, case: str, port: int, out: str,
          shared_draws: bool = False) -> None:
    torch.set_num_threads(1)
    if shared_draws:
        share_the_shared_draws()
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=WORLD,
        rank=rank)
    try:
        b = len(TEXT_LENGTHS) // WORLD
        metrics, params = one_step(case, slice(rank * b, (rank + 1) * b))
        torch.save({"metrics": metrics, "params": params},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_equal_one_rank_on_the_global_batch(case, tmp_path):
    mp.spawn(_rank, args=(case, free_port(), str(tmp_path)), nprocs=WORLD)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    metrics1, params1 = one_step(case, slice(None))

    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in r["params"].items():
            assert torch.equal(v, ranks[0]["params"][k]), k
    metrics2 = ranks[0]["metrics"]
    assert set(metrics2) == set(metrics1)
    if config(case).model.use_noise_scaled_mas:
        assert metrics1["train/mas_noise_scale"] == 2.0
    for k in metrics1:
        assert metrics2[k] == pytest.approx(metrics1[k], rel=2e-4,
                                            abs=2e-4), k
    worst = max((float((params1[k] - v).abs().max()), k)
                for k, v in ranks[0]["params"].items())
    assert worst[0] < 2e-6, worst
    # the step moved the parameters far beyond the bound
    init = {f"{name}.{k}": v for name, net, _ in
            initial_state(config(case)).nets()
            for k, v in net.named_parameters()}
    moved = max(float((params1[k] - init[k]).abs().max()) for k in init)
    assert moved > 100 * 2e-6


# ---- against the JAX package on the global batch ---------------------------


@pytest.fixture(scope="module")
def shared_draw_ranks(tmp_path_factory):
    """case -> a function that waits for rank 0's (metrics, parameters) of
    the two ranks' step under the shared draws (both ranks' metrics equal).
    The ranks start at the first call for a case, once, and run while the
    caller computes the JAX side."""
    runs = {}

    def start(case):
        if case not in runs:
            out = tmp_path_factory.mktemp(f"shared_draws_{case}")
            runs[case] = [mp.spawn(_rank, nprocs=WORLD, join=False, args=(
                case, free_port(), str(out), True)), out, None]

        def wait():
            run = runs[case]
            if run[2] is None:
                while not run[0].join():
                    pass
                ranks = [torch.load(run[1] / f"rank{r}.pt")
                         for r in range(WORLD)]
                assert ranks[1]["metrics"] == ranks[0]["metrics"]
                run[2] = ranks[0]["metrics"], ranks[0]["params"]
            return run[2]

        return wait

    return start


def state_to_jax(state, cfg, jcfg):
    """The port state's four nets as the JAX package's trees, through its
    own converters."""
    from wetts_tpu.utils.convert import (
        convert_discriminator,
        convert_duration_discriminator,
        convert_synthesizer,
        convert_wavlm_discriminator,
    )

    def numpy_of(net):
        return {k: v.detach().numpy().copy()
                for k, v in net.state_dict().items()}

    return (convert_synthesizer(numpy_of(state.net_g), jcfg),
            convert_discriminator(numpy_of(state.net_d)),
            convert_duration_discriminator(
                numpy_of(state.net_dur_d),
                cfg.model.duration_discriminator_type),
            convert_wavlm_discriminator(numpy_of(state.net_wd)))


def jax_inputs(cfg, jcfg, case: str):
    import jax.numpy as jnp

    from wetts_tpu.train.step import compute_spec

    batch = {k: jnp.asarray(v.numpy(), jnp.float32 if k == "wav"
                            else jnp.int32)
             for k, v in global_batch(cfg, case).items()}
    return batch, compute_spec(jcfg, batch["wav"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_loss_terms_equal_jax_on_the_global_batch(
        case, shared_draw_ranks, monkeypatch):
    """The global normalisers: under the shared draws, the two ranks'
    `loss/kl` (over the global mask sum), `loss/dur` (the global sum of the
    rows' mask-normalised terms) and `loss/mel` (the global mean) equal
    the JAX forward's on the global batch with the JAX package's losses, at
    the JAX DP test's bound (rel 2e-4); the MAS noise's std is the global
    batch's in the noise-scaled case, whose alignment it moves."""
    import jax
    import jax.numpy as jnp
    from torch_port_common import patch_shared_draws

    from wetts_tpu.config import Config as JaxConfig
    from wetts_tpu.models.synthesizer import Synthesizer as JaxSynthesizer
    from wetts_tpu.ops.masking import slice_segments
    from wetts_tpu.ops.spectral import mel_spectrogram, spec_to_mel
    from wetts_tpu.train.losses import kl_loss

    from wetts_tpu_torch.train.step import mas_noise_scale

    ranks = shared_draw_ranks(case)
    cfg = config(case)
    jcfg = JaxConfig.from_dict(config_dict(case))
    params_g = state_to_jax(initial_state(cfg), cfg, jcfg)[0]
    model = JaxSynthesizer.from_config(jcfg)
    patch_shared_draws(monkeypatch)
    batch, spec = jax_inputs(cfg, jcfg, case)
    key = jax.random.PRNGKey(0)  # every draw is patched
    scale = mas_noise_scale(cfg, 0)
    d, t = jcfg.data, jcfg.train

    @jax.jit
    def losses(params):
        o = model.apply({"params": params}, batch["phone_ids"],
                        batch["text_lengths"], spec, batch["spec_lengths"],
                        batch["sid"], scale,
                        rngs={"noise": key, "dropout": key, "slice": key})
        mel = spec_to_mel(spec, d.filter_length, d.n_mel_channels,
                          d.sampling_rate, d.mel_fmin, d.mel_fmax)
        y_mel = slice_segments(mel, o["ids_slice"],
                               t.segment_size // d.hop_length)
        y_hat_mel = mel_spectrogram(
            o["audio"][:, :, 0], d.filter_length, d.n_mel_channels,
            d.sampling_rate, d.hop_length, d.win_length, d.mel_fmin,
            d.mel_fmax)
        return {"loss/dur": jnp.sum(o["l_length"].astype(jnp.float32)),
                "loss/mel": jnp.mean(jnp.abs(y_mel - y_hat_mel)) * t.c_mel,
                "loss/kl": kl_loss(o["z_p"], o["logs_q"], o["m_p"],
                                   o["logs_p"], o["y_mask"]) * t.c_kl}

    want = {k: float(v) for k, v in losses(params_g).items()}
    metrics, _ = ranks()
    assert metrics.get("train/mas_noise_scale", 0.0) == scale
    if cfg.model.use_noise_scaled_mas:
        assert scale == 2.0
    for k, v in want.items():
        assert metrics[k] == pytest.approx(v, rel=2e-4, abs=2e-4), k


@pytest.mark.slow  # the JAX step's jit takes minutes, as v1's steps do
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_equal_the_jax_step_on_the_global_batch(
        case, shared_draw_ranks, monkeypatch):
    """The two ranks' step under the shared draws against one call of the
    jitted JAX step (`make_train_step`, the JAX DP test's stand-in feature
    function) on the global batch from the same initial weights: every
    metric within rel 2e-4 and every parameter of the four nets within
    2e-6, the JAX DP test's bounds."""
    import jax
    import jax.numpy as jnp
    from torch_port_common import patch_shared_draws

    from wetts_tpu.config import Config as JaxConfig
    from wetts_tpu.train.state import GANTrainState as JaxTrainState
    from wetts_tpu.train.state import make_optimizer
    from wetts_tpu.train.step import build_models, make_train_step

    ranks = shared_draw_ranks(case)
    cfg = config(case)
    jcfg = JaxConfig.from_dict(config_dict(case))
    init = state_to_jax(initial_state(cfg), cfg, jcfg)
    net_g, net_d, net_dur_d, net_wd = build_models(jcfg)
    proj = jnp.asarray(slm_projection(cfg))

    def jax_feature_fn(wav):
        b, t = wav.shape[0], wav.shape[1]
        return wav[:, :(t // 64) * 64, 0].reshape(b, t // 64, 64) @ proj

    tx = make_optimizer(jcfg)
    patch_shared_draws(monkeypatch)
    step = jax.jit(make_train_step(jcfg, net_g, net_d, net_dur_d, tx,
                                   net_wd, jax_feature_fn,
                                   use_fast_decoder=False))
    batch, _ = jax_inputs(cfg, jcfg, case)
    jstate, want = step(JaxTrainState.create(tx, *init), batch,
                        jax.random.PRNGKey(0))
    metrics, params = ranks()
    assert set(want) == set(metrics)
    for k in want:
        assert metrics[k] == pytest.approx(float(want[k]), rel=2e-4,
                                           abs=2e-4), k

    port = initial_state(cfg)
    for name, net, _ in port.nets():
        net.load_state_dict({k: params.get(f"{name}.{k}", v) for k, v in
                             net.state_dict().items()})
    got = state_to_jax(port, cfg, jcfg)
    worst = (0.0, None)
    for tree, g, w in zip(("g", "d", "dur_d", "wd"), got,
                          (jstate.params_g, jstate.params_d,
                           jstate.params_dur_d, jstate.params_wd)):
        flat_g = jax.tree_util.tree_flatten_with_path(g)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(w)[0]
        assert len(flat_g) == len(flat_w), tree
        for (path, a), (_, b) in zip(flat_g, flat_w):
            err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
            worst = max(worst, (err, tree + jax.tree_util.keystr(path)))
    assert worst[0] < 2e-6, worst


def test_a_sharded_draw_is_the_ranks_rows_of_the_global_draw():
    from wetts_tpu_torch.ops import random
    from wetts_tpu_torch.parallel.mesh import current_shard, sharded

    x = torch.ones(8, 3, 5)
    full = (random.normal((8, 3, 5), "cpu",
                          generator=torch.Generator().manual_seed(1)),
            random.uniform((8,), "cpu",
                           generator=torch.Generator().manual_seed(2)),
            random.dropout(x, 0.5, True, torch.Generator().manual_seed(3)))
    for rank in range(2):
        rows = slice(4 * rank, 4 * rank + 4)
        with sharded(rank, 2):
            assert current_shard() == (rank, 2)
            part = (
                random.normal((4, 3, 5), "cpu",
                              generator=torch.Generator().manual_seed(1)),
                random.uniform((4,), "cpu",
                               generator=torch.Generator().manual_seed(2)),
                random.dropout(x[rows], 0.5, True,
                               torch.Generator().manual_seed(3)))
        for want, got in zip(full, part):
            assert torch.equal(got, want[rows])
    assert current_shard() == (0, 1)


@pytest.mark.parametrize("device, flags, env, gpus, backend, local", [
    ("cpu", ("h:1", 2, 1), {}, 0, "gloo", None),
    (None, ("h:1", 1, 0), {}, 1, "nccl", 0),
    # two processes on one GPU: NCCL refuses them
    (None, ("h:1", 2, 1), {}, 1, "gloo", 0),
    # torchrun, two hosts of 8: this host's 8 processes on its 8 GPUs
    (None, (None, None, None), {"RANK": "9", "WORLD_SIZE": "16",
                                "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "8"},
     8, "nccl", 1),
])
def test_init_distributed_picks_the_backend_and_device(
        monkeypatch, device, flags, env, gpus, backend, local):
    import torch.distributed as dist

    from wetts_tpu_torch.parallel.mesh import init_distributed

    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.update(device=d))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    dev = init_distributed(*flags, device=device)
    assert seen["backend"] == backend
    if local is None:
        assert dev == torch.device("cpu") and "device" not in seen
    else:
        assert dev == seen["device"] == torch.device("cuda", local)


def test_global_statistics_outside_a_sharded_step_are_local():
    from wetts_tpu_torch.parallel.mesh import global_std, global_sum

    x = torch.randn(4, 7, generator=torch.Generator().manual_seed(0))
    assert global_sum(x) is x
    assert torch.equal(global_std(x), torch.std(x, correction=0))


def _unequal_rank(rank: int, port: int, out: str) -> None:
    """Rank 0's rows padded to 16 phones and rank 1's to 32, as each rank's
    sampler pads to its own longest row."""
    from wetts_tpu_torch.data.sampler import Batch
    from wetts_tpu_torch.train.step import train_step
    from wetts_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=WORLD,
        rank=rank)
    try:
        cfg = config("jax_dp_test")
        b = len(TEXT_LENGTHS) // WORLD
        feed = {k: v[rank * b:(rank + 1) * b]
                for k, v in global_batch(cfg).items()}
        width = 16 * (rank + 1)
        feed["phone_ids"] = torch.nn.functional.pad(feed["phone_ids"],
                                                    (0, width - 16))
        try:
            train_step(cfg, initial_state(cfg), feed,
                       torch.Generator().manual_seed(3))
            raised = None
        except ValueError as e:
            raised = str(e)
        host = Batch(**{k: feed[k].numpy() for k in (
            "phone_ids", "text_lengths", "wav", "spec_lengths", "sid")},
            wav_lengths=feed["spec_lengths"].numpy() * cfg.data.hop_length)
        padded = Trainer._pad_text_globally(host)
        torch.save({"raised": raised, "padded": padded.phone_ids,
                    "own": host.phone_ids},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def test_ranks_of_unequal_shapes_raise_and_the_trainer_pads_them(tmp_path):
    mp.spawn(_unequal_rank, args=(free_port(), str(tmp_path)), nprocs=WORLD)
    for r in range(WORLD):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert got["raised"] and "differs in shape" in got["raised"], r
        own, padded = got["own"], got["padded"]
        assert padded.shape == (own.shape[0], 32)
        np.testing.assert_array_equal(padded[:, :own.shape[1]], own)
        assert not padded[:, own.shape[1]:].any()


def test_train_cli_multihost_two_processes(tmp_path):
    from test_torch_train import TINY, make_dataset

    from wetts_tpu_torch.train import checkpoint as ckpt

    manifest, pt, st = make_dataset(tmp_path, n=4)
    # one utterance of 20 phones: its rank pads its text to 32, the other
    # rank to 16, and the trainer pads both to 32
    with open(manifest) as f:
        lines = f.read().splitlines()
    lines[0] = lines[0].rsplit("|", 1)[0] + "|" + " ".join(["p1"] * 20)
    with open(manifest, "w") as f:
        f.write("\n".join(lines))
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(TINY))
    model_dir = tmp_path / "exp"
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "wetts_tpu_torch.bin.train_vits",
         "-c", str(cfg_path), "-m", str(model_dir), "--train_data", manifest,
         "--phone_table", pt, "--speaker_table", st, "--max_steps", "1",
         "--device", "cpu", "--multihost", "--coordinator",
         f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
         str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    digests = []
    for r, out in enumerate(outs):
        (line,) = [ln for ln in out.splitlines()
                   if ln.startswith(f"rank {r} of 2: step 1,")]
        digests.append(line.split()[-1])
    assert digests[0] == digests[1]
    assert ckpt.saved_steps(str(model_dir)) == [1]
    with open(model_dir / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1]  # rank 0 alone logs

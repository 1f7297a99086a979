"""The training slice of the port as a whole, on the CPU in f32 at
`small_cfg` size: the training forward and a 2-step D-then-G update against
`wetts_tpu` with shared draws, the weight-norm rule across a training step,
and the `Trainer` with its checkpoints and its CLI.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    JaxConfig,
    jax_discriminator,
    jax_synthesizer,
    patch_shared_draws,
    port_discriminator,
    port_synthesizer,
    small_cfg_dict,
    train_batch,
)
from wetts_tpu.ops.spectral import spectrogram as jax_spectrogram
from wetts_tpu.train.state import GANTrainState as JaxTrainState
from wetts_tpu.train.state import make_optimizer as jax_make_optimizer
from wetts_tpu.train.step import make_train_step
from wetts_tpu.utils.convert import convert_discriminator, convert_synthesizer
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.train import checkpoint as ckpt
from wetts_tpu_torch.train.state import GANTrainState, epoch_lr
from wetts_tpu_torch.train.step import (
    build_models,
    eval_step,
    init_weights_,
    train_step,
)
from wetts_tpu_torch.train.trainer import Trainer
from wetts_tpu_torch.utils.wav import write_wav

METRICS = ("loss/disc", "loss/gen", "loss/fm", "loss/mel", "loss/dur",
           "loss/kl", "loss/g_total", "grad_norm/g", "grad_norm/d")


def parity_cfg():
    """small_cfg with dropout off in the config (the SDP's hard-coded 0.5 is
    patched off), 20 mel channels and a large Adam eps: with the production
    eps = 1e-9 the first AdamW update is lr * sign(grad), and parameters
    whose gradient is zero up to float noise flip sign between frameworks
    (tests/test_update_parity.py's docstring)."""
    cfg = small_cfg_dict(p_dropout=0.0)
    cfg["data"]["n_mel_channels"] = 20
    cfg["train"]["eps"] = 1e-2
    return cfg


def torch_batch(batch):
    x, xl, wav, yl, sid = batch
    return {"phone_ids": torch.from_numpy(x), "wav": torch.from_numpy(wav),
            "text_lengths": torch.from_numpy(xl),
            "spec_lengths": torch.from_numpy(yl),
            "sid": torch.from_numpy(sid)}


def jax_batch(batch):
    x, xl, wav, yl, sid = batch
    return {"phone_ids": jnp.asarray(x, jnp.int32), "wav": jnp.asarray(wav),
            "text_lengths": jnp.asarray(xl, jnp.int32),
            "spec_lengths": jnp.asarray(yl, jnp.int32),
            "sid": jnp.asarray(sid, jnp.int32)}


# ---- against the JAX package ----------------------------------------------


def test_training_forward_matches_jax(monkeypatch):
    """Synthesizer.forward in training form, shared draws, dropout off:
    `attn` and `ids_slice` exactly equal, audio within atol 2e-4, the
    duration loss and the flow statistics within atol 1e-4."""
    cfg = parity_cfg()
    model, params = jax_synthesizer(cfg)
    port = port_synthesizer(cfg, params).train()
    patch_shared_draws(monkeypatch)
    batch = train_batch(cfg)
    x, xl, wav, yl, sid = batch
    d = cfg["data"]
    spec = np.array(jax_spectrogram(jnp.asarray(wav), d["filter_length"],
                                    d["hop_length"], d["win_length"]))
    key = jax.random.PRNGKey(0)
    feed = jax_batch(batch)
    want = model.apply(
        params, feed["phone_ids"], feed["text_lengths"], jnp.asarray(spec),
        feed["spec_lengths"], feed["sid"],
        rngs={"noise": key, "dropout": key, "slice": key})
    got = port(torch.from_numpy(x), torch.from_numpy(xl),
               torch.from_numpy(spec), torch.from_numpy(yl),
               torch.from_numpy(sid))
    assert set(got) == set(want)
    got = {k: v.detach().numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["attn"], np.asarray(want["attn"]))
    np.testing.assert_array_equal(got["ids_slice"],
                                  np.asarray(want["ids_slice"]))
    assert got["ids_slice"].min() > 0  # the slice offsets are exercised
    assert got["attn"].sum() == yl.sum()
    np.testing.assert_allclose(got["audio"], np.asarray(want["audio"]),
                               atol=2e-4)
    for key in ("l_length", "z", "z_p", "m_p", "logs_p", "m_q", "logs_q",
                "x_hidden", "logw", "logw_", "x_mask", "y_mask", "g"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)


def _tree_compare(got_tree, want_tree, atol, label):
    got_flat = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want_flat = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got_flat) == len(want_flat)
    worst = (0.0, None)
    for (kp, g), (_, w) in zip(got_flat, want_flat):
        err = float(np.max(np.abs(np.asarray(g) - np.asarray(w))))
        if err > worst[0]:
            worst = (err, jax.tree_util.keystr(kp))
    assert worst[0] < atol, (
        f"{label}: max param error {worst[0]:.3e} at {worst[1]}")
    return worst[0]


@pytest.mark.slow  # the un-jitted JAX steps alone take over three minutes
def test_two_step_update_parity(monkeypatch):
    """2 D-then-G AdamW updates of the port == 2 calls of the un-jitted
    `make_train_step(..., use_fast_decoder=False)`: per-step metrics within
    abs/rel 5e-4, updated G and D parameters within atol 2e-5 (updates are
    O(lr) = 2e-4 per step). The port's state_dicts go back through the JAX
    package's own converters, which raise on any tensor they cannot map."""
    cfg = parity_cfg()
    jcfg = JaxConfig.from_dict(copy.deepcopy(cfg))
    pcfg = Config.from_dict(copy.deepcopy(cfg))
    model, params = jax_synthesizer(cfg)
    net_d, params_d = jax_discriminator()
    port_g = port_synthesizer(cfg, params)
    port_d = port_discriminator(params_d)
    patch_shared_draws(monkeypatch)
    batch = train_batch(cfg)

    tx = jax_make_optimizer(jcfg)
    step_fn = make_train_step(jcfg, model, net_d, None, tx,
                              use_fast_decoder=False)
    jstate = JaxTrainState.create(tx, params["params"], params_d["params"])
    state = GANTrainState.create(pcfg, port_g, port_d)
    rng = jax.random.PRNGKey(0)  # every draw is patched
    for i in range(2):
        jstate, want = step_fn(jstate, jax_batch(batch), rng)
        got = train_step(pcfg, state, torch_batch(batch))
        assert set(got) == set(want) == set(METRICS)
        for key in METRICS:
            assert float(got[key]) == pytest.approx(
                float(want[key]), abs=5e-4, rel=5e-4), f"step {i + 1} {key}"
    assert state.step == 2

    got_g = convert_synthesizer(
        {k: v.detach().numpy() for k, v in port_g.state_dict().items()}, jcfg)
    got_d = convert_discriminator(
        {k: v.detach().numpy() for k, v in port_d.state_dict().items()})
    _tree_compare(got_g, jstate.params_g, 2e-5, "params_g")
    _tree_compare(got_d, jstate.params_d, 2e-5, "params_d")


# ---- the step on its own --------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """(cfg, state after one step from seeded weights, metrics, the
    generator's parameters before the step)."""
    cfg = Config.from_dict(small_cfg_dict())
    net_g, net_d, net_dur_d, net_wd = build_models(cfg)
    assert net_dur_d is None and net_wd is None
    init_weights_(net_g, net_d, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in net_g.named_parameters()}
    before_d = {k: v.clone() for k, v in net_d.named_parameters()}
    state = GANTrainState.create(cfg, net_g, net_d)
    metrics = train_step(cfg, state, torch_batch(train_batch(small_cfg_dict())),
                         torch.Generator().manual_seed(0))
    return cfg, state, metrics, before, before_d


def test_train_step_metrics_are_finite_and_named(trained):
    _, state, metrics, _, _ = trained
    assert set(metrics) == set(METRICS) and state.step == 1
    for k, v in metrics.items():
        assert v.ndim == 0 and torch.isfinite(v), k


def test_train_step_moves_weight_normed_and_upstream_parameters(trained):
    """Both repairs at once: weight_g / weight_v of the decoder, the flow
    and the posterior encoder learn, and so does dec.conv_pre, upstream of
    every MRF stage; the discriminator moves too."""
    _, state, _, before, before_d = trained
    after = dict(state.net_g.named_parameters())
    for name in ("dec.conv_pre.weight", "dec.ups.0.weight_g",
                 "dec.ups.0.weight_v", "dec.resblocks.0.convs1.0.weight_g",
                 "dec.resblocks.3.convs2.2.weight_v",
                 "flow.flows.0.enc.in_layers.0.weight_g",
                 "flow.flows.0.enc.in_layers.0.weight_v",
                 "enc_q.enc.in_layers.0.weight_v", "enc_p.emb.weight",
                 "dp.flows.1.proj.weight", "emb_g.weight"):
        assert not torch.equal(after[name], before[name]), name
    after_d = dict(state.net_d.named_parameters())
    moved = [k for k in after_d if not torch.equal(after_d[k], before_d[k])]
    assert len(moved) == len(after_d)


def test_eval_after_a_step_uses_the_updated_weights(trained):
    """Train one step, switch to eval: Synthesizer.infer equals that of a
    fresh model loaded from the same state_dict, and the decoder's checked
    stages (what the MRF kernel reads by pointer) hold the refolded
    weights, not those from before the step."""
    cfg, state, _, _, _ = trained
    net_g = state.net_g
    stale = net_g.dec.resblocks[0].convs1[0].weight.clone()
    net_g.eval()
    fresh = Synthesizer(cfg)
    fresh.load_state_dict(net_g.state_dict())
    fresh.eval()
    x = torch.tensor([[3, 5, 7, 1, 2, 9, 11, 4]])
    xl, sid = torch.tensor([8]), torch.tensor([1])
    with torch.no_grad():
        got, got_len, _ = net_g.infer(x, xl, sid, 0.0, 1.0, 0.0, 64)
        want, want_len, _ = fresh.infer(x, xl, sid, 0.0, 1.0, 0.0, 64)
    assert torch.equal(got_len, want_len)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    conv = net_g.dec.resblocks[0].convs1[0]
    assert not torch.equal(conv.weight, stale)
    assert net_g.dec.checked_stages()[0][0][0][0] is conv.weight
    torch.testing.assert_close(
        conv.weight, fresh.dec.resblocks[0].convs1[0].weight)
    net_g.train()


def test_eval_step(trained):
    cfg, state, _, _, _ = trained
    before = {k: v.clone() for k, v in state.net_g.state_dict().items()}
    metrics = eval_step(cfg, state.net_g,
                        torch_batch(train_batch(small_cfg_dict())),
                        torch.Generator().manual_seed(0))
    assert set(metrics) == {"val/mel_l1", "val/kl", "val/dur"}
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not state.net_g.training
    for k, v in state.net_g.state_dict().items():
        assert torch.equal(v, before[k]), k
    state.net_g.train()


def test_epoch_lr_and_optimizer_settings(trained):
    cfg, state, _, _, _ = trained
    assert epoch_lr(cfg, 1) == cfg.train.learning_rate
    assert epoch_lr(cfg, 3) == pytest.approx(2e-4 * 0.999875 ** 2)
    state.set_learning_rate(epoch_lr(cfg, 3))
    for opt in (state.opt_g, state.opt_d):
        (group,) = opt.param_groups
        assert group["lr"] == epoch_lr(cfg, 3)
        assert group["betas"] == (0.8, 0.99) and group["eps"] == 1e-9
        assert group["weight_decay"] == 0.01
    state.set_learning_rate(epoch_lr(cfg, 1))


@pytest.mark.parametrize("section,flag", [
    ("train", "fp16_run"), ("train", "bf16_run"), ("model", "use_wd")])
def test_unported_training_options_raise(section, flag):
    """These three options raised while the port trained in f32 only and
    without the WavLM discriminator; now none raises and each builds what
    it asks for: bf16 compute (`fp16_run` the same toggle as `bf16_run`,
    as in the JAX config) or the WavLM discriminator at the config's
    geometry (slm_hidden 768 x slm_nlayers 13 features in, 64 channels)."""
    from wetts_tpu_torch.models.discriminators import WavLMDiscriminator
    from wetts_tpu_torch.train.step import half_precision

    cfg = small_cfg_dict()
    cfg[section][flag] = True
    cfg = Config.from_dict(cfg)
    _, _, net_dur_d, net_wd = build_models(cfg)
    assert net_dur_d is None
    assert half_precision(cfg) == (section == "train")
    if flag == "use_wd":
        assert type(net_wd) is WavLMDiscriminator
        assert net_wd.pre.weight_v.shape == (64, 768 * 13, 1)
    else:
        assert net_wd is None


@pytest.mark.parametrize("flag", ["use_mrd_disc", "use_duration_discriminator",
                                  "use_noise_scaled_mas"])
def test_vits2_training_options_build(flag):
    """Each VITS2 training option alone builds its modules: the multi-period
    multi-resolution discriminator, the duration discriminator (V1 by
    default, V2 by `duration_discriminator_type`), or a synthesizer that
    draws the MAS noise; the others stay as in VITS-base."""
    from wetts_tpu_torch.models import discriminators

    cfg = small_cfg_dict()
    cfg["model"][flag] = True
    net_g, net_d, net_dur_d, _ = build_models(Config.from_dict(cfg))
    assert type(net_d) is (
        discriminators.MultiPeriodMultiResolutionDiscriminator
        if flag == "use_mrd_disc" else discriminators.MultiPeriodDiscriminator)
    assert net_g.use_noise_scaled_mas == (flag == "use_noise_scaled_mas")
    if flag != "use_duration_discriminator":
        assert net_dur_d is None
        return
    assert type(net_dur_d) is discriminators.DurationDiscriminatorV1
    assert net_dur_d.conv_1.weight.shape == (32, 32, 3)  # filter = hidden
    cfg["model"]["duration_discriminator_type"] = "dur_disc_2"
    _, _, net_dur_d, _ = build_models(Config.from_dict(cfg))
    assert type(net_dur_d) is discriminators.DurationDiscriminatorV2


def test_init_weights_follow_the_reference(trained):
    """Identity flows (zero `post` / spline `proj`), g = ||v||, nothing else
    left at zero."""
    cfg = Config.from_dict(small_cfg_dict())
    net_g, net_d, _, _ = build_models(cfg)
    init_weights_(net_g, net_d, torch.Generator().manual_seed(1))
    sd = net_g.state_dict()
    assert not sd["flow.flows.0.post.weight"].any()
    assert not sd["dp.flows.1.proj.weight"].any()
    v, g = sd["dec.ups.0.weight_v"], sd["dec.ups.0.weight_g"]
    torch.testing.assert_close(g, v.square().sum((1, 2), keepdim=True).sqrt())
    torch.testing.assert_close(net_g.dec.ups[0].weight, v)
    zero = [k for k, t in {**sd, **net_d.state_dict()}.items()
            if not t.any() and not k.endswith(
                ("post.weight", "post.bias", "proj.weight", "proj.bias",
                 ".beta", ".m", ".logs"))]
    assert not zero, zero
    assert sd["enc_p.emb.weight"].std() == pytest.approx(32 ** -0.5, rel=0.2)


# ---- Trainer, checkpoints, CLI --------------------------------------------


def make_dataset(tmp_path, n=6, sr=8000, hop=16):
    """Synthetic sine-wave corpus + manifest + tables (tests/test_train.py)."""
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        frames = int(rng.integers(40, 80))
        t = np.arange(frames * hop) / sr
        wav = 0.5 * np.sin(2 * np.pi * (100 + 50 * i) * t)
        path = str(wav_dir / f"u{i}.wav")
        write_wav(path, wav.astype(np.float32), sr)
        phones = " ".join(f"p{int(p)}" for p in rng.integers(
            0, 8, size=int(rng.integers(5, 12))))
        lines.append(f"{path}|spk{i % 2}|{phones}")
    manifest = tmp_path / "train.txt"
    manifest.write_text("\n".join(lines))
    phone_table = tmp_path / "phones.txt"
    phone_table.write_text("\n".join(f"p{i} {i}" for i in range(8)))
    speaker_table = tmp_path / "speakers.txt"
    speaker_table.write_text("spk0 0\nspk1 1")
    return str(manifest), str(phone_table), str(speaker_table)


TINY = {
    "train": {"segment_size": 256, "batch_size": 2, "log_interval": 1,
              "eval_interval": 1000, "epochs": 10000},
    "data": {"filter_length": 128, "hop_length": 16, "win_length": 128,
             "sampling_rate": 8000, "n_mel_channels": 20},
    "model": {
        "inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
        "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1,
        "resblock": "2", "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [4, 4],
        "upsample_initial_channel": 32, "upsample_kernel_sizes": [8, 8],
        "gin_channels": 8},
}


def tiny_cfg():
    return Config.from_dict(copy.deepcopy(TINY))


def test_trainer_two_steps_and_resume(tmp_path):
    manifest, pt, st = make_dataset(tmp_path)
    model_dir = str(tmp_path / "exp")
    trainer = Trainer(tiny_cfg(), model_dir, manifest, pt, st, device="cpu")
    assert trainer.start_step == 0
    assert trainer.train(max_steps=2) == 2
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    assert [m["step"] for m in metrics] == [1, 2]
    assert all(np.isfinite(m[k]) for m in metrics for k in METRICS)
    assert metrics[0]["loss/g_total"] != metrics[1]["loss/g_total"]
    assert os.path.getsize(os.path.join(model_dir, "train.log")) > 0
    assert ckpt.latest_step(model_dir) == 2

    # resume picks up from the saved step, weights and optimiser included
    trainer2 = Trainer(tiny_cfg(), model_dir, manifest, pt, st, device="cpu")
    assert trainer2.start_step == 2
    for (k, a), b in zip(trainer.state.net_g.state_dict().items(),
                         trainer2.state.net_g.state_dict().values()):
        assert torch.equal(a, b), k
    step_of = trainer2.state.opt_d.state_dict()["state"][0]["step"]
    assert int(step_of) == 2
    assert trainer2.train(max_steps=3) == 3
    assert ckpt.saved_steps(model_dir) == [2, 3]


def test_trainer_evaluates_on_a_val_manifest(tmp_path):
    manifest, pt, st = make_dataset(tmp_path)
    model_dir = str(tmp_path / "exp")
    trainer = Trainer(tiny_cfg(), model_dir, manifest, pt, st,
                      val_manifest=manifest, device="cpu")
    trainer.evaluate(step=0, epoch=1, max_batches=1)
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert {"val/mel_l1", "val/kl", "val/dur"} <= set(rec)
    assert all(np.isfinite(rec[k]) for k in rec)


def test_trainer_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    manifest, pt, st = make_dataset(tmp_path, n=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tiny_cfg(), str(tmp_path / "exp"), manifest, pt, st)


def test_checkpoints_keep_the_newest(tmp_path):
    cfg = tiny_cfg()
    cfg.num_phones = 8
    net_g, net_d, _, _ = build_models(cfg)
    state = GANTrainState.create(cfg, net_g, net_d)
    model_dir = str(tmp_path / "exp")
    assert ckpt.latest_step(model_dir) is None
    assert ckpt.load_checkpoint(model_dir, state) is state and state.step == 0
    for step in (1, 2, 3, 10):
        ckpt.save_checkpoint(model_dir, state, step, max_to_keep=2)
    assert ckpt.saved_steps(model_dir) == [3, 10]
    assert not [f for f in os.listdir(model_dir) if f.endswith(".tmp")]
    ckpt.load_checkpoint(model_dir, state)
    assert state.step == 10
    ckpt.load_checkpoint(model_dir, state, step=3)
    assert state.step == 3


def test_train_cli_on_two_utterances(tmp_path):
    from wetts_tpu_torch.bin import train_vits

    manifest, pt, st = make_dataset(tmp_path, n=2)
    config = tmp_path / "config.json"
    config.write_text(json.dumps(TINY))
    model_dir = str(tmp_path / "exp")
    train_vits.main(["-c", str(config), "-m", model_dir, "--train_data",
                     manifest, "--phone_table", pt, "--speaker_table", st,
                     "--max_steps", "2", "--device", "cpu"])
    assert ckpt.latest_step(model_dir) == 2
    with open(os.path.join(model_dir, "config.json")) as f:
        assert json.load(f) == TINY

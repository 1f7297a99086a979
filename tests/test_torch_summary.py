"""TensorBoard summaries, eval media and the tolerant resume of the port's
trainer, on the CPU: the plot helpers against the JAX package's copy,
`Summary` writing event files, a tiny `Trainer` step with a val manifest
writing the scalars and the three media tags (read back from the event
files), the media audio against `Synthesizer.infer` at the same seed, a
checkpoint made without the duration and WavLM discriminators resumed
into a state that has them, a net's entry that lacks tensors, a shape
mismatch that raises, and a trainer where no TensorBoard writer can be
made (a warning, no summary).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import RecordingSummary
from test_torch_slm import random_wavlm, save_hf_dir
from test_torch_train import TINY, make_dataset, tiny_cfg
from torch_port_common import drop_checkpoints  # noqa: F401 (autouse)
from wetts_tpu.utils import summary as jax_summary
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.wavlm import WavLMConfig
from wetts_tpu_torch.train import checkpoint as ckpt
from wetts_tpu_torch.train.state import GANTrainState
from wetts_tpu_torch.train.step import build_models, init_weights_
from wetts_tpu_torch.train.trainer import MEDIA_SCALES, Trainer
from wetts_tpu_torch.utils import summary

MEDIA_TAGS = {"gen/audio", "gen/mel", "gen/alignment"}


def test_plot_helpers_equal_the_jax_copy():
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((20, 64))
    attn = np.abs(rng.standard_normal((30, 12)))
    for fn in ("plot_spectrogram_to_numpy", "plot_alignment_to_numpy"):
        arg = spec if fn.startswith("plot_spec") else attn
        got = getattr(summary, fn)(arg)
        assert got.ndim == 3 and got.shape[2] == 3 and got.dtype == np.uint8
        np.testing.assert_array_equal(got, getattr(jax_summary, fn)(arg))


def test_plot_helpers_without_matplotlib(monkeypatch):
    """The colormap fallback (the card's machine has no matplotlib)."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    spec = np.random.default_rng(1).standard_normal((8, 16))
    got = summary.plot_spectrogram_to_numpy(spec)
    assert got.shape == (8, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, jax_summary.plot_spectrogram_to_numpy(spec))


def test_summary_writes_event_files(tmp_path):
    pytest.importorskip("tensorboard")
    s = summary.Summary(str(tmp_path))
    s.scalars(1, {"loss/g_total": 1.5, "lr": 2e-4})
    s.image(1, "gen/mel", summary.plot_spectrogram_to_numpy(
        np.zeros((8, 16))))
    s.audio(1, "gen/audio", np.zeros(800, np.float32), 8000)
    s.flush()
    s.close()
    files = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    assert files and os.path.getsize(tmp_path / files[0]) > 0


def media_cfg():
    cfg = tiny_cfg()
    cfg.train.eval_interval = 1  # one step, then evaluate with media
    return cfg


def test_trainer_writes_scalars_and_media_to_tensorboard(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    manifest, pt, st = make_dataset(tmp_path, n=2)
    model_dir = str(tmp_path / "exp")
    trainer = Trainer(media_cfg(), model_dir, manifest, pt, st,
                      val_manifest=manifest, device="cpu")
    assert isinstance(trainer.summary, summary.Summary)
    assert trainer.train(max_steps=1) == 1
    trainer.summary.close()
    events = EventAccumulator(os.path.join(model_dir, "tb"),
                              size_guidance={"audio": 0, "images": 0})
    events.Reload()
    tags = events.Tags()
    assert {"loss/g_total", "loss/disc", "loss/mel", "grad_norm/g",
            "steps_per_s", "val/mel_l1", "val/kl", "val/dur"} <= set(
        tags["scalars"])
    assert {"gen/mel", "gen/alignment"} <= set(tags["images"])
    assert "gen/audio" in tags["audio"]
    (g_total,) = events.Scalars("loss/g_total")
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert g_total.step == 1
    assert g_total.value == pytest.approx(rec["loss/g_total"], rel=1e-6)


def test_media_audio_equals_infer_at_the_same_seed(tmp_path):
    """The recorded `gen/audio` is `Synthesizer.infer` of the first val
    utterance at MEDIA_SCALES and max_frames 16 * segment / hop, noise from
    a generator seeded 0, cut to its length; the alignment image is
    [frames, T_text] (the plot transposes [T_spec, T_text])."""
    manifest, pt, st = make_dataset(tmp_path, n=2)
    rec = RecordingSummary()
    trainer = Trainer(media_cfg(), str(tmp_path / "exp"), manifest, pt, st,
                      val_manifest=manifest, device="cpu", summary=rec)
    assert trainer.train(max_steps=1) == 1
    assert [tag for _, tag, _, _ in rec.audio_clips] == ["gen/audio"]
    assert {tag for _, tag, _ in rec.images} == MEDIA_TAGS - {"gen/audio"}
    assert {"loss/g_total", "val/mel_l1"} <= set(rec.scalar_steps[1])
    (step, _, wav, rate), = rec.audio_clips
    assert step == 1 and rate == 8000

    cfg = trainer.cfg
    item = trainer.val_dataset.items[0]
    net_g = trainer.state.net_g.eval()
    with torch.no_grad():
        audio, y_len, attn = net_g.infer(
            torch.from_numpy(item.phone_ids).long()[None],
            torch.tensor([len(item.phone_ids)]),
            torch.tensor([trainer.val_dataset.speaker_id(item.speaker)]),
            *MEDIA_SCALES, max_frames=16 * (cfg.train.segment_size
                                            // cfg.data.hop_length),
            generator=torch.Generator().manual_seed(0))
    frames = int(y_len[0])
    np.testing.assert_array_equal(
        wav, audio[0, :frames * cfg.data.hop_length, 0].numpy())
    alignment = [img for _, tag, img in rec.images
                 if tag == "gen/alignment"][0]
    np.testing.assert_array_equal(
        alignment, summary.plot_alignment_to_numpy(attn[0, :, :frames].T))


# ---- tolerant resume -------------------------------------------------------


def vits2ish(use_wd: bool, use_dur: bool) -> Config:
    cfg = copy.deepcopy(TINY)
    wcfg = WavLMConfig.tiny()
    cfg["model"].update(use_wd=use_wd, use_duration_discriminator=use_dur,
                        slm_hidden=wcfg.hidden_size,
                        slm_nlayers=wcfg.num_layers + 1,
                        slm_initial_channel=8)
    cfg["num_phones"], cfg["num_speakers"] = 8, 2
    return Config.from_dict(cfg)


def state_of(cfg: Config, seed: int) -> GANTrainState:
    nets = build_models(cfg)
    init_weights_(nets[0], nets[1], torch.Generator().manual_seed(seed),
                  *nets[2:])
    return GANTrainState.create(cfg, *nets)


def stepped(state: GANTrainState):
    """Give every optimiser some state: one AdamW step on a made-up
    gradient."""
    for _, net, opt in state.nets():
        for p in net.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        opt.zero_grad(set_to_none=True)
    return state


def snapshot(net):
    return {k: v.clone() for k, v in net.state_dict().items()}


def test_resume_without_the_duration_and_wavlm_discriminators(tmp_path):
    """A checkpoint of G and D only restores them into a state that also
    has the duration and WavLM discriminators; those keep their fresh
    weights and empty optimisers."""
    old = stepped(state_of(vits2ish(False, False), seed=1))
    old.step = 7
    ckpt.save_checkpoint(str(tmp_path), old, 7)
    new = state_of(vits2ish(True, True), seed=2)
    fresh = {name: snapshot(net) for name, net, _ in new.nets()}
    ckpt.load_checkpoint(str(tmp_path), new)
    assert new.step == 7
    for name in ("net_g", "net_d"):
        for k, v in getattr(old, name).state_dict().items():
            assert torch.equal(getattr(new, name).state_dict()[k], v), k
    assert new.opt_g.state_dict()["state"].keys() == \
        old.opt_g.state_dict()["state"].keys()
    for name, opt in (("net_dur_d", new.opt_dur_d), ("net_wd", new.opt_wd)):
        for k, v in getattr(new, name).state_dict().items():
            assert torch.equal(v, fresh[name][k]), (name, k)
        assert not opt.state, name


def test_resume_keeps_what_a_net_entry_lacks(tmp_path):
    """A net's entry without one tensor (and its optimiser without that
    tensor's moments): the tensor and its moments stay fresh, every other
    tensor and moment is restored, matched by parameter name."""
    cfg = vits2ish(False, False)
    old = stepped(state_of(cfg, seed=1))
    ckpt.save_checkpoint(str(tmp_path), old, 3)
    path = tmp_path / "ckpt_3.pt"
    payload = torch.load(path, weights_only=True)
    names = payload["param_names"]["net_g"]
    gone = names.index("emb_g.weight")
    del payload["net_g"]["emb_g.weight"]
    payload["param_names"]["net_g"] = names[:gone] + names[gone + 1:]
    opt = payload["opt_g"]
    opt["state"] = {i - (i > gone): s for i, s in opt["state"].items()
                    if i != gone}
    opt["param_groups"][0]["params"] = list(range(len(names) - 1))
    torch.save(payload, path)

    new = state_of(cfg, seed=2)
    fresh_emb = new.net_g.emb_g.weight.detach().clone()
    ckpt.load_checkpoint(str(tmp_path), new)
    assert torch.equal(new.net_g.emb_g.weight, fresh_emb)
    assert torch.equal(new.net_g.enc_p.emb.weight, old.net_g.enc_p.emb.weight)
    params = dict(new.net_g.named_parameters())
    old_params = dict(old.net_g.named_parameters())
    assert params["emb_g.weight"] not in new.opt_g.state
    for name in ("enc_p.emb.weight", "dec.conv_pre.weight"):
        torch.testing.assert_close(
            new.opt_g.state[params[name]]["exp_avg"],
            old.opt_g.state[old_params[name]]["exp_avg"], rtol=0, atol=0)


def test_resume_with_a_shape_mismatch_raises(tmp_path):
    old = state_of(vits2ish(False, False), seed=1)
    ckpt.save_checkpoint(str(tmp_path), old, 1)
    cfg = vits2ish(False, False)
    cfg.model.hidden_channels = 24
    with pytest.raises(RuntimeError, match="size mismatch"):
        ckpt.load_checkpoint(str(tmp_path), state_of(cfg, seed=2))


def test_trainer_turns_on_use_wd_and_resumes(tmp_path):
    """A run made without the WavLM discriminator resumes in a `Trainer`
    with `use_wd` and an SLM dir, and takes its next step with the
    branch."""
    manifest, pt, st = make_dataset(tmp_path, n=2)
    model_dir = str(tmp_path / "exp")
    first = Trainer(vits2ish(False, False), model_dir, manifest, pt, st,
                    device="cpu", summary=RecordingSummary())
    assert first.train(max_steps=1) == 1
    slm_dir = str(tmp_path / "wavlm")
    save_hf_dir(slm_dir, random_wavlm(WavLMConfig.tiny(), seed=3))
    second = Trainer(vits2ish(True, False), model_dir, manifest, pt, st,
                     device="cpu", slm_model_dir=slm_dir,
                     summary=RecordingSummary())
    assert second.start_step == 1 and second.state.net_wd is not None
    assert second.train(max_steps=2) == 2
    assert "loss/slm_disc" in second.summary.scalar_steps[2]


def test_trainer_without_tensorboard_warns_and_trains(tmp_path, monkeypatch,
                                                      caplog):
    """Where no TensorBoard writer can be made (the card's machine has no
    `tensorboard`), the trainer logs the JAX trainer's warning and trains
    without a summary, media included."""
    import logging
    import sys

    for name in ("torch.utils.tensorboard", "tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, name, None)
    manifest, pt, st = make_dataset(tmp_path, n=2)
    with caplog.at_level(logging.WARNING):
        trainer = Trainer(media_cfg(), str(tmp_path / "exp"), manifest, pt,
                          st, val_manifest=manifest, device="cpu")
    assert "tensorboard writer unavailable" in caplog.text
    assert trainer.summary is None
    assert trainer.train(max_steps=1) == 1
    assert not os.path.exists(tmp_path / "exp" / "tb")

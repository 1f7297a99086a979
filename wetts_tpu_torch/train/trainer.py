"""Host-side training loop (port of wetts_tpu/train/trainer.py; reference
wetts/vits/train.py:37-346):

- epoch-seeded bucketed batches, per-epoch exponential LR decay,
- resume from the latest checkpoint, epoch = step // len(loader) + 1,
- periodic eval + checkpoint every eval_interval steps, scalar logging to
  `train.log`, `metrics.jsonl` and TensorBoard (`<model_dir>/tb`; under a
  VITS2 config also the duration discriminator's losses and the MAS noise
  scale), and at each eval the media of one validation utterance
  (`gen/audio`, `gen/mel`, `gen/alignment`);
- bf16 compute under `bf16_run` / `fp16_run` (`train/step.py`), the WavLM
  (SLM) discriminator under `use_wd` with a frozen WavLM read from a local
  HuggingFace model directory (`slm_model_dir`), and a tolerant resume
  (`train/checkpoint.py`).

One process drives one device. In a process group (`parallel/mesh.py`,
`bin/train_vits.py --multihost` or torchrun) the trainer is data-parallel,
as the JAX trainer over its mesh: each rank takes its strided share of
every bucket (`BucketBatcher(num_replicas=world, rank=rank)`), its text
padded to the widest rank's, so that every rank's batch has the same
shapes (the sampler pads to a multiple of 16 of each rank's own longest
row; the frames are the bucket's on every rank), every rank
starts from rank 0's parameters and optimiser state (broadcast after init
and after the resume, which every rank reads from the same file), and
`train_step` sums the gradients over the ranks. Rank 0 alone logs, writes
`metrics.jsonl` and TensorBoard, evaluates and writes the checkpoints; the
others wait for it at a barrier after each save. The trainer runs on the
GPU and raises without one unless the caller passes `device="cpu"`.

One divergence is kept on purpose: the JAX trainer's `_log_eval_media`
catches every exception and logs a warning; here only a TensorBoard writer
that cannot be made is a warning (as in the JAX package), and a failure of
the media decode on the device raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.data.dataset import TTSDataset, read_table
from wetts_tpu_torch.data.sampler import Batch, BucketBatcher
from wetts_tpu_torch.models.wavlm import (
    WavLMConfig,
    WavLMModel,
    make_slm_feature_fn,
)
from wetts_tpu_torch.ops.spectral import mel_spectrogram
from wetts_tpu_torch.parallel.mesh import (
    global_max,
    host_shard_info,
    is_distributed,
    replicate,
)
from wetts_tpu_torch.train import checkpoint as ckpt
from wetts_tpu_torch.train.state import GANTrainState, epoch_lr
from wetts_tpu_torch.train.step import (
    build_models,
    eval_step,
    init_weights_,
    train_step,
)
from wetts_tpu_torch.utils.device import resolve_device
from wetts_tpu_torch.utils.summary import (
    Summary,
    plot_alignment_to_numpy,
    plot_spectrogram_to_numpy,
)

# the eval media's synthesis scales: noise, length, duration noise
# (wetts_tpu/train/trainer.py:297-300)
MEDIA_SCALES = (0.667, 1.0, 0.8)


def get_logger(model_dir: str, rank: int = 0) -> logging.Logger:
    """A logger of its own per model directory, writing `train.log` there
    and echoing to the console; another rank's only echoes its warnings."""
    os.makedirs(model_dir, exist_ok=True)
    logger = logging.getLogger(
        f"wetts_tpu_torch.train.{os.path.abspath(model_dir)}"
        + (f".rank{rank}" if rank else ""))
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    if not logger.handlers:
        if rank == 0:
            fh = logging.FileHandler(os.path.join(model_dir, "train.log"))
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())
    return logger


class Trainer:
    def __init__(
        self,
        cfg: Config,
        model_dir: str,
        train_manifest: str,
        phone_table_path: str,
        speaker_table_path: Optional[str] = None,
        val_manifest: Optional[str] = None,
        device=None,
        slm_model_dir: Optional[str] = None,
        summary=None,
    ):
        """summary: where scalars and eval media go (an object with
        `scalars`, `image`, `audio` and `flush`, as `utils.summary.Summary`);
        None makes a `Summary` under `<model_dir>/tb`, or none, with a
        warning, where no TensorBoard writer can be made. Ranks other than
        0 of a process group keep none."""
        self.device = resolve_device(device)
        self.rank, self.world = host_shard_info()
        phone_table = read_table(phone_table_path)
        speaker_table = (read_table(speaker_table_path)
                         if speaker_table_path else None)
        cfg.num_phones = max(cfg.num_phones, max(phone_table.values()) + 1)
        if speaker_table:
            cfg.num_speakers = max(cfg.num_speakers,
                                   max(speaker_table.values()) + 1)
        self.cfg = cfg
        self.model_dir = model_dir
        self.logger = get_logger(model_dir, self.rank)
        self.metrics_path = os.path.join(model_dir, "metrics.jsonl")
        # TensorBoard scalars, images and audio on rank 0 (reference
        # train.py:509-581)
        self.summary = summary if self.rank == 0 else None
        if summary is None and self.rank == 0:
            try:
                self.summary = Summary(os.path.join(model_dir, "tb"))
            except ImportError as e:
                self.logger.warning("tensorboard writer unavailable: %s", e)

        self.dataset = TTSDataset(train_manifest, phone_table, speaker_table,
                                  cfg.data)
        self.batcher = BucketBatcher(
            self.dataset, cfg.train.batch_size, num_replicas=self.world,
            rank=self.rank, seed=cfg.train.seed)
        self.val_dataset = (
            TTSDataset(val_manifest, phone_table, speaker_table, cfg.data)
            if val_manifest else None)
        self._val_batcher: Optional[BucketBatcher] = None

        # parameters and every draw of the run derive from the config's seed
        net_g, net_d, net_dur_d, net_wd = build_models(cfg)
        self.slm_feature_fn = None
        if net_wd is not None and slm_model_dir:
            self.slm_feature_fn = self._load_slm(slm_model_dir)
        elif net_wd is not None:
            self.logger.warning(
                "use_wd is set but no --slm_model dir given; the WavLM "
                "discriminator branch is disabled for this run")
            net_wd = None
        init_weights_(net_g, net_d,
                      torch.Generator().manual_seed(cfg.train.seed),
                      net_dur_d, net_wd)

        def put(net):
            return None if net is None else net.to(self.device)

        self.state = GANTrainState.create(cfg, put(net_g), put(net_d),
                                          put(net_dur_d), put(net_wd))
        ckpt.load_checkpoint(model_dir, self.state)
        nets = list(self.state.nets())
        replicate([net for _, net, _ in nets], [opt for _, _, opt in nets])
        self.start_step = self.state.step
        # draws continue from a stream of their own after a resume; every
        # rank holds the same stream (and, in a process group, the same
        # default generator, which the duration discriminator's dropout
        # draws from)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + self.start_step)
        if is_distributed():
            torch.manual_seed(cfg.train.seed + self.start_step)

    def _load_slm(self, slm_model_dir: str):
        """The frozen WavLM's feature function, from a local HuggingFace
        model directory: `config.json` and `pytorch_model.bin` (read with
        `weights_only=True`) or `model.safetensors`. A model with a head
        has its `wavlm.` prefix stripped and its head's tensors left out;
        a missing `masked_spec_embed` (HF keeps it only for masked
        pre-training) stays at zero, unused."""
        with open(os.path.join(slm_model_dir, "config.json")) as f:
            wcfg = WavLMConfig.from_hf(json.load(f))
        for name in ("pytorch_model.bin", "model.safetensors"):
            path = os.path.join(slm_model_dir, name)
            if not os.path.exists(path):
                continue
            if name.endswith(".bin"):
                sd = torch.load(path, map_location="cpu", weights_only=True)
            else:
                from safetensors.torch import load_file

                sd = load_file(path)
            break
        else:
            raise FileNotFoundError(f"no weights under {slm_model_dir}")
        sd = {k[len("wavlm."):] if k.startswith("wavlm.") else k: v
              for k, v in sd.items()}
        model = WavLMModel(wcfg)
        missing, _ = model.load_state_dict(sd, strict=False)
        missing = [k for k in missing if k != "masked_spec_embed"]
        if missing:
            raise KeyError(f"WavLM tensors missing from {slm_model_dir}: "
                           f"{missing[:10]}")
        return make_slm_feature_fn(model.to(self.device),
                                   self.cfg.data.sampling_rate,
                                   self.cfg.model.slm_sr)

    # ------------------------------------------------------------------

    def _feed(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """A host batch as tensors on the device (lengths and ids int64)."""
        def put(a, dtype):
            return torch.from_numpy(a).to(self.device, dtype,
                                          non_blocking=True)
        return {
            "phone_ids": put(batch.phone_ids, torch.long),
            "text_lengths": put(batch.text_lengths, torch.long),
            "wav": put(batch.wav, torch.float32),
            "spec_lengths": put(batch.spec_lengths, torch.long),
            "sid": put(batch.sid, torch.long),
        }

    @staticmethod
    def _pad_text_globally(batch: Batch) -> Batch:
        """The batch with its text padded to the widest rank's: each rank
        pads to a multiple of 16 of its own longest row, and the ranks of
        a data-parallel step need the same shapes."""
        width = batch.phone_ids.shape[1]
        (wanted,) = global_max([width])
        if wanted == width:
            return batch
        return dataclasses.replace(batch, phone_ids=np.pad(
            batch.phone_ids, ((0, 0), (0, wanted - width))))

    def _log_metrics(self, step: int, metrics: Dict, epoch: int, sps: float):
        if self.rank != 0:  # rank-0 logging (reference train.py:509)
            return
        rec = {"step": step, "epoch": epoch, "steps_per_s": round(sps, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.summary is not None:
            self.summary.scalars(step, {k: v for k, v in rec.items()
                                        if k not in ("step", "epoch")})
        self.logger.info(
            "step %d epoch %d g=%.3f d=%.3f mel=%.3f %.2f steps/s",
            step, epoch, rec.get("loss/g_total", -1),
            rec.get("loss/disc", -1), rec.get("loss/mel", -1), sps)

    def train(self, max_steps: Optional[int] = None) -> int:
        cfg = self.cfg
        step = self.start_step
        steps_per_epoch = max(len(self.batcher), 1)
        start_epoch = step // steps_per_epoch + 1
        t_last = time.perf_counter()
        for epoch in range(start_epoch, cfg.train.epochs + 1):
            self.state.set_learning_rate(epoch_lr(cfg, epoch))
            for batch in self.batcher(epoch):
                if self.world > 1:
                    batch = self._pad_text_globally(batch)
                metrics = train_step(cfg, self.state, self._feed(batch),
                                     self.generator,
                                     slm_feature_fn=self.slm_feature_fn)
                step = self.state.step
                if step % cfg.train.log_interval == 0:
                    # float() of a metric waits for the device
                    metrics = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    sps = cfg.train.log_interval / (now - t_last)
                    t_last = now
                    self._log_metrics(step, metrics, epoch, sps)
                if step % cfg.train.eval_interval == 0:
                    self.evaluate(step, epoch)
                    self.save(step)
                if max_steps is not None and step >= max_steps:
                    self.save(step)
                    return step
        self.save(step)
        return step

    def evaluate(self, step: int, epoch: int, max_batches: int = 8):
        """Validation losses on the val manifest (reference
        train.py:624-693), averaged over at most `max_batches` batches; on
        rank 0 only."""
        if (self.rank != 0 or self.val_dataset is None
                or len(self.val_dataset) == 0):
            return
        if self._val_batcher is None:
            self._val_batcher = BucketBatcher(
                self.val_dataset, self.cfg.train.batch_size,
                seed=self.cfg.train.seed)
        generator = torch.Generator(device=self.device).manual_seed(0)
        totals: Dict[str, float] = {}
        n = 0
        for batch in self._val_batcher(epoch=0):
            metrics = eval_step(self.cfg, self.state.net_g,
                                self._feed(batch), generator)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
            if n >= max_batches:
                break
        if n:
            self._log_metrics(step, {k: v / n for k, v in totals.items()},
                              epoch, 0.0)
        if self.summary is not None:
            self._log_eval_media(step)

    @torch.no_grad()
    def _log_eval_media(self, step: int):
        """The first validation utterance synthesised at MEDIA_SCALES, with
        max_frames = 16 * max(1, segment // hop) and noise from a generator
        seeded 0, in f32 with the generator in eval() mode (which refolds
        the weight-norm buffers, and drops the decoder's packed copies,
        that the optimiser's steps left stale): `gen/audio`, the mel of
        that audio `gen/mel` and the alignment `gen/alignment` (reference
        evaluate(), train.py:624-693)."""
        d = self.cfg.data
        item = self.val_dataset.items[0]
        x = torch.as_tensor(item.phone_ids, dtype=torch.long,
                            device=self.device)[None]
        xl = torch.tensor([x.shape[1]], device=self.device)
        sid = torch.tensor([self.val_dataset.speaker_id(item.speaker)],
                           device=self.device)
        max_frames = 16 * max(1, self.cfg.train.segment_size // d.hop_length)
        net_g = self.state.net_g.eval()
        with torch.autocast(self.device.type, enabled=False):
            audio, y_len, attn = net_g.infer(
                x, xl, sid, *MEDIA_SCALES, max_frames=max_frames,
                generator=torch.Generator(self.device).manual_seed(0))
        frames = int(y_len[0])
        wav = audio[0, :frames * d.hop_length, 0]
        if wav.numel():
            self.summary.audio(step, "gen/audio", wav.cpu().numpy(),
                               d.sampling_rate)
            mel = mel_spectrogram(wav[None], d.filter_length,
                                  d.n_mel_channels, d.sampling_rate,
                                  d.hop_length, d.win_length, d.mel_fmin,
                                  d.mel_fmax)
            self.summary.image(step, "gen/mel", plot_spectrogram_to_numpy(
                mel[0].cpu().numpy().T))
            # attn is [B, T_text, T_spec]; the plot takes [T_spec, T_text]
            self.summary.image(step, "gen/alignment", plot_alignment_to_numpy(
                attn[0, :, :frames].T.cpu().numpy()))
        self.summary.flush()

    def save(self, step: int):
        """A checkpoint at `step`, written by rank 0 while the other ranks
        wait; the summary's events reach disk too."""
        if self.rank == 0:
            ckpt.save_checkpoint(self.model_dir, self.state, step)
            if self.summary is not None:
                self.summary.flush()
            self.logger.info("saved checkpoint at step %d", step)
        if self.world > 1:
            dist.barrier()

    def parameter_digest(self) -> str:
        """sha1 of every network's parameters and buffers, in order: equal
        on every rank of a data-parallel run."""
        h = hashlib.sha1()
        for _, net, _ in self.state.nets():
            for t in net.state_dict().values():
                h.update(t.detach().cpu().contiguous().view(-1)
                         .view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

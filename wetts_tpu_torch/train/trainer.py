"""Host-side training loop (port of wetts_tpu/train/trainer.py; reference
wetts/vits/train.py:37-346):

- epoch-seeded bucketed batches, per-epoch exponential LR decay,
- resume from the latest checkpoint, epoch = step // len(loader) + 1,
- periodic eval + checkpoint every eval_interval steps, scalar logging to
  `train.log` and `metrics.jsonl` (under a VITS2 config also the duration
  discriminator's losses and the MAS noise scale).

One process, one device: the data-parallel mesh of the JAX trainer, its
TensorBoard writer and its eval media are not ported yet. The trainer runs
on the GPU and raises without one unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import torch

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.data.dataset import TTSDataset, read_table
from wetts_tpu_torch.data.sampler import Batch, BucketBatcher
from wetts_tpu_torch.train import checkpoint as ckpt
from wetts_tpu_torch.train.state import GANTrainState, epoch_lr
from wetts_tpu_torch.train.step import (
    build_models,
    eval_step,
    init_weights_,
    train_step,
)
from wetts_tpu_torch.utils.device import resolve_device


def get_logger(model_dir: str) -> logging.Logger:
    """A logger of its own per model directory, writing `train.log` there
    and echoing to the console."""
    os.makedirs(model_dir, exist_ok=True)
    logger = logging.getLogger(
        f"wetts_tpu_torch.train.{os.path.abspath(model_dir)}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
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
    ):
        self.device = resolve_device(device)
        phone_table = read_table(phone_table_path)
        speaker_table = (read_table(speaker_table_path)
                         if speaker_table_path else None)
        cfg.num_phones = max(cfg.num_phones, max(phone_table.values()) + 1)
        if speaker_table:
            cfg.num_speakers = max(cfg.num_speakers,
                                   max(speaker_table.values()) + 1)
        self.cfg = cfg
        self.model_dir = model_dir
        self.logger = get_logger(model_dir)
        self.metrics_path = os.path.join(model_dir, "metrics.jsonl")

        self.dataset = TTSDataset(train_manifest, phone_table, speaker_table,
                                  cfg.data)
        self.batcher = BucketBatcher(self.dataset, cfg.train.batch_size,
                                     seed=cfg.train.seed)
        self.val_dataset = (
            TTSDataset(val_manifest, phone_table, speaker_table, cfg.data)
            if val_manifest else None)
        self._val_batcher: Optional[BucketBatcher] = None

        # parameters and every draw of the run derive from the config's seed
        net_g, net_d, net_dur_d = build_models(cfg)
        init_weights_(net_g, net_d,
                      torch.Generator().manual_seed(cfg.train.seed),
                      net_dur_d)
        self.state = GANTrainState.create(
            cfg, net_g.to(self.device), net_d.to(self.device),
            None if net_dur_d is None else net_dur_d.to(self.device))
        ckpt.load_checkpoint(model_dir, self.state)
        self.start_step = self.state.step
        # draws continue from a stream of their own after a resume
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + self.start_step)

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

    def _log_metrics(self, step: int, metrics: Dict, epoch: int, sps: float):
        rec = {"step": step, "epoch": epoch, "steps_per_s": round(sps, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
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
                metrics = train_step(cfg, self.state, self._feed(batch),
                                     self.generator)
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
        train.py:624-693), averaged over at most `max_batches` batches."""
        if self.val_dataset is None or len(self.val_dataset) == 0:
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

    def save(self, step: int):
        ckpt.save_checkpoint(self.model_dir, self.state, step)
        self.logger.info("saved checkpoint at step %d", step)

"""Overfit smoke of the port (the twin of tests/test_overfit.py): the
training loop must actually learn.

Every other training test of the port holds it against the JAX package
over one or two steps; this one asserts optimisation: on a tiny synthetic
corpus the mel reconstruction loss must fall to a fraction of its initial
value and the held-out (== training, deliberately: an overfit check)
val/mel_l1 must improve. A sign flip in a GAN term, a wrong detach, a
broken optimiser state or a learning-rate bug passes the parity tests and
fails this one. 150 steps of the CI-sized config through `Trainer` on the
CPU, with the JAX test's bounds (end below 0.72x the start, val below 0.9x
its first value); marked slow.
"""

import json
import os

import numpy as np
import pytest

from test_torch_train import make_dataset, tiny_cfg
from wetts_tpu_torch.train.trainer import Trainer


@pytest.mark.slow
def test_training_reduces_mel_loss(tmp_path):
    manifest, pt, st = make_dataset(tmp_path, n=4)
    cfg = tiny_cfg()
    cfg.train.log_interval = 10
    cfg.train.eval_interval = 75
    model_dir = str(tmp_path / "exp")
    trainer = Trainer(cfg, model_dir, manifest, pt, st,
                      val_manifest=manifest, device="cpu")
    trainer.train(max_steps=150)

    recs = [json.loads(line)
            for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    mel = [r["loss/mel"] for r in recs if "loss/mel" in r]
    val = [r["val/mel_l1"] for r in recs if "val/mel_l1" in r]
    assert len(mel) >= 10 and len(val) >= 2

    start = float(np.mean(mel[:2]))
    end = float(np.mean(mel[-3:]))
    assert end < 0.72 * start, (
        f"mel loss did not fall: start {start:.1f} -> end {end:.1f}")
    assert val[-1] < 0.9 * val[0], (
        f"val/mel_l1 did not improve: {val[0]:.3f} -> {val[-1]:.3f}")
    assert all(np.isfinite(mel)), "non-finite mel loss during training"

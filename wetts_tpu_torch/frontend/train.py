"""Frontend trainer: joint polyphone + prosody CE with ignore-index (port of
wetts_tpu/frontend/train.py; reference wetts/frontend/train.py:31-216).

loss = w * CE_polyphone + (1 - w) * CE_prosody over the labelled tokens,
masked accuracy, AdamW with a warmup-cosine schedule, per-epoch CV, and
`params.npz` saved after each epoch. Three places where the plain torch
idiom would leave the JAX trainer:

- **Empty label sets.** The dataset mixes the two tasks by concatenation,
  so a batch may hold only prosody lines, every polyphone label ignored;
  `F.cross_entropy(ignore_index=-100)` gives NaN there. `masked_ce_and_acc`
  divides by max(n, 1) and gives 0, as the JAX function.
- **Weight decay.** `optax.adamw(schedule)` decays every parameter by
  1e-4 (eps 1e-8, betas (0.9, 0.999)), BERT's too: BERT's gradients are
  stopped, so its Adam update is zero and only the decay moves it,
  `p -= lr * 1e-4 * p` a step. Here BERT runs under `torch.no_grad()`
  (`models/bert_frontend.py`), so its parameters get no gradient and
  `torch.optim.AdamW` would skip them (and decays by 0.01 by default): the
  trainer keeps AdamW(weight_decay=1e-4, eps=1e-8) for the other
  parameters and decays BERT's itself.
- **Schedule and dropout.** The learning rate of update n (0-based) is
  `warmup_cosine(n)`, optax's `warmup_cosine_decay_schedule(0, lr,
  int(0.1 * total), total, 0)` read at the count of updates before it, so
  the first update runs at 0 after a warmup. The JAX trainer applies the
  model without a dropout rng, so it trains without dropout: the model
  stays in eval() mode here.

`_save` writes `params.npz` in the flax layout, keystr keys
(`convert_frontend_torch`), so that both packages' `cli/model.py` and
`bin/export_frontend.py` read it. Runs on the GPU unless given
`device="cpu"`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wetts_tpu_torch.frontend.dataset import IGNORE_ID, FrontendDataset
from wetts_tpu_torch.models.bert_frontend import (
    FrontendModel,
    convert_frontend_torch,
)
from wetts_tpu_torch.utils.device import resolve_device
from wetts_tpu_torch.utils.params_io import save_params_npz

# optax.adamw's defaults (wetts_tpu/frontend/train.py:103)
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


def masked_ce_and_acc(logits: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean CE over the labelled tokens, 0 where none is; #correct;
    #labelled)."""
    valid = labels != IGNORE_ID
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
    n = valid.sum()
    loss = torch.where(valid, ce, 0.0).sum() / n.clamp_min(1)
    correct = (valid & (logits.argmax(-1) == safe)).sum()
    return loss, correct, n


def warmup_cosine(step: int, peak: float, warmup: int, total: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total, 0) at
    `step`: linear from 0 over `warmup` steps, then a cosine to 0 over the
    remaining `total - warmup`, 0 after."""
    if step < warmup:
        return peak * step / warmup
    t = min(step - warmup, total - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (total - warmup)))


class FrontendTrainer:
    def __init__(
        self,
        model: FrontendModel,
        train_data: FrontendDataset,
        cv_data: Optional[FrontendDataset],
        model_dir: str,
        lr: float = 5e-5,
        epochs: int = 10,
        batch_size: int = 32,
        phone_weight: float = 0.5,
        warmup_ratio: float = 0.1,
        device=None,
    ):
        """model: its weights as they are (BERT's included: load a
        pretrained BERT into `model.bert` first), moved to `device`."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()  # no dropout (docstring)
        self.train_data = train_data
        self.cv_data = cv_data
        self.model_dir = model_dir
        self.epochs = epochs
        self.batch_size = batch_size
        self.phone_weight = phone_weight
        os.makedirs(model_dir, exist_ok=True)

        steps_per_epoch = max(1, (len(train_data) + batch_size - 1)
                              // batch_size)
        self.total = steps_per_epoch * epochs
        self.lr, self.warmup = lr, int(self.total * warmup_ratio)
        self.step = 0
        self.bert_params = list(model.bert.parameters())
        bert = {id(p) for p in self.bert_params}
        self.opt = torch.optim.AdamW(
            [p for p in model.parameters() if id(p) not in bert], lr=0.0,
            betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY)

    def _put(self, batch):
        return [torch.from_numpy(np.asarray(a)).to(self.device, torch.long)
                for a in batch]

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One update on (ids, mask, polyphone labels, prosody labels);
        returns the metrics as 0-d tensors on the device."""
        ids, mask, poly, pros = self._put(batch)
        lr = warmup_cosine(self.step, self.lr, self.warmup, self.total)
        phone_logits, prosody_logits = self.model(ids, mask)
        l_p, c_p, n_p = masked_ce_and_acc(phone_logits, poly)
        l_r, c_r, n_r = masked_ce_and_acc(prosody_logits, pros)
        loss = self.phone_weight * l_p + (1 - self.phone_weight) * l_r
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        with torch.no_grad():  # optax's decay of the frozen BERT
            torch._foreach_add_(self.bert_params, self.bert_params,
                                alpha=-lr * WEIGHT_DECAY)
        self.step += 1
        return {"loss": loss.detach(), "loss_phone": l_p.detach(),
                "loss_prosody": l_r.detach(),
                "acc_phone": c_p / n_p.clamp_min(1),
                "acc_prosody": c_r / n_r.clamp_min(1)}

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        step = 0
        log_path = os.path.join(self.model_dir, "metrics.jsonl")
        last = {}
        for epoch in range(self.epochs):
            for batch in self.train_data.batches(self.batch_size, epoch):
                metrics = self.train_step(batch)
                step += 1
                last = {k: float(v) for k, v in metrics.items()}
                if max_steps is not None and step >= max_steps:
                    self._save(last, log_path, epoch)
                    return last
            cv = self.evaluate() if self.cv_data else {}
            last.update(cv)
            self._save(last, log_path, epoch)
        return last

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        tot = np.zeros(4, np.int64)
        for batch in self.cv_data.batches(self.batch_size, 0, shuffle=False):
            ids, mask, poly, pros = self._put(batch)
            phone_logits, prosody_logits = self.model(ids, mask)
            _, c_p, n_p = masked_ce_and_acc(phone_logits, poly)
            _, c_r, n_r = masked_ce_and_acc(prosody_logits, pros)
            tot += np.array([int(x) for x in (c_p, n_p, c_r, n_r)])
        return {
            "cv_acc_phone": tot[0] / max(tot[1], 1),
            "cv_acc_prosody": tot[2] / max(tot[3], 1),
        }

    def params(self) -> Dict:
        """The model's parameters as the flax tree of the JAX
        `FrontendModel` (numpy leaves)."""
        sd = {k: v.detach().cpu().numpy()
              for k, v in self.model.state_dict().items()}
        return convert_frontend_torch(sd)[0]

    def _save(self, metrics, log_path, epoch):
        with open(log_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, **metrics}) + "\n")
        save_params_npz(os.path.join(self.model_dir, "params.npz"),
                        self.params())

"""Bridge: FrontendModel -> the `Scorer` callable used by text.frontend.

Port of wetts_tpu/frontend/scorer.py. Equivalent to the reference's ONNX
session inside G2pProsody (runtime/core/frontend/g2p_prosody.cc:102-122)
and the Python `Frontend.g2p` (wetts/frontend/g2p_prosody.py:40-90): one
forward over the token ids, on the model's device, returning softmax
posteriors as numpy arrays. The JAX scorer pads the ids to a multiple of 16
under a mask so that its jit cache holds few shapes; nothing is compiled
here, so the ids go in as they are, under an all-ones mask.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from wetts_tpu_torch.models.bert_frontend import FrontendModel


class FrontendScorer:
    def __init__(self, model: FrontendModel):
        self.model = model.eval()

    def __call__(self, token_ids: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        dev = next(self.model.parameters()).device
        ids = torch.as_tensor(np.asarray(token_ids), dtype=torch.long,
                              device=dev)[None]
        with torch.inference_mode():
            phone, prosody = self.model(ids, torch.ones_like(ids))
            phone = torch.softmax(phone[0].float(), -1)
            prosody = torch.softmax(prosody[0].float(), -1)
            return phone.cpu().numpy(), prosody.cpu().numpy()

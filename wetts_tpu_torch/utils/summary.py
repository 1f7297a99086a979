"""TensorBoard summaries + spectrogram/alignment plotting (a copy of
wetts_tpu/utils/summary.py, which imports nothing of JAX; the port keeps
its own).

Parity target: the reference's TB observability — scalar losses /
grad-norms / LR, GT-vs-generated mel images, alignment heatmaps, and eval
audio (wetts/vits/train.py:509-581, utils/task.py:79-163,
plot_spectrogram_to_numpy/plot_alignment_to_numpy).

Uses torch.utils.tensorboard's writer when the `tensorboard` package is
present (its audio encoder is self-contained), falling back to tensorboardX
(whose add_audio needs soundfile — audio is skipped there); with neither,
`Summary(...)` raises ImportError. Plotting goes through matplotlib's Agg
backend when available and falls back to a bare colormap otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """[F, T] (or [T, F]) -> HWC uint8 image (task.py:105-131)."""
    spec = np.asarray(spectrogram, np.float32)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 2))
        im = ax.imshow(spec, aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel("Frames")
        ax.set_ylabel("Channels")
        fig.canvas.draw()
        data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        plt.close(fig)
        return data
    except Exception:  # pragma: no cover - matplotlib missing/broken
        lo, hi = float(spec.min()), float(spec.max())
        norm = (spec - lo) / max(hi - lo, 1e-6)
        gray = (norm * 255).astype(np.uint8)[::-1]
        return np.stack([gray, gray, gray], axis=-1)


def plot_alignment_to_numpy(alignment: np.ndarray) -> np.ndarray:
    """[T_spec, T_text] attention/alignment -> HWC uint8 (task.py:134-163)."""
    return plot_spectrogram_to_numpy(np.asarray(alignment, np.float32).T)


class Summary:
    """Thin TB writer: scalars / images / audio (task.py:79-95 summarize)."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._has_audio = True
        except ImportError:
            from tensorboardX import SummaryWriter

            self._has_audio = False  # tbx add_audio requires soundfile
        self.writer = SummaryWriter(log_dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        for k, v in values.items():
            self.writer.add_scalar(k, float(v), step)

    def image(self, step: int, tag: str, img_hwc: np.ndarray) -> None:
        self.writer.add_image(tag, img_hwc, step, dataformats="HWC")

    def audio(self, step: int, tag: str, wav: np.ndarray,
              sample_rate: int, max_len: Optional[int] = None) -> None:
        if not self._has_audio:
            return
        wav = np.asarray(wav, np.float32).reshape(-1)
        if max_len:
            wav = wav[:max_len]
        self.writer.add_audio(tag, wav[:, None], step,
                              sample_rate=sample_rate)

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()

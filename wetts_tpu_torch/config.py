"""Configuration system.

Loads the reference's JSON config format unchanged (train/data/model
sections, examples/*/configs/*.json; HParams semantics from
wetts/vits/utils/task.py:172-237, 273-303) into typed dataclasses. Unknown
keys are kept in `extra` so older/newer configs round-trip.

The port's own copy of `wetts_tpu/config.py`: the PyTorch package imports
nothing of the JAX one, so the two stay independent.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


def _take(d: Dict[str, Any], cls) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
    kwargs = {k: v for k, v in d.items() if k in names}
    extra = {k: v for k, v in d.items() if k not in names}
    kwargs["extra"] = extra
    return kwargs


@dataclass
class TrainConfig:
    log_interval: int = 200
    eval_interval: int = 1000
    seed: int = 1234
    epochs: int = 20000
    learning_rate: float = 2e-4
    betas: Sequence[float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 32
    fp16_run: bool = False  # reference AMP flag; here: bf16 compute toggle
    bf16_run: bool = False
    lr_decay: float = 0.999875
    segment_size: int = 8192
    init_lr_ratio: float = 1.0
    warmup_epochs: int = 0
    c_mel: float = 45.0
    c_kl: float = 1.0
    c_dur: float = 1.0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    max_wav_value: float = 32768.0
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    use_mel_posterior_encoder: bool = False
    min_text_len: int = 1
    max_text_len: int = 190
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def spec_channels(self) -> int:
        if self.use_mel_posterior_encoder:
            return self.n_mel_channels
        return self.filter_length // 2 + 1


@dataclass
class ModelConfig:
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    n_layers_q: int = 3
    use_spectral_norm: bool = False
    gin_channels: int = 256
    use_sdp: bool = True
    # ---- VITS2 feature flags (reference train.py:82-203) ----
    use_mel_posterior_encoder: bool = False
    use_transformer_flows: bool = False
    transformer_flow_type: str = "mono_layer_post_residual"
    use_spk_conditioned_encoder: bool = False
    use_noise_scaled_mas: bool = False
    mas_noise_scale_initial: float = 0.01
    noise_scale_delta: float = 2e-6
    use_duration_discriminator: bool = False
    duration_discriminator_type: str = "dur_disc_1"
    use_wd: bool = False
    slm_model: str = ""
    slm_sr: int = 16000
    slm_hidden: int = 768
    slm_nlayers: int = 13
    slm_initial_channel: int = 64
    use_mrd_disc: bool = False
    # ---- vocoder selection ----
    vocoder_type: str = "hifigan"
    vocos_channels: int = 512
    vocos_h_channels: int = 1536
    vocos_out_channels: int = 1026
    vocos_num_layers: int = 8
    vocos_istft_config: Dict[str, Any] = field(default_factory=lambda: {
        "n_fft": 1024, "hop_length": 256, "win_length": 1024, "center": True})
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    # injected from tables (reference task.py:221-232)
    num_phones: int = 0
    num_speakers: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls(
            train=TrainConfig(**_take(d.get("train", {}), TrainConfig)),
            data=DataConfig(**_take(d.get("data", {}), DataConfig)),
            model=ModelConfig(**_take(d.get("model", {}), ModelConfig)),
            num_phones=d.get("num_phones", 0),
            num_speakers=d.get("num_speakers", 0),
        )

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        def clean(dc):
            d = dataclasses.asdict(dc)
            d.update(d.pop("extra", {}))
            return d

        return {
            "train": clean(self.train),
            "data": clean(self.data),
            "model": clean(self.model),
            "num_phones": self.num_phones,
            "num_speakers": self.num_speakers,
        }

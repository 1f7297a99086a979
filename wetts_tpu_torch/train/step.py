"""The GAN training step (port of wetts_tpu/train/step.py).

Reproduces the reference's per-batch update (wetts/vits/train.py:366-507):
1. one generator forward with gradients; its detached audio feeds
2. the discriminator update on (y_slice, y_hat.detach()); then
3. the generator update, whose adversarial terms see the *updated*
   discriminator (the reference steps optim_d before the G pass), with
   loss = gen + fm + c_mel * L1(mel) + sum(l_length) + c_kl * KL.

The JAX step runs the generator forward twice with identical rngs, once
without gradients for the D update and once under value_and_grad; one
forward whose output is detached for D is the same computation. Linear and
mel spectrograms are computed on the device inside the step, as in the JAX
package. f32 only so far: `fp16_run` / `bf16_run` raise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from wetts_tpu_torch.models.duration import ConvFlow
from wetts_tpu_torch.models.flows import AffineCoupling
from wetts_tpu_torch.models.layers import WeightNormed
from wetts_tpu_torch.models.synthesizer import Synthesizer
from wetts_tpu_torch.ops.masking import slice_segments
from wetts_tpu_torch.ops.spectral import (
    mel_spectrogram,
    spec_to_mel,
    spectrogram,
)
from wetts_tpu_torch.train.losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
)
from wetts_tpu_torch.train.state import GANTrainState

Batch = Dict[str, torch.Tensor]


def build_models(cfg: Config) -> Tuple[Synthesizer, MultiPeriodDiscriminator]:
    """The generator and the discriminator of a config (reference
    train.py:82-211). Raises for what the port does not train yet."""
    m, t = cfg.model, cfg.train
    if t.fp16_run or t.bf16_run:
        raise NotImplementedError("the port trains in f32 only so far "
                                  "(fp16_run / bf16_run)")
    if m.use_noise_scaled_mas:
        raise NotImplementedError("the port does not train with noise-scaled "
                                  "MAS (VITS2) yet")
    for flag in ("use_mrd_disc", "use_duration_discriminator", "use_wd"):
        if getattr(m, flag):
            raise NotImplementedError(
                f"the port trains with the multi-period discriminator only "
                f"so far ({flag})")
    return Synthesizer(cfg), MultiPeriodDiscriminator()


@torch.no_grad()
def init_weights_(net_g: Synthesizer, net_d: MultiPeriodDiscriminator,
                  generator: Optional[torch.Generator] = None) -> None:
    """Initial weights at the reference's distributions, drawn from
    `generator` (a CPU generator; None is torch's global one): conv and dense tensors U(-1/sqrt(fan_in), +) (torch's
    default; xavier-uniform for the attention's q, k, v), the phone
    embedding N(0, hidden^-0.5), the speaker embedding N(0, 1),
    relative-position embeddings N(0, d^-0.5), weight-norm g = ||v||;
    LayerNorm and ElementwiseAffine stay at the identity, and the flow's
    `post` and the spline `proj` convs at zero (identity flows), as the
    reference initialises them."""
    for net in (net_g, net_d):
        for name, module in net.named_modules():
            if not isinstance(module, WeightNormed):
                continue
            w = module.weight_v if module.weight_norm else module.weight
            fan_in = w[0].numel()  # per group; [C_in, C_out, K] transposed
            bound = fan_in ** -0.5
            if name.endswith(("conv_q", "conv_k", "conv_v")):
                xavier = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
                w.uniform_(-xavier, xavier, generator=generator)
            else:
                w.uniform_(-bound, bound, generator=generator)
            if module.bias is not None:
                module.bias.uniform_(-bound, bound, generator=generator)
            if module.weight_norm:
                module.weight_g.copy_(torch.sqrt((w * w).sum(
                    dim=tuple(range(1, w.ndim)), keepdim=True)))
                module.fold_()
    net_g.enc_p.emb.weight.normal_(0.0, net_g.enc_p.hidden_channels ** -0.5,
                                   generator=generator)
    if hasattr(net_g, "emb_g"):
        net_g.emb_g.weight.normal_(0.0, 1.0, generator=generator)
    for name, p in net_g.named_parameters():
        if name.endswith(("emb_rel_k", "emb_rel_v")):
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
    for module in net_g.modules():
        if isinstance(module, (AffineCoupling, ConvFlow)):
            zeroed = (module.post if isinstance(module, AffineCoupling)
                      else module.proj)
            zeroed.weight.zero_()
            zeroed.bias.zero_()


def _use_mel_posterior(cfg: Config) -> bool:
    return (cfg.data.use_mel_posterior_encoder
            or cfg.model.use_mel_posterior_encoder)


def compute_spec(cfg: Config, wav: torch.Tensor) -> torch.Tensor:
    """The posterior encoder's input, computed on the device: the linear
    spectrogram or the log-mel, [B, T] -> [B, F, C]."""
    d = cfg.data
    if _use_mel_posterior(cfg):
        return mel_spectrogram(wav, d.filter_length, d.n_mel_channels,
                               d.sampling_rate, d.hop_length, d.win_length,
                               d.mel_fmin, d.mel_fmax)
    return spectrogram(wav, d.filter_length, d.hop_length, d.win_length)


def _mel_pair(cfg: Config, spec: torch.Tensor, out: Dict
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(target mel of the decoded slice, mel of the generated audio)."""
    d = cfg.data
    mel = spec if _use_mel_posterior(cfg) else spec_to_mel(
        spec, d.filter_length, d.n_mel_channels, d.sampling_rate,
        d.mel_fmin, d.mel_fmax)
    y_mel = slice_segments(mel, out["ids_slice"],
                           cfg.train.segment_size // d.hop_length)
    y_hat_mel = mel_spectrogram(
        out["audio"][:, :, 0], d.filter_length, d.n_mel_channels,
        d.sampling_rate, d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)
    return y_mel, y_hat_mel


def _forward(net_g: Synthesizer, batch: Batch, spec: torch.Tensor,
             generator: Optional[torch.Generator]) -> Dict:
    return net_g(batch["phone_ids"], batch["text_lengths"], spec,
                 batch["spec_lengths"], batch["sid"], generator=generator)


def _global_norm(params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def train_step(cfg: Config, state: GANTrainState, batch: Batch,
               generator: Optional[torch.Generator] = None,
               mark: Optional[Callable[[str], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One D-then-G update in place on `state`; returns the metrics as
    0-d tensors on the device (nothing here synchronises with the host).

    batch: phone_ids [B, T_text], text_lengths [B], wav [B, T_spec * hop],
    spec_lengths [B], sid [B], all on the models' device.
    mark: called with "g_forward", "d_update" and "g_update" as each phase
    has been enqueued, for a caller that times the phases.
    """
    d, t = cfg.data, cfg.train
    net_g, net_d = state.net_g, state.net_d
    net_g.train()
    net_d.train()
    mark = mark or (lambda name: None)
    wav = batch["wav"]
    with torch.no_grad():
        spec = compute_spec(cfg, wav)

    # ---- generator forward, once, with gradients ----
    out = _forward(net_g, batch, spec, generator)
    y_hat = out["audio"]  # [B, segment, 1]
    y_slice = slice_segments(wav[:, :, None],
                             out["ids_slice"] * d.hop_length, t.segment_size)
    mark("g_forward")

    # ---- discriminator update ----
    y_d_r, y_d_g, _, _ = net_d(y_slice, y_hat.detach())
    loss_disc, _, _ = discriminator_loss(y_d_r, y_d_g)
    state.opt_d.zero_grad(set_to_none=True)
    loss_disc.backward()
    grad_norm_d = _global_norm(net_d.parameters())
    state.opt_d.step()
    mark("d_update")

    # ---- generator update; the updated D takes no gradient here ----
    y_mel, y_hat_mel = _mel_pair(cfg, spec, out)
    net_d.requires_grad_(False)
    try:
        y_d_r, y_d_g, fmap_r, fmap_g = net_d(y_slice, y_hat)
    finally:
        net_d.requires_grad_(True)
    loss_dur = torch.sum(out["l_length"].float())
    loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * t.c_mel
    loss_kl = kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                      out["y_mask"]) * t.c_kl
    loss_fm = feature_loss(fmap_r, fmap_g)
    loss_gen, _ = generator_loss(y_d_g)
    total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
    state.opt_g.zero_grad(set_to_none=True)
    total.backward()
    grad_norm_g = _global_norm(net_g.parameters())
    state.opt_g.step()
    state.step += 1
    mark("g_update")

    return {"loss/gen": loss_gen.detach(), "loss/fm": loss_fm.detach(),
            "loss/mel": loss_mel.detach(), "loss/dur": loss_dur.detach(),
            "loss/kl": loss_kl.detach(), "loss/disc": loss_disc.detach(),
            "loss/g_total": total.detach(), "grad_norm/g": grad_norm_g,
            "grad_norm/d": grad_norm_d}


@torch.no_grad()
def eval_step(cfg: Config, net_g: Synthesizer, batch: Batch,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """Validation pass: generator losses only, no updates, the generator in
    eval mode (reference train.py:624-693)."""
    net_g.eval()
    spec = compute_spec(cfg, batch["wav"])
    out = _forward(net_g, batch, spec, generator)
    y_mel, y_hat_mel = _mel_pair(cfg, spec, out)
    return {
        "val/mel_l1": torch.mean(torch.abs(y_mel - y_hat_mel)),
        "val/kl": kl_loss(out["z_p"], out["logs_q"], out["m_p"],
                          out["logs_p"], out["y_mask"]),
        "val/dur": torch.sum(out["l_length"].float()),
    }

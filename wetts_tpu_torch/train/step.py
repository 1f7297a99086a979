"""The GAN training step (port of wetts_tpu/train/step.py).

Reproduces the reference's per-batch update (wetts/vits/train.py:366-507):
1. one generator forward with gradients (under `use_noise_scaled_mas` at
   the scale max(initial - delta * step, 0) of the step count before the
   update, :375-380); its detached outputs feed
2. the discriminator update on (y_slice, y_hat.detach()), then, where the
   run has them,
3. the duration discriminator's update on the detached (x_hidden, x_mask,
   logw_, logw), and
4. the WavLM (SLM) discriminator's update on the frozen WavLM's features of
   the real and the generated slice, gradients stopped (:467-476); then
5. the generator update, whose adversarial terms see the *updated*
   discriminators (the reference steps optim_d before the G pass), with
   loss = gen + fm + c_mel * L1(mel) + sum(l_length) + c_kl * KL
   (+ the duration discriminator's generator term, which reaches only the
   stochastic duration predictor's own parameters through logw; + the SLM
   feature loss mean|f_real - f_fake| and the WavLM discriminator's
   generator term, :496-500).

The JAX step runs the generator forward twice with identical rngs, once
without gradients for the D updates and once under value_and_grad; one
forward whose output is detached for D is the same computation, and so is
one WavLM pass over the generated slice. Linear and mel spectrograms are
computed on the device inside the step, as in the JAX package.

`train.bf16_run` (or `fp16_run`, which the JAX config maps to the same
toggle) runs every network's forward under `torch.autocast(dtype=bfloat16)`
in place of the JAX package's `make_half_fns`: master parameters and AdamW
state stay f32, gradients reach them in f32, and no loss scaling is needed
(bf16 has f32's exponent). What the JAX bf16 step computes in f32 stays
f32: the spectrograms (`ops/spectral.py`), MAS's scores
(`Synthesizer.forward`), the losses, and the frozen WavLM with its
resample. Each phase enters autocast on its own, so that no bf16 copy of a
weight cached by autocast outlives an optimiser step.

In a process group (`parallel/mesh.py`) the step is data-parallel and
computes what the JAX step computes over its sharded global batch, not the
mean of per-rank losses, since several losses divide by a mask sum that
differs between ranks. Each rank computes its share of the global loss:
means over the batch's rows divided by the world size, mask-normalised
sums (the KL, the duration loss) over the global mask sum, plain sums as
they are; the draws and the MAS noise's std are the global batch's. After
each backward the net's gradients are summed over the ranks (one
all-reduce per optimiser), so the gradient norms and the step see the
global gradient, and the metrics are the shares summed. At world 1 this
is the step without a process group.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models.discriminators import (
    DurationDiscriminatorV1,
    DurationDiscriminatorV2,
    MultiPeriodDiscriminator,
    MultiPeriodMultiResolutionDiscriminator,
    WavLMDiscriminator,
)
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
from wetts_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    check_same_shapes,
    host_shard_info,
    is_distributed,
    sharded,
)
from wetts_tpu_torch.train.losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
)
from wetts_tpu_torch.train.state import GANTrainState

Batch = Dict[str, torch.Tensor]


def build_models(cfg: Config) -> Tuple[Synthesizer, nn.Module,
                                       Optional[nn.Module],
                                       Optional[nn.Module]]:
    """The generator, the discriminator (multi-period, or multi-period
    multi-resolution under `use_mrd_disc`), the duration discriminator
    (None without `use_duration_discriminator`) and the WavLM
    discriminator (None without `use_wd`) of a config (reference
    train.py:82-211)."""
    m = cfg.model
    net_d = (MultiPeriodMultiResolutionDiscriminator() if m.use_mrd_disc
             else MultiPeriodDiscriminator())
    net_dur_d = None
    if m.use_duration_discriminator:
        cls = (DurationDiscriminatorV1
               if m.duration_discriminator_type == "dur_disc_1"
               else DurationDiscriminatorV2)
        net_dur_d = cls(m.hidden_channels, m.hidden_channels, 3, 0.1,
                        gin_channels=m.gin_channels)
    net_wd = (WavLMDiscriminator(m.slm_hidden, m.slm_nlayers,
                                 m.slm_initial_channel) if m.use_wd
              else None)
    return Synthesizer(cfg), net_d, net_dur_d, net_wd


@torch.no_grad()
def init_weights_(net_g: Synthesizer, net_d: nn.Module,
                  generator: Optional[torch.Generator] = None,
                  net_dur_d: Optional[nn.Module] = None,
                  net_wd: Optional[nn.Module] = None) -> None:
    """Initial weights at the reference's distributions, drawn from
    `generator` (a CPU generator; None is torch's global one): conv, dense
    and linear tensors U(-1/sqrt(fan_in), +) (torch's default;
    xavier-uniform for the attention's q, k, v), the phone embedding N(0,
    hidden^-0.5), the speaker embedding N(0, 1), relative-position
    embeddings N(0, d^-0.5), weight-norm g = ||v||; LayerNorm and
    ElementwiseAffine stay at the identity, and the flow's `post` and the
    spline `proj` convs at zero (identity flows), as the reference
    initialises them."""
    nets = [net for net in (net_g, net_d, net_dur_d, net_wd)
            if net is not None]
    for net in nets:
        for name, module in net.named_modules():
            if not isinstance(module, (WeightNormed, nn.Linear)):
                continue
            weight_norm = getattr(module, "weight_norm", False)
            w = module.weight_v if weight_norm else module.weight
            fan_in = w[0].numel()  # per group; [C_in, C_out, K] transposed
            bound = fan_in ** -0.5
            if name.endswith(("conv_q", "conv_k", "conv_v")):
                xavier = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
                w.uniform_(-xavier, xavier, generator=generator)
            else:
                w.uniform_(-bound, bound, generator=generator)
            if module.bias is not None:
                module.bias.uniform_(-bound, bound, generator=generator)
            if weight_norm:
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
             generator: Optional[torch.Generator],
             mas_noise_scale: float = 0.0) -> Dict:
    return net_g(batch["phone_ids"], batch["text_lengths"], spec,
                 batch["spec_lengths"], batch["sid"], generator=generator,
                 mas_noise_scale=mas_noise_scale)


def mas_noise_scale(cfg: Config, step: int) -> float:
    """The noise-scaled MAS's scale at `step` steps taken: max(initial -
    delta * step, 0) (reference train.py:375-380); 0 without
    `use_noise_scaled_mas`."""
    m = cfg.model
    if not m.use_noise_scaled_mas:
        return 0.0
    return max(m.mas_noise_scale_initial - m.noise_scale_delta * step, 0.0)


# the forward's outputs the duration discriminator takes, in its order
DURATION_INPUTS = ("x_hidden", "x_mask", "logw_", "logw")


def _frozen(net: nn.Module, *args):
    """net(*args) with no gradient into the net's own parameters."""
    net.requires_grad_(False)
    try:
        return net(*args)
    finally:
        net.requires_grad_(True)


def _global_norm(params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def half_precision(cfg: Config) -> bool:
    """Whether the step computes in bf16 (`bf16_run`, or `fp16_run`, which
    the JAX config maps to the same toggle)."""
    return cfg.train.bf16_run or cfg.train.fp16_run


# the metrics that are shares of a loss, summed over the ranks of a
# data-parallel step (the noise scale and the gradient norms are global)
_NOT_SHARES = ("train/mas_noise_scale", "grad_norm/g", "grad_norm/d")


def train_step(cfg: Config, state: GANTrainState, batch: Batch,
               generator: Optional[torch.Generator] = None,
               mark: Optional[Callable[[str], None]] = None,
               slm_feature_fn: Optional[Callable] = None
               ) -> Dict[str, torch.Tensor]:
    """One D-then-G update in place on `state`; returns the metrics as
    0-d f32 tensors on the device (nothing here synchronises with the
    host).

    batch: phone_ids [B, T_text], text_lengths [B], wav [B, T_spec * hop],
    spec_lengths [B], sid [B], all on the models' device; in a process
    group, this rank's rows of the global batch (every rank with the same
    shapes, checked, and `generator` at the same state).
    mark: called with "g_forward", "d_update", "dur_d_update" (where the
    state has a duration discriminator), "wd_update" (where the WavLM
    branch runs) and "g_update" as each phase has been enqueued, for a
    caller that times the phases.
    slm_feature_fn: the frozen WavLM's features of a waveform
    (`models/wavlm.py:make_slm_feature_fn`); the WavLM discriminator's
    branch runs where the state has `net_wd` and this is given, as in the
    JAX step.
    """
    if not is_distributed():
        return _step(cfg, state, batch, generator, mark, slm_feature_fn,
                     1, lambda params: None)
    rank, world = host_shard_info()
    if world > 1:
        check_same_shapes(batch)
    with sharded(rank, world):
        metrics = _step(cfg, state, batch, generator, mark, slm_feature_fn,
                        world, all_reduce_grads)
    shares = [k for k in metrics if k not in _NOT_SHARES]
    total = torch.stack([metrics[k] for k in shares])
    torch.distributed.all_reduce(total)
    metrics.update(zip(shares, total.unbind()))
    return metrics


def _step(cfg: Config, state: GANTrainState, batch: Batch,
          generator: Optional[torch.Generator],
          mark: Optional[Callable[[str], None]],
          slm_feature_fn: Optional[Callable], world: int,
          reduce: Callable) -> Dict[str, torch.Tensor]:
    """`train_step` on this rank's rows: the loss terms that are means over
    the rows are divided by `world` (an exact identity at 1), and
    `reduce(params)` sums a net's gradients over the ranks."""
    d, t = cfg.data, cfg.train
    net_g, net_d = state.net_g, state.net_d
    net_dur_d, net_wd = state.net_dur_d, state.net_wd
    use_wd = net_wd is not None and slm_feature_fn is not None
    for _, net, _ in state.nets():
        net.train()
    mark = mark or (lambda name: None)
    if world == 1:
        def share(v):
            return v
    else:
        def share(v):
            return v / world
    wav = batch["wav"]
    if half_precision(cfg):
        def amp():
            return torch.autocast(wav.device.type, dtype=torch.bfloat16)
    else:
        amp = contextlib.nullcontext
    metrics = {}
    noise_scale = mas_noise_scale(cfg, state.step)
    if cfg.model.use_noise_scaled_mas:
        metrics["train/mas_noise_scale"] = torch.full(
            (), noise_scale, device=wav.device)
    with torch.no_grad():
        spec = compute_spec(cfg, wav)

    # ---- generator forward, once, with gradients ----
    with amp():
        out = _forward(net_g, batch, spec, generator, noise_scale)
    y_hat = out["audio"]  # [B, segment, 1]
    y_slice = slice_segments(wav[:, :, None],
                             out["ids_slice"] * d.hop_length, t.segment_size)
    mark("g_forward")

    # ---- discriminator update ----
    with amp():
        y_d_r, y_d_g, _, _ = net_d(y_slice, y_hat.detach())
        loss_disc, _, _ = discriminator_loss(y_d_r, y_d_g)
        loss_disc = share(loss_disc)
    state.opt_d.zero_grad(set_to_none=True)
    loss_disc.backward()
    reduce(net_d.parameters())
    grad_norm_d = _global_norm(net_d.parameters())
    state.opt_d.step()
    mark("d_update")

    # ---- duration discriminator update ----
    if net_dur_d is not None:
        with amp():
            probs = net_dur_d(*(out[k].detach() for k in DURATION_INPUTS))
            loss_dur_disc, _, _ = discriminator_loss([probs[0]], [probs[1]])
            loss_dur_disc = share(loss_dur_disc)
        state.opt_dur_d.zero_grad(set_to_none=True)
        loss_dur_disc.backward()
        reduce(net_dur_d.parameters())
        state.opt_dur_d.step()
        metrics["loss/dur_disc"] = loss_dur_disc.detach()
        mark("dur_d_update")

    # ---- WavLM (SLM) discriminator update on stopped features ----
    if use_wd:
        with torch.no_grad():
            f_real = slm_feature_fn(y_slice)
        f_fake = slm_feature_fn(y_hat)  # the G pass backpropagates here
        with amp():
            loss_slm, _, _ = discriminator_loss([net_wd(f_real)],
                                                [net_wd(f_fake.detach())])
            loss_slm = share(loss_slm)
        state.opt_wd.zero_grad(set_to_none=True)
        loss_slm.backward()
        reduce(net_wd.parameters())
        state.opt_wd.step()
        metrics["loss/slm_disc"] = loss_slm.detach()
        mark("wd_update")

    # ---- generator update; the updated discriminators take no gradient ----
    y_mel, y_hat_mel = _mel_pair(cfg, spec, out)
    with amp():
        y_d_r, y_d_g, fmap_r, fmap_g = _frozen(net_d, y_slice, y_hat)
        # sums of per-row terms over the global mask sum: shares already
        loss_dur = torch.sum(out["l_length"].float())
        loss_mel = share(torch.mean(torch.abs(y_mel - y_hat_mel)) * t.c_mel)
        loss_kl = kl_loss(out["z_p"], out["logs_q"], out["m_p"],
                          out["logs_p"], out["y_mask"]) * t.c_kl
        loss_fm = share(feature_loss(fmap_r, fmap_g))
        loss_gen = share(generator_loss(y_d_g)[0])
        total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
        if net_dur_d is not None:
            probs = _frozen(net_dur_d, *(out[k] for k in DURATION_INPUTS))
            loss_dur_gen = share(generator_loss([probs[1]])[0])
            total = total + loss_dur_gen
            metrics["loss/dur_gen"] = loss_dur_gen.detach()
        if use_wd:
            loss_lm = share(torch.mean(torch.abs(f_real - f_fake)))
            loss_lm_gen = share(generator_loss([_frozen(net_wd, f_fake)])[0])
            total = total + loss_lm + loss_lm_gen
            metrics["loss/slm_feat"] = loss_lm.detach()
            metrics["loss/slm_gen"] = loss_lm_gen.detach()
    state.opt_g.zero_grad(set_to_none=True)
    total.backward()
    reduce(net_g.parameters())
    grad_norm_g = _global_norm(net_g.parameters())
    state.opt_g.step()
    state.step += 1
    mark("g_update")

    metrics.update({
        "loss/gen": loss_gen.detach(), "loss/fm": loss_fm.detach(),
        "loss/mel": loss_mel.detach(), "loss/dur": loss_dur.detach(),
        "loss/kl": loss_kl.detach(), "loss/disc": loss_disc.detach(),
        "loss/g_total": total.detach(), "grad_norm/g": grad_norm_g,
        "grad_norm/d": grad_norm_d})
    return metrics


@torch.no_grad()
def eval_step(cfg: Config, net_g: Synthesizer, batch: Batch,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """Validation pass: generator losses only, no updates, the generator in
    eval mode, MAS without noise (reference train.py:624-693)."""
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

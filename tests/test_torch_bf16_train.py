"""bf16 training of the port (`train.bf16_run`, or `fp16_run`), on the CPU
under `torch.autocast("cpu", bfloat16)`: the bf16 step against the port's
own f32 step from the same weights and draws, f32 master parameters and
AdamW state, `fp16_run` the same toggle, f32 scores into MAS, a bf16 step
of the published Vocos VITS2 recipe (shrunk) with the duration and WavLM
discriminators, and (`slow`) the bf16 step against `wetts_tpu`'s bf16
step.

Bounds are those of tests/test_train_bf16.py: `loss/disc` and `loss/mel`
within 0.15 relative of the f32 step's (bf16 keeps about 3 decimal
digits; the two frameworks' bf16 glue differs: autocast keeps norms,
softmax and elementwise chains in f32 where the JAX step casts whole
parameter trees).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from test_torch_slm import random_wavlm
from test_torch_train import jax_batch, parity_cfg, torch_batch
from test_torch_vits2_train import published_tiny, step_batch
from torch_port_common import (
    JaxConfig,
    jax_discriminator,
    jax_synthesizer,
    patch_shared_draws,
    port_discriminator,
    port_synthesizer,
    small_cfg_dict,
    train_batch,
)
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models import synthesizer
from wetts_tpu_torch.models.wavlm import WavLMConfig, make_slm_feature_fn
from wetts_tpu_torch.train.state import GANTrainState
from wetts_tpu_torch.train.step import (
    build_models,
    half_precision,
    init_weights_,
    train_step,
)

COARSE = ("loss/disc", "loss/mel")


def one_step(cfg_dict, batch, flag=None, slm_feature_fn=None):
    """(state before as parameter copies, state after, metrics) of one step
    from `init_weights_` at seed 0 with draws from a generator seeded 0;
    `flag` ("bf16_run" or "fp16_run") turns bf16 on."""
    cfg_dict = copy.deepcopy(cfg_dict)
    if flag:
        cfg_dict["train"][flag] = True
    cfg = Config.from_dict(cfg_dict)
    assert half_precision(cfg) == bool(flag)
    nets = build_models(cfg)
    init_weights_(nets[0], nets[1], torch.Generator().manual_seed(0),
                  *nets[2:])
    before = {k: v.detach().clone() for k, v in nets[0].named_parameters()}
    state = GANTrainState.create(cfg, *nets)
    metrics = train_step(cfg, state, batch, torch.Generator().manual_seed(0),
                         slm_feature_fn=slm_feature_fn)
    return before, state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def steps():
    """The small config's f32, bf16_run and fp16_run steps on one batch."""
    batch = torch_batch(train_batch(small_cfg_dict()))
    return {flag: one_step(small_cfg_dict(), batch, flag)
            for flag in (None, "bf16_run", "fp16_run")}


def test_bf16_step_tracks_the_f32_step(steps):
    _, _, m32 = steps[None]
    _, _, m16 = steps["bf16_run"]
    assert set(m16) == set(m32)
    for k in COARSE:
        assert abs(m16[k] - m32[k]) / (abs(m32[k]) + 1e-6) < 0.15, (
            k, m16[k], m32[k])
    assert m16 != m32  # bf16 did compute something else


def test_bf16_metrics_finite_and_parameters_moved(steps):
    before, state, metrics = steps["bf16_run"]
    for k, v in metrics.items():
        assert np.isfinite(v), (k, v)
    after = dict(state.net_g.named_parameters())
    moved = [k for k, v in before.items() if not torch.equal(v, after[k])]
    assert len(moved) > 0.9 * len(before)
    assert "dec.ups.0.weight_v" in moved and "enc_p.emb.weight" in moved


def test_bf16_keeps_f32_parameters_and_adamw_state(steps):
    _, state, _ = steps["bf16_run"]
    for name, net, opt in state.nets():
        for k, p in net.named_parameters():
            assert p.dtype == torch.float32, (name, k)
            assert p.grad is None or p.grad.dtype == torch.float32, (name, k)
        for per_param in opt.state.values():
            for k, v in per_param.items():
                if torch.is_tensor(v) and v.is_floating_point():
                    assert v.dtype == torch.float32, (name, k)
        assert opt.state, name


def test_fp16_run_is_the_bf16_toggle(steps):
    _, state16, m16 = steps["bf16_run"]
    _, state_fp, m_fp = steps["fp16_run"]
    assert m_fp == m16
    for (k, a), b in zip(state16.net_g.state_dict().items(),
                         state_fp.net_g.state_dict().values()):
        assert torch.equal(a, b), k


def test_mas_scores_stay_f32_under_autocast(monkeypatch):
    """What reaches `maximum_path` in a bf16 step is f32 (the JAX bf16
    step's preferred_element_type=f32), computed with autocast off."""
    seen = []
    real = synthesizer.maximum_path

    def mas(neg_cent, mask):
        seen.append((neg_cent.dtype, mask.dtype,
                     torch.is_autocast_enabled("cpu")))
        return real(neg_cent, mask)

    monkeypatch.setattr(synthesizer, "maximum_path", mas)
    batch = torch_batch(train_batch(small_cfg_dict()))
    one_step(small_cfg_dict(), batch, "bf16_run")
    assert seen == [(torch.float32, torch.float32, False)]


def test_bf16_vits2_step_with_the_wavlm_discriminator():
    """vits2_vocos_v1 as published (shrunk): noise-scaled MAS, the
    duration discriminator, MPMRD, Vocos with its iSTFT, and the WavLM
    branch behind a resample from 8 kHz; bf16 against f32 on the same
    weights and draws."""
    cfg = published_tiny("vits2_vocos_v1")
    wcfg = WavLMConfig.tiny()
    cfg["model"].update(use_wd=True, slm_hidden=wcfg.hidden_size,
                        slm_nlayers=wcfg.num_layers + 1,
                        slm_initial_channel=8)
    fn = make_slm_feature_fn(random_wavlm(wcfg, seed=1), 8000, 16000)
    batch = step_batch(published_tiny("vits2_vocos_v1"))
    _, _, m32 = one_step(cfg, batch, None, fn)
    _, state, m16 = one_step(cfg, batch, "bf16_run", fn)
    assert {"loss/slm_disc", "loss/slm_feat", "loss/slm_gen",
            "loss/dur_disc", "loss/dur_gen"} <= set(m16) == set(m32)
    assert all(np.isfinite(v) for v in m16.values()), m16
    for k in COARSE:
        assert abs(m16[k] - m32[k]) / (abs(m32[k]) + 1e-6) < 0.15, (
            k, m16[k], m32[k])
    assert all(p.dtype == torch.float32
               for _, net, _ in state.nets() for p in net.parameters())


@pytest.mark.slow  # the un-jitted JAX step takes minutes, as v1's do
def test_bf16_step_tracks_the_jax_bf16_step(monkeypatch):
    """One bf16 step of the port against one call of the un-jitted
    `make_train_step(..., use_fast_decoder=False)` with `bf16_run` (its
    `make_half_fns`), on the same weights and draws: `loss/disc` and
    `loss/mel` within 0.15 relative, every metric finite on both sides."""
    from wetts_tpu.train.state import GANTrainState as JaxTrainState
    from wetts_tpu.train.state import make_optimizer as jax_make_optimizer
    from wetts_tpu.train.step import make_train_step

    cfg = parity_cfg()
    cfg["train"]["bf16_run"] = True
    jcfg = JaxConfig.from_dict(copy.deepcopy(cfg))
    pcfg = Config.from_dict(copy.deepcopy(cfg))
    model, params = jax_synthesizer(parity_cfg())
    net_d, params_d = jax_discriminator()
    state = GANTrainState.create(pcfg, port_synthesizer(parity_cfg(), params),
                                 port_discriminator(params_d))
    patch_shared_draws(monkeypatch)
    batch = train_batch(parity_cfg())
    tx = jax_make_optimizer(jcfg)
    step_fn = make_train_step(jcfg, model, net_d, None, tx,
                              use_fast_decoder=False)
    jstate = JaxTrainState.create(tx, params["params"], params_d["params"])
    _, want = step_fn(jstate, jax_batch(batch), jax.random.PRNGKey(0))
    got = train_step(pcfg, state, torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(float(want[k])) and np.isfinite(float(got[k])), k
    for k in COARSE:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) / (abs(w) + 1e-6) < 0.15, (k, g, w)

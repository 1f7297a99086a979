"""The one rule for what inference derives from a module's tensors and keeps
(`models/layers.py`, `DerivedWeights`), held for every value the port
keeps: HiFi-GAN's weights at "f32" (K1's form), "bf16" and "int8", the
Vocos backbone's packed weights (VB's) and the synthesizer's bf16 flow,
each under every event that may or may not make it stale. Imports nothing
of JAX.
"""

import copy
import pickle

import pytest
import torch
from torch import nn

from test_torch_vocos_backbone import tiny_decoder
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models import hifigan
from wetts_tpu_torch.models import vocos_backbone as vb
from wetts_tpu_torch.models.synthesizer import Synthesizer


def _seeded(model: nn.Module, seed: int) -> nn.Module:
    """Every parameter U(-0.5, 0.5) from `seed`, then eval(), which folds
    the weight-norm buffers."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
    return model.eval()


def _generator(seed: int = 0) -> hifigan.Generator:
    return _seeded(hifigan.Generator(16, "1", (3, 5), ((1, 3), (1, 3)),
                                     (2, 2), 32, (4, 4), gin_channels=8),
                   seed)


def _vocos(seed: int = 0):
    return tiny_decoder(seed=seed).eval()


def _synthesizer(seed: int = 0) -> Synthesizer:
    cfg = Config.from_dict({
        "train": {"segment_size": 256},
        "data": {"filter_length": 64, "hop_length": 16, "win_length": 64},
        "model": {"inter_channels": 16, "hidden_channels": 16,
                  "filter_channels": 32, "n_layers": 1,
                  "resblock_kernel_sizes": [3],
                  "resblock_dilation_sizes": [[1, 3]],
                  "upsample_rates": [4, 4], "upsample_initial_channel": 32,
                  "upsample_kernel_sizes": [8, 8], "gin_channels": 8},
        "num_phones": 8, "num_speakers": 2})
    return _seeded(Synthesizer(cfg), seed)


def _form(precision):
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    return (_generator, lambda m: m.form(precision),
            lambda m: hifigan._Form(m, precision, dtype),
            lambda m: (m.resblocks[0].convs1[0], "weight"),
            lambda m: m.resblocks[0].convs1[0].weight_v)


# value: (make the module, look the value up, derive it afresh, one source
# tensor as (module, name), a tensor it is not derived from)
VALUES = {
    "k1_f32": _form("f32"),
    "bf16": _form("bf16"),
    "int8": _form("int8"),
    "vb_packed": (
        _vocos, lambda m: m.packed_weights(),
        lambda m: [vb.pack_weight(c.weight[:, :, 0]) for c in vb.convs(m)],
        lambda m: (m.layers[1].pw_conv2, "weight"),
        lambda m: m.norm_pre.gamma),
    "flow_bf16": (
        _synthesizer, lambda m: m.flow_at("bf16"),
        lambda m: copy.deepcopy(m.flow).to(torch.bfloat16),
        lambda m: (m.flow.flows[0].pre, "weight"),
        lambda m: m.dec.conv_pre.weight),
}


def _tensors(value) -> list:
    """Every tensor a derived value holds, in a fixed order."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, nn.Module):
        return list(value.state_dict().values())
    if isinstance(value, dict):
        return [t for k in sorted(value, key=str) for t in _tensors(value[k])]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    if hasattr(value, "__dict__"):  # a form, a quantised conv
        return _tensors(vars(value))
    return []


def _holds(value, want) -> bool:
    got, want = _tensors(value), _tensors(want)
    return len(got) == len(want) > 0 and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


def _current(value, m, fresh) -> bool:
    with torch.no_grad():
        return _holds(value, fresh(m))


EVENTS = ("kept", "load_state_dict", "train_step_eval", "in_place_write",
          "double_float", "copy_and_pickle", "inference_replacement")


@pytest.mark.parametrize("event", EVENTS)
@pytest.mark.parametrize("value", VALUES)
def test_derived_value_follows_its_sources(value, event):
    make, get, fresh, source, other = VALUES[value]
    m = make()
    keys = set(m.state_dict())
    first = get(m)
    assert _current(first, m, fresh)
    # "f32" holds the module's own tensors, which events write in place
    before = [t.clone() for t in _tensors(first)]
    if event == "kept":
        # kept while nothing it is derived from changes, other tensors
        # included; never in the state_dict
        with torch.no_grad():
            other(m).mul_(2.0)
        assert get(m) is first and set(m.state_dict()) == keys
        return
    if event == "copy_and_pickle":
        # copies and pickles carry none: they pickle as one that never
        # derived anything, and derive their own
        size = len(pickle.dumps(make()))
        twin, clone = copy.deepcopy(m), pickle.loads(pickle.dumps(m))
        assert len(pickle.dumps(m)) == len(pickle.dumps(twin)) == size
        for copied in (twin, clone):
            got = get(copied)
            assert got is not first and _current(got, copied, fresh)
            assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
                _tensors(got), _tensors(first)))
        assert get(m) is first
        return
    if event == "inference_replacement":
        # made and used under inference_mode: its sources keep no version
        # counter, and a replacement alone makes it anew
        with torch.inference_mode():
            m.double().float()
            module, name = source(m)
            assert getattr(module, name).is_inference()
            first = get(m)
            assert get(m) is first
            before = [t.clone() for t in _tensors(first)]
            t = getattr(module, name) * 2
            setattr(module, name,
                    nn.Parameter(t) if name in module._parameters else t)
            again = get(m)
        assert again is not first and _current(again, m, fresh)
        assert not _holds(again, before)
        return
    if event == "load_state_dict":
        m.load_state_dict(make(seed=1).state_dict())
    elif event == "train_step_eval":
        # train() -> an optimiser step -> eval(), which refolds in place
        m.train()
        opt = torch.optim.SGD(m.parameters(), lr=0.5)
        sum((p * p).sum() for p in m.parameters()).backward()
        opt.step()
        m.eval()
    elif event == "in_place_write":
        module, name = source(m)
        with torch.no_grad():
            getattr(module, name).mul_(1.5)
    elif event == "double_float":
        m.double().float()
    again = get(m)
    assert again is not first and _current(again, m, fresh)
    if event != "double_float":
        assert not _holds(again, before)

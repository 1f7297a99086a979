"""The weight bridge between flax param trees and the port's state_dicts.

`convert_synthesizer(state_dict, cfg, subset)` is the port's own copy of
`wetts_tpu.utils.convert.convert_synthesizer` and its mappers (numpy only):
a reference `SynthesizerTrn` state_dict (a released `G_*.pth`, the
initializers of a `final.onnx`, or the port's own state_dict, which keeps the
reference's names) -> the flax tree, with the JAX package's handling of
checkpoint quirks (folded weight norm, the unused `post_transformer`) and
its errors on unmapped tensors. `cli/model.py` loads every artifact through
it and then `params_from_jax`.

`params_from_jax(tree, cfg)` is the inverse of
`wetts_tpu.utils.convert.convert_synthesizer`,
`discriminator_from_jax(tree, use_mrd)` of `convert_discriminator` (the
multi-period discriminator, or with `use_mrd` the multi-period
multi-resolution one), `duration_discriminator_from_jax(tree, dtype)` of
`convert_duration_discriminator`, `wavlm_discriminator_from_jax(tree)`
of `convert_wavlm_discriminator`, and `frontend_params_from_jax(params,
meta)` of
`wetts_tpu.models.bert_frontend.convert_frontend_torch` (the BERT frontend:
Dense kernels transposed into `nn.Linear` weights, LayerNorm scale/bias to
weight/bias, embeddings as they are). `params_from_jax` takes a flax param tree of
numpy arrays (for example from `utils/params_io.load_params_npz`) and returns
a state_dict in the reference `SynthesizerTrn`'s names and layouts, which the
port's modules keep. Layout rules (the inverse of convert.py's table):

| flax param                    | torch tensor                             |
|-------------------------------|------------------------------------------|
| Conv1d kernel/v [K, I, O]     | weight/weight_v [O, I, K]                |
| Dense kernel [I, O]           | weight [O, I, 1] (reference 1x1 Conv1d)  |
| ConvTranspose kernel/v [I,O,K]| weight/weight_v [I, O, K] (unchanged)    |
| Conv2d kernel/v [Kh, Kw, I, O]| weight/weight_v [O, I, Kh, Kw]           |
| g [O] / [I]                   | weight_g [O, 1, 1] / [I, 1, 1] / [O,1,1,1]|
| ln/scale, ln/bias             | gamma, beta                              |
| emb, emb_g/embedding          | emb.weight, emb_g.weight                 |
| ElementwiseAffine m/logs [C]  | m/logs [C, 1]                            |

Every leaf of the tree must map; an unmapped leaf raises. The port keeps
the reference's state_dict names, so the JAX package's own converters read
the port's state_dicts as `convert_synthesizer` does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from wetts_tpu_torch.models.discriminators import DiscriminatorR

Path = Tuple[str, ...]


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _leaves(node: Any, path: Path = ()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path


class FlaxToTorch:
    """Maps flax subtrees to torch state_dict entries, module by module.

    Each method takes the subtree's path in the flax tree and the torch
    name prefix of the module; `state` collects the tensors.
    """

    def __init__(self, tree: Dict):
        self.tree = tree
        self.state: Dict[str, torch.Tensor] = {}
        self._used = set()

    def node(self, path: Path) -> Any:
        node = self.tree
        for p in path:
            node = node[p]
        return node

    def _get(self, path: Path) -> np.ndarray:
        self._used.add(path)
        return np.asarray(self.node(path), dtype=np.float32)

    def put(self, name: str, path: Path, fn=lambda a: a) -> None:
        self.state[name] = torch.from_numpy(
            np.ascontiguousarray(fn(self._get(path))))

    def conv(self, path: Path, prefix: str, transpose: bool = False) -> None:
        """Conv1d / Dense / ConvTranspose1d, weight-normed or plain."""
        node = self.node(path)
        if transpose:
            to_torch = lambda k: k  # noqa: E731  torch layout already
        else:
            to_torch = lambda k: (  # noqa: E731
                k.T[:, :, None] if k.ndim == 2
                else k.transpose(2, 1, 0) if k.ndim == 3
                else k.transpose(3, 2, 0, 1))  # Conv2d HWIO -> OIHW
        if "v" in node:
            self.put(_join(prefix, "weight_v"), path + ("v",), to_torch)
            ones = (1,) * (np.ndim(node["v"]) - 1)
            self.put(_join(prefix, "weight_g"), path + ("g",),
                     lambda g: g.reshape(-1, *ones))
        else:
            self.put(_join(prefix, "weight"), path + ("kernel",), to_torch)
        if "bias" in node:
            self.put(_join(prefix, "bias"), path + ("bias",))

    def dense(self, path: Path, prefix: str) -> None:
        """Dense [I, O] -> nn.Linear weight [O, I] and bias."""
        self.put(_join(prefix, "weight"), path + ("kernel",), lambda k: k.T)
        self.put(_join(prefix, "bias"), path + ("bias",))

    def norm(self, path: Path, prefix: str) -> None:
        """flax LayerNorm -> nn.LayerNorm weight and bias."""
        self.put(_join(prefix, "weight"), path + ("scale",))
        self.put(_join(prefix, "bias"), path + ("bias",))

    def layer_norm(self, path: Path, prefix: str) -> None:
        self.put(_join(prefix, "gamma"), path + ("ln", "scale"))
        self.put(_join(prefix, "beta"), path + ("ln", "bias"))

    def mha(self, path: Path, prefix: str) -> None:
        for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
            self.conv(path + (nm,), _join(prefix, nm))
        for nm in ("emb_rel_k", "emb_rel_v"):
            if nm in self.node(path):
                self.put(_join(prefix, nm), path + (nm,))

    def ffn(self, path: Path, prefix: str) -> None:
        for nm in ("conv_1", "conv_2"):
            self.conv(path + (nm,), _join(prefix, nm))

    def encoder(self, path: Path, prefix: str, n_layers: int) -> None:
        if "spk_emb_linear" in self.node(path):
            self.dense(path + ("spk_emb_linear",),
                       _join(prefix, "spk_emb_linear"))
        for i in range(n_layers):
            self.mha(path + (f"attn_{i}",), _join(prefix, f"attn_layers.{i}"))
            self.layer_norm(path + (f"norm1_{i}",),
                            _join(prefix, f"norm_layers_1.{i}"))
            self.ffn(path + (f"ffn_{i}",), _join(prefix, f"ffn_layers.{i}"))
            self.layer_norm(path + (f"norm2_{i}",),
                            _join(prefix, f"norm_layers_2.{i}"))

    def fft(self, path: Path, prefix: str, n_layers: int) -> None:
        """attention.FFT: the gated speaker conditioning, then per layer the
        causal self-attention, two norms and the FFN."""
        if "cond_layer" in self.node(path):
            self.conv(path + ("cond_layer",), _join(prefix, "cond_layer"))
            self.conv(path + ("cond_pre",), _join(prefix, "cond_pre"))
        for i in range(n_layers):
            self.mha(path + (f"self_attn_{i}",),
                     _join(prefix, f"self_attn_layers.{i}"))
            self.layer_norm(path + (f"norm0_{i}",),
                            _join(prefix, f"norm_layers_0.{i}"))
            self.ffn(path + (f"ffn_{i}",), _join(prefix, f"ffn_layers.{i}"))
            self.layer_norm(path + (f"norm1_{i}",),
                            _join(prefix, f"norm_layers_1.{i}"))

    def wn(self, path: Path, prefix: str, n_layers: int) -> None:
        if "cond_layer" in self.node(path):
            self.conv(path + ("cond_layer",), _join(prefix, "cond_layer"))
        for i in range(n_layers):
            self.conv(path + (f"in_{i}",), _join(prefix, f"in_layers.{i}"))
            self.conv(path + (f"res_skip_{i}",),
                      _join(prefix, f"res_skip_layers.{i}"))

    def dds_conv(self, path: Path, prefix: str, n_layers: int = 3) -> None:
        for i in range(n_layers):
            self.conv(path + (f"sep_{i}",), _join(prefix, f"convs_sep.{i}"))
            self.conv(path + (f"pw_{i}",), _join(prefix, f"convs_1x1.{i}"))
            self.layer_norm(path + (f"norm1_{i}",),
                            _join(prefix, f"norms_1.{i}"))
            self.layer_norm(path + (f"norm2_{i}",),
                            _join(prefix, f"norms_2.{i}"))

    def conv_flow(self, path: Path, prefix: str) -> None:
        self.conv(path + ("pre",), _join(prefix, "pre"))
        self.dds_conv(path + ("convs",), _join(prefix, "convs"))
        self.conv(path + ("proj",), _join(prefix, "proj"))

    def elementwise_affine(self, path: Path, prefix: str) -> None:
        for nm in ("m", "logs"):
            self.put(_join(prefix, nm), path + (nm,),
                     lambda a: a.reshape(-1, 1))

    def coupling(self, path: Path, prefix: str, n_layers: int,
                 ftype=None) -> None:
        """A flow coupling of transformer flow type `ftype` (None, or a
        mono type: the VITS1 coupling). The `fft` coupling's FFT has as many
        layers as the flow's dilation rate, 1 (the reference's argument
        swap); `pre_conv` has a 2-layer pre_transformer, `pre_conv2` a
        1-layer one."""
        self.conv(path + ("pre",), _join(prefix, "pre"))
        if ftype == "fft":
            self.fft(path + ("enc",), _join(prefix, "enc"), 1)
        else:
            self.wn(path + ("enc",), _join(prefix, "enc"), n_layers)
        if ftype in ("pre_conv", "pre_conv2"):
            self.encoder(path + ("pre_transformer",),
                         _join(prefix, "pre_transformer"),
                         2 if ftype == "pre_conv" else 1)
        self.conv(path + ("post",), _join(prefix, "post"))

    def flow(self, path: Path, prefix: str, ftype=None) -> None:
        """flows.ResidualCouplingBlock of transformer flow type `ftype`
        (None: VITS1): 4 flows, their couplings of 4 WN layers. A mono type
        adds a third module to each period: indices 3i and 3i + 2."""
        mono = ftype in ("mono_layer_inter_residual",
                         "mono_layer_post_residual")
        period = 3 if mono else 2
        for i in range(4):
            self.coupling(path + (f"flow_{i}",),
                          _join(prefix, f"flows.{period * i}"), 4, ftype)
            if mono:
                src = path + (f"mono_{i}",)
                dst = _join(prefix, f"flows.{period * i + 2}")
                self.encoder(src + ("pre_transformer",),
                             f"{dst}.pre_transformer", 2)
                self.conv(src + ("post",), f"{dst}.post")

    def vocos(self, path: Path, prefix: str, n_layers: int) -> None:
        self.conv(path + ("in_conv",), _join(prefix, "in_conv"))
        if "cond" in self.node(path):
            self.conv(path + ("cond",), _join(prefix, "cond"))
        self.layer_norm(path + ("norm_pre",), _join(prefix, "norm_pre"))
        for i in range(n_layers):
            src, dst = path + (f"layer_{i}",), _join(prefix, f"layers.{i}")
            for nm in ("dw_conv", "pw_conv1", "pw_conv2"):
                self.conv(src + (nm,), f"{dst}.{nm}")
            self.layer_norm(src + ("norm",), f"{dst}.norm")
            self.put(f"{dst}.scale", src + ("scale",))
        self.layer_norm(path + ("norm_post",), _join(prefix, "norm_post"))
        self.conv(path + ("out_conv",), _join(prefix, "out_conv"))

    def generator(self, path: Path, prefix: str, cfg) -> None:
        mc = cfg.model
        node = self.node(path)
        self.conv(path + ("conv_pre",), _join(prefix, "conv_pre"))
        if "cond" in node:
            self.conv(path + ("cond",), _join(prefix, "cond"))
        n_k = len(mc.resblock_kernel_sizes)
        for i in range(len(mc.upsample_rates)):
            self.conv(path + (f"up_{i}",), _join(prefix, f"ups.{i}"),
                      transpose=True)
            for j, dils in enumerate(mc.resblock_dilation_sizes):
                rb = path + (f"resblock_{i}_{j}",)
                tname = _join(prefix, f"resblocks.{i * n_k + j}")
                for k in range(len(dils)):
                    if mc.resblock == "1":
                        self.conv(rb + (f"conv1_{k}",), f"{tname}.convs1.{k}")
                        self.conv(rb + (f"conv2_{k}",), f"{tname}.convs2.{k}")
                    else:
                        self.conv(rb + (f"conv_{k}",), f"{tname}.convs.{k}")
        self.conv(path + ("conv_post",), _join(prefix, "conv_post"))

    def check_all_used(self) -> None:
        leftovers = ["/".join(p) for p in _leaves(self.tree)
                     if p not in self._used]
        if leftovers:
            raise ValueError(f"unmapped flax params: {leftovers[:10]}"
                             f" (+{max(0, len(leftovers) - 10)} more)")


def params_from_jax(tree: Dict, cfg) -> Dict[str, torch.Tensor]:
    """Flax Synthesizer params (VITS1 or VITS2: every transformer flow
    type, the speaker-conditioned text encoder; HiFi-GAN or Vocos) -> the
    port's state_dict.

    tree: `{"params": {...}}` or the inner dict, leaves numpy-convertible.
    cfg: the port's Config (layer counts and feature flags).
    """
    tree = tree.get("params", tree)
    mc = cfg.model
    m = FlaxToTorch(tree)
    m.put("enc_p.emb.weight", ("enc_p", "emb"))
    m.encoder(("enc_p", "encoder"), "enc_p.encoder", mc.n_layers)
    m.conv(("enc_p", "proj"), "enc_p.proj")
    m.conv(("enc_q", "pre"), "enc_q.pre")
    m.wn(("enc_q", "enc"), "enc_q.enc", 16)
    m.conv(("enc_q", "proj"), "enc_q.proj")
    m.flow(("flow",), "flow",
           mc.transformer_flow_type if mc.use_transformer_flows else None)
    if mc.use_sdp:
        for side, src in (("flows", "flow"), ("post_flows", "post_flow")):
            m.elementwise_affine(("dp", f"{src}_ea"), f"dp.{side}.0")
            for i in range(4):
                m.conv_flow(("dp", f"{src}_conv_{i}"),
                            f"dp.{side}.{1 + 2 * i}")
        for nm in ("post_pre", "post_proj", "pre", "proj"):
            m.conv(("dp", nm), f"dp.{nm}")
        m.dds_conv(("dp", "post_convs"), "dp.post_convs")
        m.dds_conv(("dp", "convs"), "dp.convs")
    else:
        for nm in ("conv_1", "conv_2", "proj"):
            m.conv(("dp", nm), f"dp.{nm}")
        m.layer_norm(("dp", "norm_1"), "dp.norm_1")
        m.layer_norm(("dp", "norm_2"), "dp.norm_2")
    if "cond" in tree["dp"]:
        m.conv(("dp", "cond"), "dp.cond")
    if mc.vocoder_type == "vocos":
        m.vocos(("dec",), "dec", mc.vocos_num_layers)
    else:
        m.generator(("dec",), "dec", cfg)
    if "emb_g" in tree:
        m.put("emb_g.weight", ("emb_g", "embedding"))
    m.check_all_used()
    return m.state


def discriminator_from_jax(tree: Dict, use_mrd: bool = False,
                           periods=(2, 3, 5, 7, 11),
                           fft_sizes=(2048, 1024, 512)
                           ) -> Dict[str, torch.Tensor]:
    """Flax MultiPeriodDiscriminator params -> the port's state_dict
    (`discriminators.0` the scale discriminator, then one per period); with
    `use_mrd`, MultiPeriodMultiResolutionDiscriminator params (one
    resolution discriminator per FFT size, then one per period)."""
    tree = tree.get("params", tree)
    m = FlaxToTorch(tree)
    if use_mrd:
        for idx, w in enumerate(fft_sizes):
            base = f"discriminators.{idx}"
            for b in range(len(DiscriminatorR.BANDS)):
                for j in range(len(DiscriminatorR.CONVS)):
                    m.conv((f"disc_r_{w}", f"band{b}_conv{j}"),
                           f"{base}.band_convs.{b}.{j}")
            m.conv((f"disc_r_{w}", "conv_post"), f"{base}.conv_post")
    else:
        for i in range(6):
            m.conv(("disc_s", f"conv_{i}"), f"discriminators.0.convs.{i}")
        m.conv(("disc_s", "conv_post"), "discriminators.0.conv_post")
    first = len(fft_sizes) if use_mrd else 1
    for idx, p in enumerate(periods, start=first):
        for i in range(5):
            m.conv((f"disc_p_{p}", f"conv_{i}"),
                   f"discriminators.{idx}.convs.{i}")
        m.conv((f"disc_p_{p}", "conv_post"),
               f"discriminators.{idx}.conv_post")
    m.check_all_used()
    return m.state


def duration_discriminator_from_jax(tree: Dict, dtype: str = "dur_disc_1"
                                    ) -> Dict[str, torch.Tensor]:
    """Flax DurationDiscriminatorV1 (`dtype` "dur_disc_1") or V2
    ("dur_disc_2") params -> the port's state_dict. V1's `pre_out_norm_*`,
    which its forward never uses and the JAX module does not have, come out
    at the identity (gamma 1, beta 0)."""
    tree = tree.get("params", tree)
    m = FlaxToTorch(tree)
    for name in ("conv_1", "conv_2", "dur_proj", "pre_out_conv_1",
                 "pre_out_conv_2"):
        m.conv((name,), name)
    norms = ("pre_out_norm_1", "pre_out_norm_2")
    if dtype == "dur_disc_2":
        for name in ("norm_1", "norm_2") + norms:
            m.layer_norm((name,), name)
    else:
        channels = np.shape(m.node(("pre_out_conv_1", "kernel")))[-1]
        for name in norms:
            m.state[f"{name}.gamma"] = torch.ones(channels)
            m.state[f"{name}.beta"] = torch.zeros(channels)
    m.dense(("output_layer",), "output_layer.0")
    m.check_all_used()
    return m.state


def wavlm_discriminator_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax WavLMDiscriminator params -> the port's state_dict (`pre`,
    `convs.{0,1,2}`, `conv_post`, each weight-normed)."""
    m = FlaxToTorch(tree.get("params", tree))
    m.conv(("pre",), "pre")
    for i in range(3):
        m.conv((f"conv_{i}",), f"convs.{i}")
    m.conv(("conv_post",), "conv_post")
    m.check_all_used()
    return m.state


def frontend_params_from_jax(params: Dict, meta: Dict
                             ) -> Dict[str, torch.Tensor]:
    """Flax FrontendModel params -> the port's `FrontendModel` state_dict.

    params: `{"params": {...}}` or the inner dict (`bert`, `transform`,
    `phone_classifier`, `prosody_classifier`), leaves numpy-convertible.
    meta: what `convert_frontend_torch` returns beside the params; only
    `meta["bert"].num_layers` is read. A missing leaf raises KeyError, a
    leaf left over ValueError.
    """
    tree = params.get("params", params)
    m = FlaxToTorch(tree)
    b = ("bert",)
    for nm in ("word_embeddings", "position_embeddings",
               "token_type_embeddings"):
        m.put(f"bert.embeddings.{nm}.weight", b + (nm, "embedding"))
    m.norm(b + ("embeddings_norm",), "bert.embeddings.LayerNorm")
    for i in range(meta["bert"].num_layers):
        src, dst = b + (f"layer_{i}",), f"bert.encoder.layer.{i}"
        for nm in ("query", "key", "value"):
            m.dense(src + ("attention", nm), f"{dst}.attention.self.{nm}")
        m.dense(src + ("attention", "output"),
                f"{dst}.attention.output.dense")
        m.norm(src + ("attention_norm",), f"{dst}.attention.output.LayerNorm")
        m.dense(src + ("intermediate",), f"{dst}.intermediate.dense")
        m.dense(src + ("ffn_output",), f"{dst}.output.dense")
        m.norm(src + ("output_norm",), f"{dst}.output.LayerNorm")
    t = ("transform",)
    m.put("transform.self_attn.in_proj_weight", t + ("in_proj", "kernel"),
          lambda k: k.T)
    m.put("transform.self_attn.in_proj_bias", t + ("in_proj", "bias"))
    m.dense(t + ("out_proj",), "transform.self_attn.out_proj")
    for nm in ("linear1", "linear2"):
        m.dense(t + (nm,), f"transform.{nm}")
    for nm in ("norm1", "norm2"):
        m.norm(t + (nm,), f"transform.{nm}")
    for nm in ("phone_classifier", "prosody_classifier"):
        m.dense((nm,), nm)
    m.check_all_used()
    return m.state


# ---------------------------------------------------------------------------
# reference state_dicts -> flax trees (wetts_tpu/utils/convert.py:31-397)
# ---------------------------------------------------------------------------


def _conv_w(w: np.ndarray) -> np.ndarray:
    """[O, I, K] -> [K, I, O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _dense_w(w: np.ndarray) -> np.ndarray:
    """[O, I] or [O, I, 1] -> [I, O]."""
    if w.ndim == 3:
        w = w[:, :, 0]
    return np.ascontiguousarray(w.T)


def _conv2d_w(w: np.ndarray) -> np.ndarray:
    """[O, I, Kh, Kw] -> [Kh, Kw, I, O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _g(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.reshape(-1))


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value, dtype=np.float32)


class _Mapper:
    """Collects torch (name, tensor) pairs into a flax param dict."""

    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.unused = []

    # -- building blocks ------------------------------------------------
    def _wn_pair(self, tname: str, sd: Dict, norm_axes):
        """(v, g) for a weight-normed tensor; folds when the checkpoint was
        exported with `remove_weight_norm` (export_onnx.py:80-82) and only
        carries the plain `weight` (w == g * v/||v|| holds with v = w,
        g = ||w|| over `norm_axes`, torch weight_norm dim=0 semantics)."""
        if tname + ".weight_v" in sd:
            return sd.pop(tname + ".weight_v"), sd.pop(tname + ".weight_g")
        w = sd.pop(tname + ".weight")
        g = np.sqrt((w.astype(np.float64) ** 2).sum(axis=norm_axes))
        return w, g.astype(w.dtype)

    def conv1d(self, tname: str, sd: Dict, path, dense=False, wn=False):
        """Map a torch Conv1d (possibly weight-normed) at `tname`."""
        if wn:
            v, g = self._wn_pair(tname, sd, norm_axes=(1, 2))
            _set(self.params, path + ("v",), _conv_w(v))
            _set(self.params, path + ("g",), _g(g))
        else:
            w = sd.pop(tname + ".weight")
            if dense:
                _set(self.params, path + ("kernel",), _dense_w(w))
            else:
                _set(self.params, path + ("kernel",), _conv_w(w))
        b = sd.pop(tname + ".bias", None)
        if b is not None:
            _set(self.params, path + ("bias",), b)

    def conv_transpose(self, tname: str, sd: Dict, path, wn=True):
        if wn:
            v, g = self._wn_pair(tname, sd, norm_axes=(1, 2))
            _set(self.params, path + ("v",), v)
            _set(self.params, path + ("g",), _g(g))
        else:
            _set(self.params, path + ("kernel",), sd.pop(tname + ".weight"))
        b = sd.pop(tname + ".bias", None)
        if b is not None:
            _set(self.params, path + ("bias",), b)

    def conv2d(self, tname: str, sd: Dict, path, wn=True):
        if wn:
            v, g = self._wn_pair(tname, sd, norm_axes=(1, 2, 3))
            _set(self.params, path + ("v",), _conv2d_w(v))
            _set(self.params, path + ("g",), _g(g))
        else:
            _set(self.params, path + ("kernel",), _conv2d_w(
                sd.pop(tname + ".weight")))
        b = sd.pop(tname + ".bias", None)
        if b is not None:
            _set(self.params, path + ("bias",), b)

    def layer_norm(self, tname: str, sd: Dict, path):
        _set(self.params, path + ("ln", "scale"), sd.pop(tname + ".gamma"))
        _set(self.params, path + ("ln", "bias"), sd.pop(tname + ".beta"))

    def linear(self, tname: str, sd: Dict, path):
        _set(self.params, path + ("kernel",), _dense_w(sd.pop(tname + ".weight")))
        b = sd.pop(tname + ".bias", None)
        if b is not None:
            _set(self.params, path + ("bias",), b)

    # -- composite modules ----------------------------------------------
    def wn_block(self, tname: str, sd: Dict, path, n_layers: int,
                 has_cond: bool):
        cond_present = (tname + ".cond_layer.weight_v" in sd
                        or tname + ".cond_layer.weight" in sd)  # folded
        if has_cond and cond_present:
            self.conv1d(tname + ".cond_layer", sd, path + ("cond_layer",),
                        wn=True)
        elif cond_present:
            # zero-gin cond layer exists in torch but is unused
            sd.pop(tname + ".cond_layer.weight_v", None)
            sd.pop(tname + ".cond_layer.weight_g", None)
            sd.pop(tname + ".cond_layer.weight", None)
            sd.pop(tname + ".cond_layer.bias", None)
        for i in range(n_layers):
            self.conv1d(f"{tname}.in_layers.{i}", sd, path + (f"in_{i}",),
                        wn=True)
            self.conv1d(f"{tname}.res_skip_layers.{i}", sd,
                        path + (f"res_skip_{i}",), wn=True)

    def mha(self, tname: str, sd: Dict, path, rel=True):
        for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
            self.conv1d(f"{tname}.{nm}", sd, path + (nm,), dense=True)
        if rel and (tname + ".emb_rel_k") in sd:
            _set(self.params, path + ("emb_rel_k",), sd.pop(tname + ".emb_rel_k"))
            _set(self.params, path + ("emb_rel_v",), sd.pop(tname + ".emb_rel_v"))

    def ffn(self, tname: str, sd: Dict, path):
        self.conv1d(f"{tname}.conv_1", sd, path + ("conv_1",))
        self.conv1d(f"{tname}.conv_2", sd, path + ("conv_2",))

    def encoder(self, tname: str, sd: Dict, path, n_layers: int):
        if (tname + ".spk_emb_linear.weight") in sd:
            self.linear(tname + ".spk_emb_linear", sd,
                        path + ("spk_emb_linear",))
        for i in range(n_layers):
            self.mha(f"{tname}.attn_layers.{i}", sd, path + (f"attn_{i}",))
            self.layer_norm(f"{tname}.norm_layers_1.{i}", sd,
                            path + (f"norm1_{i}",))
            self.ffn(f"{tname}.ffn_layers.{i}", sd, path + (f"ffn_{i}",))
            self.layer_norm(f"{tname}.norm_layers_2.{i}", sd,
                            path + (f"norm2_{i}",))

    def fft(self, tname: str, sd: Dict, path, n_layers: int):
        if (tname + ".cond_layer.weight_v") in sd:
            self.conv1d(tname + ".cond_layer", sd, path + ("cond_layer",),
                        wn=True)
            self.conv1d(tname + ".cond_pre", sd, path + ("cond_pre",))
        for i in range(n_layers):
            self.mha(f"{tname}.self_attn_layers.{i}", sd,
                     path + (f"self_attn_{i}",), rel=False)
            self.layer_norm(f"{tname}.norm_layers_0.{i}", sd,
                            path + (f"norm0_{i}",))
            self.ffn(f"{tname}.ffn_layers.{i}", sd, path + (f"ffn_{i}",))
            self.layer_norm(f"{tname}.norm_layers_1.{i}", sd,
                            path + (f"norm1_{i}",))

    def dds_conv(self, tname: str, sd: Dict, path, n_layers: int = 3):
        for i in range(n_layers):
            self.conv1d(f"{tname}.convs_sep.{i}", sd, path + (f"sep_{i}",))
            self.conv1d(f"{tname}.convs_1x1.{i}", sd, path + (f"pw_{i}",))
            self.layer_norm(f"{tname}.norms_1.{i}", sd, path + (f"norm1_{i}",))
            self.layer_norm(f"{tname}.norms_2.{i}", sd, path + (f"norm2_{i}",))

    def conv_flow(self, tname: str, sd: Dict, path):
        self.conv1d(f"{tname}.pre", sd, path + ("pre",))
        self.dds_conv(f"{tname}.convs", sd, path + ("convs",))
        self.conv1d(f"{tname}.proj", sd, path + ("proj",))

    def elementwise_affine(self, tname: str, sd: Dict, path):
        _set(self.params, path + ("m",), _g(sd.pop(tname + ".m")))
        _set(self.params, path + ("logs",), _g(sd.pop(tname + ".logs")))


class _LenientMapper(_Mapper):
    """Mapper that skips absent tensors leaf-by-leaf.

    Exported inference graphs omit whole modules (final.onnx has no enc_q;
    the SDP's reverse path drops one "useless" ConvFlow,
    duration_predictors.py:255-256), so any leaf may be missing. Skipped
    leaves keep their freshly-initialized values after the caller's merge.
    """

    def _skip(self, method, *args, **kwargs):
        try:
            method(*args, **kwargs)
        except KeyError:
            pass

    def conv1d(self, *a, **k):
        self._skip(super().conv1d, *a, **k)

    def conv_transpose(self, *a, **k):
        self._skip(super().conv_transpose, *a, **k)

    def conv2d(self, *a, **k):
        self._skip(super().conv2d, *a, **k)

    def layer_norm(self, *a, **k):
        self._skip(super().layer_norm, *a, **k)

    def linear(self, *a, **k):
        self._skip(super().linear, *a, **k)

    def elementwise_affine(self, *a, **k):
        self._skip(super().elementwise_affine, *a, **k)


def convert_synthesizer(state_dict: Dict[str, np.ndarray], cfg,
                        subset: bool = False) -> Dict:
    """Reference SynthesizerTrn state_dict -> flax params for Synthesizer.

    cfg: the port's Config (used for layer counts / feature flags).
    subset: tolerate missing top-level sections — exported inference graphs
    carry only the modules they trace (final.onnx has no enc_q; streaming
    encoder_*.onnx has no dec — export_onnx.py:93-158). The returned partial
    tree is merged over freshly-initialized params by the caller.
    """
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    m = _LenientMapper() if subset else _Mapper()
    mc = cfg.model

    def has(marker: str) -> bool:
        return not subset or marker in sd

    # ---- enc_p -------------------------------------------------------
    if has("enc_p.emb.weight"):
        _set(m.params, ("enc_p", "emb"), sd.pop("enc_p.emb.weight"))
        m.encoder("enc_p.encoder", sd, ("enc_p", "encoder"), mc.n_layers)
        m.conv1d("enc_p.proj", sd, ("enc_p", "proj"))

    # ---- enc_q -------------------------------------------------------
    if has("enc_q.pre.weight"):
        m.conv1d("enc_q.pre", sd, ("enc_q", "pre"))
        m.wn_block("enc_q.enc", sd, ("enc_q", "enc"), 16,
                   has_cond=mc.gin_channels > 0)
        m.conv1d("enc_q.proj", sd, ("enc_q", "proj"))

    # ---- flow --------------------------------------------------------
    ftype = mc.transformer_flow_type if mc.use_transformer_flows else None
    n_flows = 4 if has("flow.flows.0.pre.weight") else 0
    if ftype in ("mono_layer_inter_residual", "mono_layer_post_residual"):
        for i in range(n_flows):
            base = f"flow.flows.{3 * i}"
            path = ("flow", f"flow_{i}")
            m.conv1d(f"{base}.pre", sd, path + ("pre",))
            m.wn_block(f"{base}.enc", sd, path + ("enc",), 4,
                       has_cond=mc.gin_channels > 0)
            m.conv1d(f"{base}.post", sd, path + ("post",))
            mono = f"flow.flows.{3 * i + 2}"
            mpath = ("flow", f"mono_{i}")
            m.encoder(f"{mono}.pre_transformer", sd,
                      mpath + ("pre_transformer",), 2)
            m.conv1d(f"{mono}.post", sd, mpath + ("post",))
    else:
        for i in range(n_flows):
            base = f"flow.flows.{2 * i}"
            path = ("flow", f"flow_{i}")
            if ftype is None:
                m.conv1d(f"{base}.pre", sd, path + ("pre",))
                m.wn_block(f"{base}.enc", sd, path + ("enc",), 4,
                           has_cond=mc.gin_channels > 0)
                m.conv1d(f"{base}.post", sd, path + ("post",))
            elif ftype == "pre_conv":
                m.encoder(f"{base}.pre_transformer", sd,
                          path + ("pre_transformer",), 2)
                m.conv1d(f"{base}.pre", sd, path + ("pre",))
                m.wn_block(f"{base}.enc", sd, path + ("enc",), 4,
                           has_cond=mc.gin_channels > 0)
                m.conv1d(f"{base}.post", sd, path + ("post",))
                # reference creates an (unused) experimental post_transformer
                # (flows.py:132-157) — discard its tensors
                for k in [k for k in sd
                          if k.startswith(f"{base}.post_transformer.")]:
                    sd.pop(k)
            elif ftype == "pre_conv2":
                m.conv1d(f"{base}.pre", sd, path + ("pre",))
                m.encoder(f"{base}.pre_transformer", sd,
                          path + ("pre_transformer",), 1)
                m.wn_block(f"{base}.enc", sd, path + ("enc",), 4,
                           has_cond=mc.gin_channels > 0)
                m.conv1d(f"{base}.post", sd, path + ("post",))
            elif ftype == "fft":
                m.conv1d(f"{base}.pre", sd, path + ("pre",))
                m.fft(f"{base}.enc", sd, path + ("enc",), 1)
                m.conv1d(f"{base}.post", sd, path + ("post",))

    # ---- duration predictor -----------------------------------------
    if not has("dp.pre.weight" if mc.use_sdp else "dp.conv_1.weight"):
        pass
    elif mc.use_sdp:
        m.elementwise_affine("dp.flows.0", sd, ("dp", "flow_ea"))
        for i in range(4):
            m.conv_flow(f"dp.flows.{1 + 2 * i}", sd,
                        ("dp", f"flow_conv_{i}"))
        m.elementwise_affine("dp.post_flows.0", sd, ("dp", "post_flow_ea"))
        for i in range(4):
            m.conv_flow(f"dp.post_flows.{1 + 2 * i}", sd,
                        ("dp", f"post_flow_conv_{i}"))
        for nm in ("post_pre", "post_proj", "pre", "proj"):
            m.conv1d(f"dp.{nm}", sd, ("dp", nm))
        m.dds_conv("dp.post_convs", sd, ("dp", "post_convs"))
        m.dds_conv("dp.convs", sd, ("dp", "convs"))
        if mc.gin_channels > 0 and "dp.cond.weight" in sd:
            m.conv1d("dp.cond", sd, ("dp", "cond"))
    else:
        m.conv1d("dp.conv_1", sd, ("dp", "conv_1"))
        m.layer_norm("dp.norm_1", sd, ("dp", "norm_1"))
        m.conv1d("dp.conv_2", sd, ("dp", "conv_2"))
        m.layer_norm("dp.norm_2", sd, ("dp", "norm_2"))
        m.conv1d("dp.proj", sd, ("dp", "proj"))
        if mc.gin_channels > 0 and "dp.cond.weight" in sd:
            m.conv1d("dp.cond", sd, ("dp", "cond"))

    # ---- decoder -----------------------------------------------------
    if not has("dec.in_conv.weight" if mc.vocoder_type == "vocos"
               else "dec.conv_pre.weight"):
        pass
    elif mc.vocoder_type == "vocos":
        m.conv1d("dec.in_conv", sd, ("dec", "in_conv"))
        if "dec.cond.weight" in sd:
            m.conv1d("dec.cond", sd, ("dec", "cond"))
        m.layer_norm("dec.norm_pre", sd, ("dec", "norm_pre"))
        m.layer_norm("dec.norm_post", sd, ("dec", "norm_post"))
        for i in range(mc.vocos_num_layers):
            base = f"dec.layers.{i}"
            path = ("dec", f"layer_{i}")
            m.conv1d(f"{base}.dw_conv", sd, path + ("dw_conv",))
            m.layer_norm(f"{base}.norm", sd, path + ("norm",))
            m.conv1d(f"{base}.pw_conv1", sd, path + ("pw_conv1",))
            m.conv1d(f"{base}.pw_conv2", sd, path + ("pw_conv2",))
            _set(m.params, path + ("scale",), _g(sd.pop(f"{base}.scale")))
        m.conv1d("dec.out_conv", sd, ("dec", "out_conv"))
    else:
        m.conv1d("dec.conv_pre", sd, ("dec", "conv_pre"))
        if "dec.cond.weight" in sd:
            m.conv1d("dec.cond", sd, ("dec", "cond"))
        n_up = len(mc.upsample_rates)
        n_k = len(mc.resblock_kernel_sizes)
        for i in range(n_up):
            m.conv_transpose(f"dec.ups.{i}", sd, ("dec", f"up_{i}"), wn=True)
            for j in range(n_k):
                base = f"dec.resblocks.{i * n_k + j}"
                path = ("dec", f"resblock_{i}_{j}")
                if mc.resblock == "1":
                    n_c = len(mc.resblock_dilation_sizes[j])
                    for k in range(n_c):
                        m.conv1d(f"{base}.convs1.{k}", sd,
                                 path + (f"conv1_{k}",), wn=True)
                        m.conv1d(f"{base}.convs2.{k}", sd,
                                 path + (f"conv2_{k}",), wn=True)
                else:
                    for k in range(len(mc.resblock_dilation_sizes[j])):
                        m.conv1d(f"{base}.convs.{k}", sd,
                                 path + (f"conv_{k}",), wn=True)
        m.conv1d("dec.conv_post", sd, ("dec", "conv_post"))

    # ---- speaker embedding ------------------------------------------
    if "emb_g.weight" in sd:
        _set(m.params, ("emb_g", "embedding"), sd.pop("emb_g.weight"))

    leftovers = [k for k in sd if not k.endswith("num_batches_tracked")]
    if subset:
        # exported graphs carry constant-folded extras ("onnx::Gather_12",
        # shape constants); a partial import never errors on leftovers
        leftovers = []
    if leftovers:
        raise ValueError(f"unmapped reference tensors: {leftovers[:10]}"
                         f" (+{max(0, len(leftovers) - 10)} more)")
    return m.params

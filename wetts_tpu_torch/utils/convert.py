"""The weight bridge: flax param trees -> the port's state_dicts.

`params_from_jax(tree, cfg)` is the inverse of
`wetts_tpu.utils.convert.convert_synthesizer`,
`discriminator_from_jax(tree, use_mrd)` of `convert_discriminator` (the
multi-period discriminator, or with `use_mrd` the multi-period
multi-resolution one), `duration_discriminator_from_jax(tree, dtype)` of
`convert_duration_discriminator`, and `frontend_params_from_jax(params,
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

Every leaf of the tree must map; an unmapped leaf raises. The other
direction needs no code here: the port keeps the reference's state_dict
names, so the JAX package's own converters read the port's state_dicts.
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

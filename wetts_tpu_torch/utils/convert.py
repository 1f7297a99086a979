"""The weight bridge: flax param trees -> the port's state_dicts.

`params_from_jax(tree, cfg)` is the inverse of
`wetts_tpu.utils.convert.convert_synthesizer`, and
`discriminator_from_jax(tree)` of `convert_discriminator` (the multi-period
discriminator). `params_from_jax` takes a flax param tree of
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

    def layer_norm(self, path: Path, prefix: str) -> None:
        self.put(_join(prefix, "gamma"), path + ("ln", "scale"))
        self.put(_join(prefix, "beta"), path + ("ln", "bias"))

    def mha(self, path: Path, prefix: str) -> None:
        for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
            self.conv(path + (nm,), _join(prefix, nm))
        for nm in ("emb_rel_k", "emb_rel_v"):
            if nm in self.node(path):
                self.put(_join(prefix, nm), path + (nm,))

    def encoder(self, path: Path, prefix: str, n_layers: int) -> None:
        for i in range(n_layers):
            self.mha(path + (f"attn_{i}",), _join(prefix, f"attn_layers.{i}"))
            self.layer_norm(path + (f"norm1_{i}",),
                            _join(prefix, f"norm_layers_1.{i}"))
            for nm in ("conv_1", "conv_2"):
                self.conv(path + (f"ffn_{i}", nm),
                          _join(prefix, f"ffn_layers.{i}.{nm}"))
            self.layer_norm(path + (f"norm2_{i}",),
                            _join(prefix, f"norm_layers_2.{i}"))

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

    def coupling(self, path: Path, prefix: str, n_layers: int) -> None:
        self.conv(path + ("pre",), _join(prefix, "pre"))
        self.wn(path + ("enc",), _join(prefix, "enc"), n_layers)
        self.conv(path + ("post",), _join(prefix, "post"))

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
    """Flax Synthesizer params (VITS1, HiFi-GAN) -> the port's state_dict.

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
    for i in range(4):
        m.coupling(("flow", f"flow_{i}"), f"flow.flows.{2 * i}", 4)
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
    m.generator(("dec",), "dec", cfg)
    if "emb_g" in tree:
        m.put("emb_g.weight", ("emb_g", "embedding"))
    m.check_all_used()
    return m.state


def discriminator_from_jax(tree: Dict, periods=(2, 3, 5, 7, 11)
                           ) -> Dict[str, torch.Tensor]:
    """Flax MultiPeriodDiscriminator params -> the port's state_dict
    (`discriminators.0` the scale discriminator, then one per period)."""
    tree = tree.get("params", tree)
    m = FlaxToTorch(tree)
    for i in range(6):
        m.conv(("disc_s", f"conv_{i}"), f"discriminators.0.convs.{i}")
    m.conv(("disc_s", "conv_post"), "discriminators.0.conv_post")
    for idx, p in enumerate(periods, start=1):
        for i in range(5):
            m.conv((f"disc_p_{p}", f"conv_{i}"),
                   f"discriminators.{idx}.convs.{i}")
        m.conv((f"disc_p_{p}", "conv_post"),
               f"discriminators.{idx}.conv_post")
    m.check_all_used()
    return m.state

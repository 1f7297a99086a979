"""Graph export through torch.export (`bin/export_graphs.py`) against the
JAX package's StableHLO export (`wetts_tpu/bin/export_stablehlo.py`) and
against the live port model, on the CPU.

- `export_graphs` through its CLI (`--device cpu`, weights from a
  `params.npz`) for a HiFi-GAN and a Vocos tiny config, the `.pt2` files
  loaded back, against the JAX graphs deserialized, at scales (0, 1, 0),
  where the noise has no effect: z within 1e-4, y_length equal, audio
  within 2e-4 on the same z;
- the same graphs against the live port model at a seed: the encoder fed
  `encoder_noise(cfg, seed, T)` against `encode_infer` with
  `torch.Generator().manual_seed(seed)`, the decoder against `decode`;
- the HiFi-GAN decoder graph holds K1 as nodes of the registered operator
  (one node per stage), whose CPU implementation equals `mrf_stage`.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    jax_synthesizer,
    port_synthesizer,
    small_cfg_dict,
)
from wetts_tpu.bin.export_stablehlo import export_graphs as jax_export_graphs
from wetts_tpu.config import Config as JaxConfig
from wetts_tpu_torch.bin import export_graphs as port_export
from wetts_tpu_torch.config import Config
from wetts_tpu_torch.models import mrf
from wetts_tpu_torch.utils.params_io import save_params_npz

T, F = 8, 48
VOCOS = {"vocoder_type": "vocos", "vocos_channels": 32,
         "vocos_h_channels": 48, "vocos_out_channels": 66,
         "vocos_num_layers": 2,
         "vocos_istft_config": {"n_fft": 64, "hop_length": 16,
                                "win_length": 64, "center": True}}
CONFIGS = {
    "hifigan": small_cfg_dict(n_layers=1),
    "vocos": small_cfg_dict(n_layers=1, **VOCOS),
}


def inputs():
    x = np.arange(1, T + 1, dtype=np.int64)[None] % 20 + 1
    return x, np.array([T - 2]), np.array([1])


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def exported(request, tmp_path_factory):
    """(config dict, JAX model and params, the port's graphs from the CLI
    loaded back, the manifest)."""
    cfg_dict = CONFIGS[request.param]
    jmodel, jparams = jax_synthesizer(cfg_dict)
    d = tmp_path_factory.mktemp(f"export_{request.param}")
    (d / "config.json").write_text(json.dumps(cfg_dict))
    (d / "phones.txt").write_text("\n".join(
        f"p{i} {i}" for i in range(cfg_dict["num_phones"])))
    model_dir = d / "model"
    model_dir.mkdir()
    save_params_npz(str(model_dir / "params.npz"), jparams["params"])
    port_export.main([
        "--cfg", str(d / "config.json"), "--model_dir", str(model_dir),
        "--phone_table", str(d / "phones.txt"), "--out_dir", str(d / "out"),
        "--text_buckets", str(T), "--frame_buckets", str(F),
        "--noise_scale", "0", "--noise_scale_w", "0", "--device", "cpu"])
    with open(d / "out" / "manifest.json") as f:
        manifest = json.load(f)
    graphs = {name: torch.export.load(str(d / "out" / f"{name}.pt2"))
              for name in manifest["graphs"]}
    return cfg_dict, (jmodel, jparams), graphs, manifest


def test_manifest(exported):
    cfg_dict, _, graphs, manifest = exported
    assert set(graphs) == {f"encoder_t{T}", f"decoder_f{F}"}
    assert manifest["text_buckets"] == [T] and manifest["frame_buckets"] == [F]
    assert manifest["scales"] == [0.0, 1.0, 0.0]
    assert "torch.export" in manifest["format"]
    for name, doc in manifest["graphs"].items():
        assert doc["bytes"] > 0 and doc["in"] and doc["out"]
    n_noise = 2 if cfg_dict["model"].get("use_sdp", True) else 1
    assert len(manifest["graphs"][f"encoder_t{T}"]["in"]) == 3 + n_noise


def test_graphs_equal_the_jax_export_without_noise(exported):
    cfg_dict, (_, jparams), graphs, _ = exported
    jgraphs = jax_export_graphs(JaxConfig.from_dict(cfg_dict),
                                jax.tree.map(jnp.asarray, jparams),
                                text_buckets=[T], frame_buckets=[F],
                                scales=(0.0, 1.0, 0.0))
    jenc = jax.export.deserialize(jgraphs[f"encoder_t{T}"][0])
    jdec = jax.export.deserialize(jgraphs[f"decoder_f{F}"][0])
    x, xl, sid = inputs()
    jz, jy = jenc.call(jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32),
                       jnp.asarray(sid, jnp.int32), jnp.int32(3))

    cfg = Config.from_dict(cfg_dict)
    noise = port_export.encoder_noise(cfg, 3, T)
    with torch.no_grad():
        z, y = graphs[f"encoder_t{T}"].module()(
            torch.from_numpy(x), torch.from_numpy(xl), torch.from_numpy(sid),
            *noise)
        assert z.shape == (1, 12 * T, cfg.model.inter_channels)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        audio = graphs[f"decoder_f{F}"].module()(z[:, :F],
                                                 torch.from_numpy(sid))
    jaudio = jdec.call(jnp.asarray(z[:, :F].numpy()),
                       jnp.asarray(sid, jnp.int32))
    assert audio.shape == jaudio.shape == (1, F * 16, 1)
    np.testing.assert_allclose(audio.numpy(), np.asarray(jaudio), atol=2e-4)


@pytest.mark.parametrize("seed", [0, 11])
def test_graphs_equal_the_live_model_at_a_seed(exported, seed):
    cfg_dict, (_, jparams), _, _ = exported
    model = port_synthesizer(cfg_dict, jparams)
    cfg = Config.from_dict(cfg_dict)
    graphs = port_export.export_graphs(cfg, model, [T], [F])
    x, xl, sid = (torch.from_numpy(a) for a in inputs())
    noise = port_export.encoder_noise(cfg, seed, T)
    with torch.no_grad():
        z, y = graphs[f"encoder_t{T}"][0].module()(x, xl, sid, *noise)
        want, y_want, *_ = model.encode_infer(
            x, xl, sid, 0.667, 1.0, 0.8, max_frames=12 * T,
            generator=torch.Generator().manual_seed(seed))
        assert torch.equal(y, y_want)
        torch.testing.assert_close(z, want, rtol=0, atol=1e-5)
        audio = graphs[f"decoder_f{F}"][0].module()(z[:, :F], sid)
        torch.testing.assert_close(audio, model.decode(z[:, :F], sid=sid),
                                   rtol=0, atol=1e-5)


def test_decoder_graph_holds_k1_as_an_operator(exported):
    cfg_dict, _, graphs, _ = exported
    ops = [n for n in graphs[f"decoder_f{F}"].graph.nodes
           if n.op == "call_function"
           and n.target is torch.ops.wetts_tpu_torch.mrf_stage.default]
    want = 0 if cfg_dict["model"].get("vocoder_type") == "vocos" else 2
    assert len(ops) == want  # one per upsample stage


def test_the_operator_on_the_cpu_equals_mrf_stage():
    rng = np.random.default_rng(0)
    c, kernel_sizes, dilations = 16, (3, 5), ((1, 3), (1, 2))
    for kind in ("1", "2"):
        stage = [[(torch.from_numpy(rng.standard_normal(
                    (c, c, k)).astype(np.float32) * 0.1),
                   torch.from_numpy(rng.standard_normal(c).astype(
                       np.float32) * 0.1))
                  for _ in range(mrf.convs_per_branch(kind, d))]
                 for k, d in zip(kernel_sizes, dilations)]
        h = torch.from_numpy(rng.standard_normal((2, 40, c)).astype(
            np.float32))
        want = mrf.mrf_stage(h, stage, kind, kernel_sizes, dilations)
        got = mrf.mrf_stage_as_op(h, stage, kind, kernel_sizes, dilations)
        assert torch.equal(got, want)
        direct = torch.ops.wetts_tpu_torch.mrf_stage(
            h, [w for b in stage for w, _ in b],
            [bb for b in stage for _, bb in b], [], kind, list(kernel_sizes),
            [d for ds in dilations for d in ds], [2, 2])
        assert torch.equal(direct, want)

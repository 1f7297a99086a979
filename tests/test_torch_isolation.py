"""The port stands alone: `wetts_tpu_torch` and `chip_smoke` import neither
jax nor anything of `wetts_tpu`, and the entry points refuse to run without
a GPU unless asked for the CPU. No module imports `transformers`,
`tensorboard`, `tensorboardX`, `safetensors` or `matplotlib` when it is
imported: the card's machine has none of them, and the port reaches them
only inside the functions that use them, with their fallbacks.

Checked in a fresh interpreter with `sys.modules[name] = None` for each of
those packages (so any import of one fails) and a meta-path finder that
refuses `wetts_tpu` and `wetts_tpu.*` by exact name (`wetts_tpu_torch`
shares the prefix).
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib
    import importlib.abc
    import pkgutil
    import sys

    sys.modules["jax"] = None
    sys.modules["flax"] = None
    # absent where the port runs on the card: imported only inside functions
    for absent in ("transformers", "tensorboard", "tensorboardX",
                   "safetensors", "matplotlib"):
        sys.modules[absent] = None

    def refused(name):
        return name == "wetts_tpu" or name.startswith("wetts_tpu.")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if refused(name):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, Refuse())

    import wetts_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        wetts_tpu_torch.__path__, "wetts_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401  (main() is not run)
    expected = [
        "ops.mas", "ops.spectral", "ops.random", "ops.masking",
        "models.discriminators", "models.encoders", "models.duration",
        "train.losses", "train.state", "train.step", "train.checkpoint",
        "train.trainer", "data.dataset", "data.sampler", "utils.wav",
        "bin.train_vits", "bin.infer_vits", "models.quant",
        "ops.int8_chain", "tools.probe_int8", "serving.streaming",
        "serving.batcher", "bin.stream_client", "assets", "text.tn",
        "text.sandhi", "text.lexicon", "text.g2p_en", "text.pinyin",
        "text.frontend", "cli.frontend", "models.bert_frontend",
        "frontend.scorer", "models.vocos", "bin.voice_convert",
        "cli.model", "cli.tts", "cli.hub", "bin.export_bundle",
        "bin.eval_mcd", "serving.embed", "text.native",
        "utils.onnx_import", "ops.resample", "models.wavlm",
        "utils.summary", "parallel", "parallel.mesh", "bin.export_graphs",
        "frontend.dataset", "frontend.eval", "frontend.train",
        "bin.train_frontend", "bin.eval_frontend", "bin.export_frontend",
        "utils.native_build"]
    missing = [m for m in expected
               if "wetts_tpu_torch." + m not in sys.modules]
    assert not missing, missing

    leaked = [m for m in sys.modules if refused(m)
              or (m.split(".")[0] in ("jax", "jaxlib", "flax", "transformers",
                                      "tensorboard", "tensorboardX",
                                      "safetensors", "matplotlib")
                  and sys.modules[m] is not None)]
    assert not leaked, leaked

    import torch
    from wetts_tpu_torch.config import Config
    from wetts_tpu_torch.models.synthesizer import Synthesizer
    from wetts_tpu_torch.serving.engine import SynthesisEngine

    cfg = Config.from_dict({"model": {
        "inter_channels": 8, "hidden_channels": 8, "filter_channels": 16,
        "n_layers": 1, "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1]], "upsample_rates": [2],
        "upsample_kernel_sizes": [4], "upsample_initial_channel": 8,
        "gin_channels": 0}, "num_phones": 4})
    SynthesisEngine(cfg, Synthesizer(cfg), {"sil": 0}, device="cpu")
    if not torch.cuda.is_available():
        try:
            SynthesisEngine(cfg, Synthesizer(cfg), {"sil": 0})
        except RuntimeError:
            pass
        else:
            raise AssertionError("engine without a GPU did not raise")
        for option in ("half", "quantize"):
            try:
                SynthesisEngine(cfg, Synthesizer(cfg), {"sil": 0},
                                **{option: True})
            except RuntimeError:
                pass
            else:
                raise AssertionError(option + " without a GPU did not raise")
        from wetts_tpu_torch.bin import (eval_frontend, export_frontend,
                                         export_graphs, infer_vits,
                                         train_frontend, train_vits,
                                         voice_convert)
        from wetts_tpu_torch.cli import model, tts
        from wetts_tpu_torch.frontend.train import FrontendTrainer
        from wetts_tpu_torch.parallel import init_distributed
        from wetts_tpu_torch.tools import probe_int8
        from wetts_tpu_torch.train.trainer import Trainer
        assert probe_int8.main() == 1  # no GPU: no result
        import os
        phones = os.path.join(sys.argv[1], "phones.txt")
        with open(phones, "w") as f:
            f.write("sil 0" + chr(10) + "a 1")
        for run in (lambda: Trainer(cfg, "unused", "unused", "unused"),
                    lambda: infer_vits.main(
                        ["--cfg", "examples/baker/configs/v1.json",
                         "--model_dir", sys.argv[1], "--phone_table", phones,
                         "--test_file", phones, "--outdir", sys.argv[1],
                         "--precision", "int8"]),
                    lambda: train_vits.main(
                        ["-c", "examples/baker/configs/v1.json", "-m",
                         sys.argv[1], "--train_data", "unused",
                         "--phone_table", "unused"]),
                    lambda: voice_convert.main(
                        ["--cfg", "examples/baker/configs/vits2_v1.json",
                         "--model_dir", sys.argv[1], "--phone_table", phones,
                         "--speaker_table", phones, "--wav", "unused",
                         "--source_speaker", "a", "--target_speaker", "a",
                         "--out", "unused"]),
                    lambda: model.Model(sys.argv[1]),
                    lambda: export_graphs.main(
                        ["--cfg", "examples/baker/configs/v1.json",
                         "--model_dir", sys.argv[1], "--phone_table", phones,
                         "--out_dir", sys.argv[1]]),
                    lambda: train_frontend.main(
                        ["--model_dir", sys.argv[1], "--vocab", "unused"]),
                    lambda: eval_frontend.main(
                        ["--model_dir", sys.argv[1], "--vocab", "unused"]),
                    lambda: export_frontend.main(
                        ["--model_dir", sys.argv[1], "--vocab", "unused",
                         "--out_dir", sys.argv[1]]),
                    lambda: FrontendTrainer(None, None, None, sys.argv[1]),
                    lambda: init_distributed("localhost:1", 1, 0),
                    lambda: tts.main(
                        ["--model-dir", sys.argv[1], "--text", "a",
                         "--wav", "unused"])):
            try:
                run()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("trainer without a GPU did not raise")
    print("OK", len(names))
""")


def test_port_imports_no_jax_and_needs_a_gpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 65  # every module of the package was imported


def test_the_ports_embedding_source_imports_only_the_port():
    """The embedding source the native binaries build from
    (`utils/native_build.py:embed_engine_source`, `native/src/
    embed_engine.cc` with the port's module): every `wetts_tpu` module it
    names is `wetts_tpu_torch.*`, the serving module among them."""
    import re

    from wetts_tpu_torch.utils.native_build import embed_engine_source

    names = re.findall(r"wetts_tpu[A-Za-z_.]*", embed_engine_source())
    assert names and all(n.startswith("wetts_tpu_torch.") for n in names)
    assert "wetts_tpu_torch.serving.embed" in names

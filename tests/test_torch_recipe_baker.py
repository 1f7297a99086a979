"""The baker recipe's stages 0-4 through the port's entry points, on the
synthetic DataBaker-shaped corpus of tests/test_recipe_baker.py.

Stage 0 (lexicon, label parsing with an erhua merge, the tables and the
splits) is examples/baker/run.sh itself, stopped after it; stages 1-4 are
the commands run.sh gives them with the JAX package's modules swapped for
the port's (`examples/` is not edited): a 2-step `bin/train_vits`,
`bin/infer_vits` over the test split, `bin/export_bundle` of the training
dir, and `bin/eval_mcd` over the synthesized test split. Each stage runs as
a subprocess on the CPU (`--device cpu`), the export on no device at all.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_recipe_baker import _make_corpus, _tiny_config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BAKER = os.path.join(_REPO, "examples", "baker")


def _run(args, **kw):
    proc = subprocess.run(args, capture_output=True, text=True, timeout=1800,
                          env=dict(os.environ, PYTHONPATH=_REPO), **kw)
    tail = proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.returncode == 0, f"{args[:3]} failed:\n{tail}"
    return proc.stdout


def _port(module, *args):
    return _run([sys.executable, "-m", f"wetts_tpu_torch.{module}", *args],
                cwd=_REPO)


@pytest.mark.slow
def test_baker_recipe_stages_0_to_4_on_the_port(tmp_path):
    _make_corpus(tmp_path)
    cfg = str(tmp_path / "tiny.json")
    _tiny_config(cfg)
    data, exp = tmp_path / "data", tmp_path / "exp"
    test_audio = tmp_path / "test_audio"
    tables = ["--phone_table", str(data / "phones.txt"),
              "--speaker_table", str(data / "speaker.txt")]

    # stage 0: the recipe's own data preparation
    _run(["bash", "run.sh", "--stage", "0", "--stop_stage", "0",
          "--raw_data_dir", str(tmp_path), "--data", str(data),
          "--val_size", "8", "--test_size", "3"], cwd=_BAKER)
    assert len(open(data / "test.txt").read().splitlines()) == 3

    # stage 1: 2 training steps and a checkpoint
    _port("bin.train_vits", "-c", cfg, "-m", str(exp),
          "--train_data", str(data / "train.txt"),
          "--val_data", str(data / "val.txt"), *tables,
          "--max_steps", "2", "--device", "cpu")
    metrics = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert metrics and np.isfinite(metrics[-1]["loss/g_total"])
    assert "ckpt_2.pt" in os.listdir(exp)

    # stage 2: the test split synthesized from the training dir
    out = _port("bin.infer_vits", "--cfg", cfg, *tables,
                "--model_dir", str(exp),
                "--test_file", str(data / "test.txt"),
                "--outdir", str(test_audio), "--device", "cpu")
    assert "TOTAL:" in out
    wavs = [f for f in os.listdir(test_audio) if f.endswith(".wav")]
    assert len(wavs) == 3
    assert all(os.path.getsize(test_audio / w) > 1000 for w in wavs)

    # stage 3: the bundle, which the port's Model and the JAX one read
    _port("bin.export_bundle", "--cfg", cfg, *tables,
          "--model_dir", str(exp), "--out_dir", str(exp / "bundle"))
    from wetts_tpu.cli.model import Model as JaxModel
    from wetts_tpu_torch.cli.model import Model

    text = "sil j in1 t ian1 #4"
    audio = Model(str(exp / "bundle"), device="cpu").synthesis(text, "baker")
    assert audio.dtype == np.int16 and audio.size > 0
    assert JaxModel(str(exp / "bundle"), on_device_bucketing=False
                    ).synthesis(text, "baker").size > 0

    # stage 4: the MCD gate over the test split (a 2-step model scores
    # badly, but the number must exist and be finite)
    out = _port("bin.eval_mcd", "--test_file", str(data / "test.txt"),
                "--gen_dir", str(test_audio))
    mcd = json.loads(out.strip().splitlines()[-1])
    assert mcd["metric"] == "mel_cepstral_distortion_db"
    assert mcd["n_pairs"] == 3
    assert np.isfinite(mcd["mean"])

"""Pretrained model hub (the port's own copy of `wetts_tpu/cli/hub.py`).

Behavioral parity target: wetts/cli/hub.py:26-98 — download + untar
pretrained bundles into ~/.wetts_tpu. The reference pulls
`baker_bert_onnx` / `multilingual_vits_v3_onnx` from modelscope mirrors;
this framework consumes the SAME released checkpoints after conversion
(utils/convert.py:convert_synthesizer), so the hub downloads those archives and converts them
on first use. Offline environments can point WETTS_TPU_HOME at a directory
that already contains the bundles.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
from typing import Dict

HOME = os.environ.get(
    "WETTS_TPU_HOME", os.path.join(os.path.expanduser("~"), ".wetts_tpu"))

# The reference's released artifacts (README.md:63-66, wetts/cli/hub.py:74-77).
# "vits" points at the CHECKPOINT release (multilingual_vits_v3_exp.tar.gz,
# G_*.pth) — the artifact the converter reads natively; the runtime
# (final.onnx) releases remain consumable through utils/onnx_import as a
# fallback. Each entry is (url, archive filename) because the wenet.org.cn
# download URLs carry the filename in a query parameter.
MODEL_URLS: Dict[str, tuple] = {
    "frontend": (("https://wenet.org.cn/downloads?models=wetts"
                  "&version=baker_bert_onnx.tar.gz"),
                 "baker_bert_onnx.tar.gz"),
    "vits": (("https://wenet.org.cn/downloads?models=wetts"
              "&version=multilingual_vits_v3_exp.tar.gz"),
             "multilingual_vits_v3_exp.tar.gz"),
}


def download(url: str, dest_dir: str, name: str = "") -> str:
    os.makedirs(dest_dir, exist_ok=True)
    name = name or url.split("?")[0].split("/")[-1]
    path = os.path.join(dest_dir, name)
    if not os.path.exists(path):
        try:
            urllib.request.urlretrieve(url, path)  # noqa: S310
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"download failed ({e}); place {name} under {dest_dir} "
                f"manually or set WETTS_TPU_HOME to a prepared directory"
            ) from e
    return path


def extract(archive: str, dest_dir: str) -> None:
    with tarfile.open(archive) as tar:
        tar.extractall(dest_dir, filter="data")


def get_model(name: str) -> str:
    """Returns the local directory of a named pretrained bundle."""
    if name not in MODEL_URLS:
        raise KeyError(f"unknown model {name!r}; known: {list(MODEL_URLS)}")
    home = os.environ.get("WETTS_TPU_HOME", HOME)
    target = os.path.join(home, name)
    if os.path.isdir(target) and os.listdir(target):
        return _bundle_root(target)
    url, fname = MODEL_URLS[name]
    archive = download(url, home, fname)
    extract(archive, target)
    return _bundle_root(target)


def _bundle_root(target: str) -> str:
    """Resolve a single top-level directory inside an extracted archive
    (released tarballs wrap their payload in one directory, e.g.
    multilingual_vits_v3_onnx/ — wetts/cli/hub.py:92-97 joins it by name)."""
    entries = os.listdir(target)
    if (len(entries) == 1
            and os.path.isdir(os.path.join(target, entries[0]))):
        return os.path.join(target, entries[0])
    return target


def get_default_model_dir() -> str:
    """Assemble the zero-config CLI bundle from the hub (the reference's
    `wetts --text ...` path, wetts/cli/model.py:64-68: frontend bundle +
    multilingual VITS bundle). The frontend bundle is optional — if its
    fetch fails the model runs in raw-phone input mode."""
    vits_dir = get_model("vits")
    if not os.path.isdir(os.path.join(vits_dir, "frontend")):
        try:
            fe_dir = get_model("frontend")
        except (RuntimeError, OSError):
            fe_dir = None
        if fe_dir is not None:
            link = os.path.join(vits_dir, "frontend")
            if not os.path.exists(link):
                os.symlink(fe_dir, link)
    return vits_dir

"""Build the port's CUDA kernels from `wetts_tpu_torch/csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into `wetts_tpu_torch/_build/lib<name>-<hash>.so`,
which `ctypes` loads; the hash covers the source, the headers of `csrc/` it
includes (`#include "x.cuh"`, and theirs) and the flags, so an edited
source or header builds anew. A build is written to a temporary file and
renamed, so a killed or concurrent build never leaves a half-written
library behind.
Nothing is built when a module is imported, and nothing outside the package
directory is written.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` and every header of `csrc/` it includes, directly or
    through another header, in the order first reached."""
    found, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for header in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append(CSRC_DIR / header.decode())
    return found


def library_path(name: str) -> Path:
    """Where the shared library of `csrc/<name>.cu` is (to be) built."""
    digest = hashlib.sha256(
        b"".join(path.read_bytes() for path in sources(name))
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compiler_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is already built; its path."""
    target = library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build of {name} failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    target.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build(name)))

"""Build the native serving binaries and the text library for the port.

The repo's C++ runtime (`native/`: flag parsing, WAV I/O, the HTTP server,
the text frontend's C API) embeds CPython and drives a model through a
Python module. `native/src/embed_engine.cc` imports the JAX package's
`wetts_tpu.serving.embed`; `build` compiles it as
`embed_engine_source()` gives it, the same source importing
`wetts_tpu_torch.serving.embed`, written into the build directory first.
`build(name)` compiles, with `g++` against this interpreter's headers and
libpython (`sysconfig`), into `wetts_tpu_torch/_build/native/`:

- `tts_main` and `http_server_main`: `native/src/{tts_main,
  http_server_main, wav, embed_engine}.cc`, the last with the port's module;
- `libwetts_text.so`: `native/src/{text_frontend, wav, c_api}.cc`
  (`text/native.py` loads it).

A target is rebuilt when its sources, `native/include/` or the flags
change (a digest kept beside it), and is written under a temporary name and
renamed. Nothing is built when a module is imported.

The embedded interpreter finds the standard library beside libpython but
not this interpreter's site-packages (a virtual environment's, say):
`run_env()` gives the environment to run the binaries in, with this
interpreter's path and the repo on PYTHONPATH. They run the model on the
card unless WETTS_DEVICE=cpu (`serving/embed.py`).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = PACKAGE_DIR.parent
NATIVE_DIR = REPO_DIR / "native"
BUILD_DIR = PACKAGE_DIR / "_build" / "native"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC")

_SRC = NATIVE_DIR / "src"
_EMBED = _SRC / "embed_engine.cc"
# the embedded module: the JAX package's in native/src, the port's here
_MODULE = "wetts_tpu.serving.embed"
_PORT_MODULE = "wetts_tpu_torch.serving.embed"
# target -> (sources, whether it embeds CPython)
TARGETS = {
    "tts_main": ([_SRC / "tts_main.cc", _SRC / "wav.cc", _EMBED], True),
    "http_server_main": ([_SRC / "http_server_main.cc", _SRC / "wav.cc",
                          _EMBED], True),
    "libwetts_text.so": ([_SRC / "text_frontend.cc", _SRC / "wav.cc",
                          _SRC / "c_api.cc"], False),
}


def _python_flags() -> List[str]:
    """Compile and link flags that embed this interpreter's libpython."""
    include = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    version = sysconfig.get_config_var("LDVERSION")
    if not (Path(include) / "Python.h").exists():
        raise RuntimeError(f"Python.h not found under {include}: the native "
                           f"binaries need Python's development headers")
    libs = (sysconfig.get_config_var("LIBS") or "").split()
    return [f"-I{include}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{version}", *libs, "-pthread"]


def embed_engine_source() -> str:
    """`native/src/embed_engine.cc` importing the port's
    `wetts_tpu_torch.serving.embed` in place of the JAX package's module."""
    text = _EMBED.read_text()
    if f'"{_MODULE}"' not in text:
        raise RuntimeError(f"{_EMBED} no longer imports {_MODULE}")
    return text.replace(_MODULE, _PORT_MODULE)


def _write_embed_engine() -> Path:
    """embed_engine_source() as BUILD_DIR/embed_engine.cc (written under a
    name of its own and renamed: targets build at once)."""
    out = BUILD_DIR / "embed_engine.cc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    tmp.write_text(embed_engine_source())
    os.replace(tmp, out)
    return out


def _command(name: str, out: Path) -> List[str]:
    sources, embeds = TARGETS[name]
    sources = [BUILD_DIR / "embed_engine.cc" if s == _EMBED else s
               for s in sources]
    cmd = ["g++", *CXX_FLAGS, f"-I{NATIVE_DIR / 'include'}",
           *map(str, sources), "-o", str(out)]
    if name.endswith(".so"):
        cmd.insert(1, "-shared")
    if embeds:
        cmd += _python_flags()
    return cmd


def _digest(name: str) -> str:
    paths = list(TARGETS[name][0]) + sorted(
        (NATIVE_DIR / "include").rglob("*.h"))
    h = hashlib.sha256(" ".join(_command(name, Path(name))).encode())
    h.update(_PORT_MODULE.encode())
    for p in paths:
        h.update(p.read_bytes())
    return h.hexdigest()


def build(name: str) -> Path:
    """Compile `name` (a key of TARGETS) into BUILD_DIR unless it is built
    from the current sources; its path."""
    target = BUILD_DIR / name
    stamp = target.with_name(target.name + ".sha256")
    digest = _digest(name)
    if target.exists() and stamp.exists() and stamp.read_text() == digest:
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if _EMBED in TARGETS[name][0]:
        _write_embed_engine()
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run(_command(name, tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build of {name} failed: g++ exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, target)
    stamp.write_text(digest)
    return target


def run_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """os.environ with this interpreter's module path and the repo on
    PYTHONPATH, for running `tts_main` and `http_server_main`."""
    entries = [str(REPO_DIR)] + [p for p in sys.path if p and os.path.isdir(p)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(entries))
    env.update(extra or {})
    return env

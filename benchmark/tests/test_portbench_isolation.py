"""Nothing under benchmark/ imports JAX or the JAX package, and the reference
imports nothing of the program.

The modules are imported in a fresh interpreter whose meta-path finder
refuses the forbidden top-level names, compared whole: `wetts_tpu_torch`
begins with `wetts_tpu` and is allowed outside the reference.
"""

import os
import subprocess
import sys

from benchmark import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "wetts_tpu")

PROBE = r"""
import importlib.abc, importlib.util, sys
sys.path.insert(0, {root!r})
refused = {refused!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in refused:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
failed = []
for i, path in enumerate({paths!r}):
    try:
        spec = importlib.util.spec_from_file_location(f"probe_{{i}}", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    except ImportError as e:
        failed.append((path, str(e)))
bad = sorted({{m.split(".")[0] for m in sys.modules}} & set(refused))
print("failed", failed)
print("held", bad)
{extra}
"""


def modules(under: str):
    out = []
    for dirpath, _, files in os.walk(under):
        if ".cache" in dirpath or "__pycache__" in dirpath:
            continue
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def probe(paths, refused, extra: str = "") -> str:
    code = PROBE.format(root=ROOT, refused=tuple(refused), paths=paths,
                        extra=extra)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_benchmark_imports_no_jax():
    paths = modules(BENCH)
    assert len(paths) > 20
    out = probe(paths, FORBIDDEN)
    assert "failed []" in out and "held []" in out, out


def test_reference_imports_nothing_of_the_program():
    paths = modules(os.path.join(BENCH, "reference"))
    assert len(paths) > 8
    out = probe(paths, FORBIDDEN + ("wetts_tpu_torch",))
    assert "failed []" in out and "held []" in out, out


def test_finder_compares_whole_names():
    """The finder lets `wetts_tpu_torch` through and stops `wetts_tpu`."""
    extra = ("import wetts_tpu_torch.config\nprint('port ok')\n"
             "try:\n    import wetts_tpu\nexcept ImportError:\n"
             "    print('jax package refused')\n")
    out = probe([os.path.join(BENCH, "peaks.py")], FORBIDDEN, extra)
    assert "port ok" in out and "jax package refused" in out, out

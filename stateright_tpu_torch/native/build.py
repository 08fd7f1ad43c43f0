"""Build the port's native module (``python -m
stateright_tpu_torch.native.build``).

The port's own copy of ``stateright_tpu/native/build.py``.  The sources
beside this file (``linearize.cpp``, which holds the module's init and
method table, and ``bfs.cpp``, the compiled-CPU BFS baseline) compile
with ``g++`` into one Python extension, ``_stateright_torch_native``,
under the compile cache directory (``parallel/prewarm.compile_cache_dir``:
``stateright_tpu_torch/_build/`` unless ``.compile_cache(DIR)`` or
``STATERIGHT_TPU_COMPILE_CACHE`` moves it; never into the package
directory).  The build's directory name carries a digest of the sources,
the flags and the Python headers' path, so an edited source rebuilds and
an unchanged tree loads at once.  It compiles to a private temporary
path and renames it into place, so concurrent processes (parallel test
workers) never import a half-written object.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

from ..parallel.prewarm import compile_cache_dir

_DIR = Path(__file__).resolve().parent
MODULE = "_stateright_torch_native"
SOURCES = ("linearize.cpp", "bfs.cpp")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _include() -> str:
    return sysconfig.get_path("include")


def module_path() -> Path:
    """``<compile cache>/native-<digest>/_stateright_torch_native
    <EXT_SUFFIX>`` for the current sources, flags and Python headers."""
    h = hashlib.sha256(" ".join(FLAGS + (_include(),)).encode())
    for s in SOURCES:
        h.update(s.encode())
        h.update((_DIR / s).read_bytes())
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return (compile_cache_dir() / f"native-{h.hexdigest()[:16]}"
            / f"{MODULE}{ext}")


def build() -> Path:
    """Compile the sources into :func:`module_path` (skipped when that file
    exists) and return its path; raises ``RuntimeError`` with the
    compiler's output when ``g++`` fails."""
    out = module_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.build-{os.getpid()}")
    cmd = ["g++", *FLAGS, f"-I{_include()}",
           *(str(_DIR / s) for s in SOURCES), "-o", str(tmp)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({done.returncode}): {' '.join(cmd)}\n"
                f"{done.stdout}{done.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    from . import load

    if load() is None:
        sys.exit(1)
    print("import OK")

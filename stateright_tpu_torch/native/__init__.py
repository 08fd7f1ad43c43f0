"""Native (C++) host-side hot paths, with a pure-Python fallback.

The port's own copy of ``stateright_tpu/native/``: the exhaustive
consistency search of the register histories (``linearize.cpp``; the
reference's ``src/semantics/linearizability.rs:178-240``), which
``semantics/linearizability.py`` calls per state, and the compiled-CPU
BFS baseline (``bfs.cpp``, ``baseline.py``).  They are host code and
launch no kernel.  :func:`load` builds the module with ``g++`` at first
use (``build.py``, into the compile cache directory,
``parallel/prewarm.compile_cache_dir``) and imports it, charging the
build or load to the calling thread (a persistent-cache miss when ``g++``
ran, a hit when the module was only loaded);
when the build fails it warns once, as JAX's does, and returns None, and
the callers use the Python search.  ``python -m
stateright_tpu_torch.native.build`` builds it and shows the compiler's
output.
"""

from __future__ import annotations

import importlib.util
import sys
import warnings
from typing import Optional

_module = None
_attempted = False


def load() -> Optional[object]:
    """The native module, built on first call if needed; None if it is
    unavailable (no compiler, no Python headers, a build error)."""
    global _module, _attempted
    if _module is not None or _attempted:
        return _module
    _attempted = True
    try:
        from ..parallel.prewarm import build_site, note_cache
        from .build import MODULE, build, module_path

        with build_site():
            hit = module_path().exists()
            path = build()
            spec = importlib.util.spec_from_file_location(MODULE, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        note_cache(hit)
        sys.modules.setdefault(MODULE, mod)
        _module = mod
    except Exception as e:  # noqa: BLE001 - any failure: the Python search
        # one-time diagnostic: a misconfigured toolchain would otherwise
        # silently degrade consistency checking to the slower Python search
        warnings.warn(
            f"native extension build failed ({type(e).__name__}: {e}); "
            "falling back to the pure-Python consistency search "
            "(run `python -m stateright_tpu_torch.native.build` to see the "
            "full build log)",
            RuntimeWarning,
            stacklevel=2,
        )
        _module = None
    return _module

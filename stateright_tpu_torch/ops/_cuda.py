"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Every source under ``csrc/`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``-gencode arch=compute_90a,code=sm_90a``); the
objects link into one shared library that ``ctypes`` loads.  The headers
beside them (``csrc/*.cuh``) hold the code two kernels share.  No source
includes PyTorch's headers, so a cold build takes seconds, not minutes.

The build runs at first use, never at import (the CPU tests import every
module of the port on hosts without ``nvcc``).  Each source compiles in its
own ``nvcc`` process, all started together, into ``_build/`` beside this
package; the library's file name carries a digest of the sources, the
headers and the flags, so an edited source or header rebuilds and an
unchanged tree loads at once.

Every C entry point enqueues its kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises on a nonzero code, so
a refused launch (too many threads, a bad pointer) surfaces at the call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C signatures: name -> argtypes (every entry point returns cudaError_t)
_SIGNATURES = {
    # rows, valid (nullable), out, n, width, stream
    "srt_row_hash": (_P, _P, _P, _I64, _I32, _P),
    # tfp, sfp, spl, bucket, order, cidx (nullable), cand_overflow,
    # tgt, cfp, cpl, sel, n_new, overflow, scratch, m, stream
    "srt_bucket_plan": (_P,) * 14 + (_I64, _P),
    # tfp, tpl, tgt, cfp, cpl, n_new, m, then the queue half (all null
    # for a table-only commit): qrows, qfp, qebits, qdepth, tail, sel,
    # crows, pebits, pdepth, width, arity; stream
    "srt_insert_commit": (_P,) * 6 + (_I64,) + (_P,) * 9 + (_I32, _I32, _P),
    # rows, valid, pfps, fp, payload, cidx, key, n_valid, cand_overflow,
    # scratch, m, cb, width, arity, stream
    "srt_cand_prep": (_P,) * 10 + (_I64, _I64, _I32, _I32, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME): the port's kernels are "
            "compiled with nvcc at first use"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources() -> list[Path]:
    """The compiled sources (``csrc/*.cu``)."""
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the compiler's output on
    the first failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for c in cmds
    ]
    outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}"
            )


def library_path() -> Path:
    """``_build/libsrt_kernels-<digest>.so`` for the current sources,
    headers and flags.  The shared headers (``csrc/*.cuh``) are not
    compiled alone, but an edit to one changes the digest."""
    digest = _digest(sources() + sorted(CSRC.glob("*.cuh")))
    return BUILD_DIR / f"libsrt_kernels-{digest}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into :func:`library_path` (skipped when that
    file exists) and return its path."""
    srcs = sources()
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
            for s, o in zip(srcs, objs)
        ])
        out = Path(tmp) / lib.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(out),
                   *map(str, objs)]])
        os.replace(out, lib)  # atomic: concurrent builders race safely
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def require(t, name: str, dtype, ndim: int, device, length=None) -> None:
    """Validate a kernel argument before its pointer crosses to C
    (``length``: the leading dimension, when given)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name}: length {t.shape[0]}, expected {length}")

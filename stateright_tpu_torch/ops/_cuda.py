"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Every source under ``csrc/`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``-gencode arch=compute_90a,code=sm_90a``); the
objects link into one shared library that ``ctypes`` loads.  The headers
beside them (``csrc/*.cuh``) hold the code two kernels share.  No source
includes PyTorch's headers, so a cold build takes seconds, not minutes.

The build runs at first use, never at import (the CPU tests import every
module of the port on hosts without ``nvcc``).  Each source compiles in its
own ``nvcc`` process, all started together, into the compile cache
directory (``parallel/prewarm.compile_cache_dir``: ``_build/`` beside this
package unless ``.compile_cache(DIR)`` or ``STATERIGHT_TPU_COMPILE_CACHE``
moves it); the library's file name carries a digest of the sources, the
headers and the flags, so an edited source or header rebuilds and an
unchanged tree loads at once.  The build or load is charged to the thread
that ran it (``prewarm.build_site``), as a persistent-cache miss when
``nvcc`` ran and a hit when the library was only loaded; one process
builds and loads it once, whichever thread asks first.

Every C entry point enqueues its kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises on a nonzero code, so
a refused launch (too many threads, a bad pointer) surfaces at the call.
Each wrapper counts its launches through :func:`count_launch`, under one
lock, so the counts stay exact when several engines launch from threads
(the fleet's slots share one card).  While a thread captures a CUDA graph
(:func:`capture_tally`) its wrappers launch nothing: their counts go to
the capture's tally, which the graph's owner adds once for every replay
of the captured work (``ops/block_loop.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

from ..parallel.prewarm import build_site, compile_cache_dir, note_cache

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C signatures: name -> argtypes (every entry point returns cudaError_t)
# serializes the wrappers' launch counters (a read-modify-write each)
_COUNT_LOCK = threading.Lock()


_TLS = threading.local()


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches``, exactly under threads; inside
    :func:`capture_tally` on this thread, to the capture's tally."""
    tally = getattr(_TLS, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + n
        return
    with _COUNT_LOCK:
        wrapper.launches += n


@contextmanager
def capture_tally():
    """Yield ``{wrapper: launches}``, which the wrappers called on this
    thread fill instead of their counts: a graph capture, which records
    the launches and runs none of them."""
    prev = getattr(_TLS, "tally", None)
    _TLS.tally = tally = {}
    try:
        yield tally
    finally:
        _TLS.tally = prev


_SIGNATURES = {
    # rows, valid (nullable), out, n, width, stream
    "srt_row_hash": (_P, _P, _P, _I64, _I32, _P),
    # tfp, sfp, spl, bucket, order, cidx (nullable), cand_overflow,
    # tgt, cfp, cpl, sel, n_new, overflow, scratch, stage (nullable: table
    # order; else generation order, two launches), m, stream
    "srt_bucket_plan": (_P,) * 15 + (_I64, _P),
    # the fused entry: tfp, fp, payload (unsorted), skey, order, cidx
    # (nullable), cand_overflow, the same outputs, scratch and stage, win
    # (nullable: the whole batch), bits, boff, m, stream
    "srt_bucket_plan_fused": (_P,) * 16 + (_I32, _I64, _I64, _P),
    # tfp, tpl, tgt, cfp, cpl, n_new, m, then the queue half (all null
    # for a table-only commit): qrows, qfp, qebits, qdepth, tail, sel,
    # crows, pebits, pdepth, then the tag column (both null without it):
    # qtag, ptag; width, arity; stream
    "srt_insert_commit": (_P,) * 6 + (_I64,) + (_P,) * 11 + (_I32, _I32, _P),
    # the window mode (a queue piece): cfp, n_new, m, qrows, qfp, qebits,
    # qdepth, tail, sel, crows, pebits, pdepth, qlo, qhi, width, arity,
    # stream
    "srt_insert_commit_window": (_P, _P, _I64) + (_P,) * 9
    + (_I64, _I64, _I32, _I32, _P),
    # rows, valid, pfps, fp, payload, cidx, key, n_valid, cand_overflow,
    # scratch, then the namespace mode (null tables: off): ptags, ns_low,
    # ns_xor, bits; m, cb, width, arity, stream
    "srt_cand_prep": (_P,) * 13 + (_I32, _I64, _I64, _I32, _I32, _P),
    # the block's cond: head, tail, unique, status, disc, n_disc, err
    # (nullable), target (< 0: none), steps, k, reset, go_out, stream
    "srt_block_cond": (_P,) * 5 + (_I32, _P, _I64, _I64, _P, _I32, _P, _P),
    # the block graph around a captured step graph: step, head, tail,
    # unique, status, disc, n_disc, err, target, steps, k, then the
    # graph, its instantiation and the step's node count (written)
    "srt_block_graph_create": (_P,) * 6 + (_I32, _P, _I64, _I64, _P, _P,
                                           _P, _P),
    # exec, stream
    "srt_block_graph_launch": (_P, _P),
    # graph, exec
    "srt_block_graph_destroy": (_P, _P),
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
    """``<compile cache>/libsrt_kernels-<digest>.so`` for the current
    sources, headers and flags.  The shared headers (``csrc/*.cuh``) are
    not compiled alone, but an edit to one changes the digest."""
    digest = _digest(sources() + sorted(CSRC.glob("*.cuh")))
    return compile_cache_dir() / f"libsrt_kernels-{digest}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into :func:`library_path` (skipped when that
    file exists) and return its path."""
    srcs = sources()
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
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


class KernelBuildError(RuntimeError):
    """The kernels could not be built or loaded: no toolkit, a compiler
    error, a library the loader refuses.  A supervised run treats it as
    fatal, since a retry builds the same sources."""


_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call); raises
    :class:`KernelBuildError` when it cannot be built or loaded.  Under
    one lock, so two threads asking first run ``nvcc`` once and the build
    is charged to the one that ran it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        with build_site():
            try:
                hit = library_path().exists()
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                raise KernelBuildError(
                    f"the CUDA kernels could not be built or loaded: "
                    f"{type(e).__name__}: {e}") from e
            note_cache(hit)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
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

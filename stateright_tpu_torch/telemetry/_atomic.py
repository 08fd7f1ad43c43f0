"""Atomic, crash-safe host persistence — the ONE write discipline.

The port's own copy of ``stateright_tpu/telemetry/_atomic.py``.  Every
durable artifact the port writes (run reports, registry archives, the
``index.jsonl`` ledger, autosave snapshot generations, spill-tier disk
segments) goes through these helpers, so the crash contract lives in one
place:

 - **Replace writes** (:func:`atomic_write_bytes` and friends): the
   payload lands in a same-directory temp file, is fsynced, and then
   ``os.replace``s the target — a reader (or a resume after SIGKILL)
   sees either the complete old file or the complete new file, never a
   torn one.  The containing directory is fsynced afterwards so the
   rename itself is durable, not just the data.
 - **Ledger appends** (:func:`durable_append_line`): append-only files
   cannot be replaced wholesale without losing concurrent history, so
   appends write the full line then flush+fsync the fd.  A crash can
   still tear the LAST line — which is why every ledger reader in this
   package (``registry.RunRegistry.index``) skips unparseable tail
   lines instead of failing: prior records are never lost.

Failure injection: every write here first fires the ``atomic_write``
seam of the fault layer (``testing/faults.py``; JAX ``_atomic.py:57``,
:84, :135), once per replace write and once per ledger append, so every
durable write of the port is fault-testable through one hook.
"""

from __future__ import annotations

import io
import json
import os
import tempfile

from ..testing import faults


def _fsync_dir(path: str) -> None:
    """fsync the directory containing ``path`` so a completed
    ``os.replace`` survives power loss; best-effort on filesystems
    without directory fds."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: same-dir temp file, fsync,
    ``os.replace``.  Raises ``OSError`` on failure with the target
    untouched (old contents, if any, stay intact)."""
    atomic_write_stream(path, (data,))


def atomic_write_stream(path: str, chunks) -> None:
    """:func:`atomic_write_bytes` of an iterable of byte chunks, written
    one by one: the large-payload form (spill disk segments), which never
    holds the whole payload in one buffer."""
    faults.fire("atomic_write", path=str(path))
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=d
    )
    try:
        with os.fdopen(fd, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(path)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj, indent: int = 1) -> None:
    """The package's JSON artifact write (reports, registry archives,
    autosave manifests): ``json.dump`` shape preserved (insertion order,
    trailing newline) but landed atomically."""
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")


def atomic_write_npz(path: str, arrays: dict) -> None:
    """Atomic ``np.savez`` — the snapshot-generation write.  The npz is
    assembled in memory first (snapshots are carry-sized, far below host
    RAM by construction) so the on-disk file is all-or-nothing."""
    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(path, buf.getvalue())


def durable_append_line(path: str, line: str) -> None:
    """Append one newline-terminated record to an append-only ledger,
    flushed + fsynced before returning.  Atomicity here is per-LINE
    best-effort (POSIX appends of small writes), and the crash contract
    is completed by the readers: a torn tail line is skipped, prior
    records survive."""
    faults.fire("atomic_write", path=str(path))
    if not line.endswith("\n"):
        line += "\n"
    # heal a torn tail first: a writer killed mid-append can leave the
    # ledger without its final newline — appending straight on would
    # glue THIS record onto the torn fragment and lose both (readers
    # skip unparseable lines; a leading newline isolates the damage)
    needs_nl = False
    try:
        with open(path, "rb") as rf:
            rf.seek(-1, os.SEEK_END)
            needs_nl = rf.read(1) != b"\n"
    except OSError:
        pass  # absent or empty file: nothing to heal
    with open(path, "a") as f:
        if needs_nl:
            f.write("\n")
        f.write(line)
        f.flush()
        os.fsync(f.fileno())

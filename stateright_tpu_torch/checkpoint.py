"""Crash-safe autosave checkpoints: rotating snapshot generations.

The port's own copy of ``stateright_tpu/checkpoint.py:42-312``; its
atomic npz and json writes are ``telemetry/_atomic.py``'s, the port's
one write discipline.  Left out, for the ROADMAP item "fault injection
and the supervisor": the fault-injection seam (``testing/faults.py``),
the stub run report and the progress heartbeat.

The GPU engine's whole run state is a host-serializable snapshot dict
(``GpuChecker.checkpoint()``, ``convert.carry_to_snapshot``, in the JAX
engine's layout); this module gives those snapshots a durable,
self-describing home so that a killed run can resume from its last saved
generation, on either engine.

Directory layout under the autosave root (``CheckerBuilder.autosave`` or
``STATERIGHT_TPU_AUTOSAVE``)::

    <root>/gen-000007/snapshot.npz    # the engine snapshot (np.savez)
    <root>/gen-000007/MANIFEST.json   # written LAST = the commit point

Both files land through the atomic write (a temp file in the same
directory, fsync, ``os.replace``, then an fsync of the directory), and
the manifest is written after the npz: a generation without a parseable
manifest is by definition incomplete (torn mid-write), and
:func:`latest_generation` skips it with a loud warning instead of resuming
from garbage.  Rotation keeps the newest ``keep`` complete generations;
pruning deletes older ones only after a newer complete generation exists,
so there is always at least one resumable state on disk once the first
save lands.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import time
from typing import Optional

import numpy as np

from .telemetry._atomic import atomic_write_json, atomic_write_npz

CKPT_V = 1

ENV_AUTOSAVE = "STATERIGHT_TPU_AUTOSAVE"
ENV_AUTOSAVE_SECS = "STATERIGHT_TPU_AUTOSAVE_SECS"
ENV_AUTOSAVE_KEEP = "STATERIGHT_TPU_AUTOSAVE_KEEP"

DEFAULT_EVERY_SECS = 60.0
DEFAULT_KEEP = 3

_GEN_RE = re.compile(r"^gen-(\d{6,})$")


# -- the generation store -----------------------------------------------------


def resolve_autosave(builder_opts: Optional[dict]) -> Optional[dict]:
    """The effective autosave config: the builder's ``autosave(DIR, ...)``
    wins, else the ``STATERIGHT_TPU_AUTOSAVE`` env knob (cadence and keep
    from their env siblings); None = autosave off."""
    if builder_opts:
        return dict(builder_opts)
    root = os.environ.get(ENV_AUTOSAVE, "").strip()
    if not root:
        return None
    out = {"dir": root, "every_secs": DEFAULT_EVERY_SECS,
           "keep": DEFAULT_KEEP}
    for env, key, cast in ((ENV_AUTOSAVE_SECS, "every_secs", float),
                           (ENV_AUTOSAVE_KEEP, "keep", int)):
        raw = os.environ.get(env, "").strip()
        if not raw:
            continue
        try:
            out[key] = cast(raw)
        except ValueError:
            print(
                f"stateright-tpu-torch: autosave: ignoring malformed "
                f"{env}={raw!r}; using the default",
                file=sys.stderr,
            )
    return out


def _gen_dirs(root: str) -> list:
    """``[(gen, path)]`` ascending; tolerates an absent root."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _GEN_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort()
    return out


def next_generation(root: str) -> int:
    """The next generation number (numbering continues across restarts,
    so a resumed run never overwrites its parent's generations)."""
    gens = _gen_dirs(root)
    return (gens[-1][0] + 1) if gens else 0


def _read_manifest(gen_path: str) -> Optional[dict]:
    try:
        with open(os.path.join(gen_path, "MANIFEST.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def save_generation(
    root: str, gen: int, snap: dict, manifest: dict, keep: int = DEFAULT_KEEP,
) -> str:
    """Write one complete generation (npz first, manifest LAST: the commit
    point), then prune to the newest ``keep`` complete generations.
    Returns the generation directory.  Raises ``OSError`` on a write
    failure, with the earlier generations untouched."""
    gen_dir = os.path.join(root, f"gen-{gen:06d}")
    os.makedirs(gen_dir, exist_ok=True)
    atomic_write_npz(os.path.join(gen_dir, "snapshot.npz"), snap)
    atomic_write_json(
        os.path.join(gen_dir, "MANIFEST.json"),
        {"v": CKPT_V, "gen": gen, **manifest},
    )
    prune_generations(root, keep)
    return gen_dir


def prune_generations(root: str, keep: int) -> None:
    """Delete everything but the newest ``keep`` COMPLETE generations.
    Incomplete (torn) generations older than the newest complete one go
    too: they can never be resumed from."""
    gens = _gen_dirs(root)
    complete = [(g, p) for g, p in gens if _read_manifest(p) is not None]
    if not complete:
        return  # never delete the only thing on disk, torn or not
    keep_paths = {p for _, p in complete[-max(keep, 1):]}
    newest_complete = complete[-1][0]
    for g, p in gens:
        if p in keep_paths:
            continue
        if _read_manifest(p) is None and g > newest_complete:
            continue  # a torn WRITE IN PROGRESS may still be committing
        try:
            shutil.rmtree(p)
        except OSError:
            pass


def list_generations(root: str) -> list:
    """``[{gen, path, complete, manifest?}]`` ascending."""
    out = []
    for g, p in _gen_dirs(root):
        man = _read_manifest(p)
        out.append({
            "gen": g, "path": p, "complete": man is not None,
            **({"manifest": man} if man is not None else {}),
        })
    return out


def latest_gen_number(root: str) -> Optional[int]:
    """The newest COMPLETE generation number, from the manifests alone (no
    npz load)."""
    for g, p in reversed(_gen_dirs(root)):
        if _read_manifest(p) is not None:
            return g
    return None


def latest_generation(root: str) -> Optional[tuple]:
    """``(snapshot_dict, manifest)`` of the newest COMPLETE generation, or
    None when the directory holds no resumable state.  A generation with a
    missing or corrupt manifest or an unloadable npz is TORN: it is skipped
    with a loud warning and the next-newest complete one is used."""
    for g, p in reversed(_gen_dirs(root)):
        man = _read_manifest(p)
        npz = os.path.join(p, "snapshot.npz")
        if man is None:
            print(
                f"stateright-tpu-torch: autosave: skipping torn generation "
                f"{p} (no complete MANIFEST.json — the writer died "
                "mid-save; resuming from the previous generation)",
                file=sys.stderr,
            )
            continue
        try:
            with np.load(npz, allow_pickle=False) as z:
                snap = {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError) as e:
            print(
                f"stateright-tpu-torch: autosave: skipping unreadable "
                f"generation {p} ({type(e).__name__}: {e})",
                file=sys.stderr,
            )
            continue
        return snap, man
    return None


class AutosaveService:
    """Per-run autosave driver: owns the cadence clock, the generation
    counter and the write and rotate plumbing.  The engine calls
    :meth:`due` at every host sync and :meth:`save` with a snapshot when it
    returns True (``every_secs=0`` saves at EVERY host sync).  A failed
    write degrades loudly (warn once, keep running): losing a checkpoint
    must never kill the run the checkpoints exist to protect."""

    def __init__(self, root: str, every_secs: float, keep: int,
                 recorder=None):
        self.root = str(root)
        self.every_secs = float(every_secs)
        self.keep = int(keep)
        # the run's flight recorder: one ``checkpoint`` record per
        # generation written or failed
        self.recorder = recorder
        self.generations_written = 0
        self.failures = 0
        self.last_gen: Optional[int] = None
        self.last_save_monotonic: Optional[float] = None
        self._warned = False
        os.makedirs(self.root, exist_ok=True)
        self._gen = next_generation(self.root)
        self._clock = time.monotonic()

    def due(self) -> bool:
        return time.monotonic() - self._clock >= self.every_secs

    def checkpoint_age_secs(self) -> Optional[float]:
        if self.last_save_monotonic is None:
            return None
        return time.monotonic() - self.last_save_monotonic

    def note_failure(self, gen: int, e: BaseException) -> None:
        """Account one failed generation write: warn ONCE, bump the
        failure counter and record an ``ok=false`` checkpoint record.
        Shared by :meth:`save` (an OSError from the atomic write) and the
        engine's outer guard (any other failure, e.g. while building the
        snapshot)."""
        self.failures += 1
        if not self._warned:
            self._warned = True
            print(
                f"stateright-tpu-torch: autosave: generation {gen} write "
                f"failed ({type(e).__name__}: {e}); the run continues "
                "WITHOUT fresh checkpoints (durability degraded)",
                file=sys.stderr,
            )
        if self.recorder is not None:
            self.recorder.record(
                "checkpoint", v=CKPT_V, gen=gen, ok=False,
                error=f"{type(e).__name__}: {e}",
            )

    def save(self, snap: dict, manifest: dict) -> Optional[str]:
        """Write one generation; returns its path, or None on a degraded
        (failed) write.  Resets the cadence clock either way: a failing
        disk must not turn every later sync into a write attempt."""
        t0 = self._clock = time.monotonic()
        gen = self._gen
        try:
            path = save_generation(
                self.root, gen, snap, manifest, keep=self.keep
            )
        except OSError as e:
            self.note_failure(gen, e)
            return None
        self._gen = gen + 1
        self.generations_written += 1
        self.last_gen = gen
        self.last_save_monotonic = time.monotonic()
        if self.recorder is not None:
            totals = manifest.get("totals", {})
            self.recorder.record(
                "checkpoint", v=CKPT_V, gen=gen, ok=True,
                unique=int(totals.get("unique") or 0),
                states=int(totals.get("states") or 0),
                secs=round(self.last_save_monotonic - t0, 6),
            )
        return path

    def status(self) -> dict:
        """The live autosave half of the durability block."""
        out = {
            "dir": self.root,
            "every_secs": self.every_secs,
            "keep": self.keep,
            "generations": self.generations_written,
            "failures": self.failures,
        }
        if self.last_gen is not None:
            out["last_gen"] = self.last_gen
        age = self.checkpoint_age_secs()
        if age is not None:
            out["last_checkpoint_age_secs"] = round(age, 3)
        return out

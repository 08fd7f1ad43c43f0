"""Crash-safe autosave checkpoints: rotating snapshot generations.

The port's own copy of ``stateright_tpu/checkpoint.py``; its atomic npz
and json writes are ``telemetry/_atomic.py``'s, the port's one write
discipline.  A generation write first fires the fault layer's
``snapshot_write`` seam (``testing/faults.py``; JAX ``checkpoint.py:121``).

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

The manifest also carries the run's identity and progress (``run_id``,
``config``, the report's canonical config block, the totals and each
property's discovery flag), so the supervisor can archive a **stub
report** (:func:`stub_report_doc`) for a run that was killed before it
archived itself: the run registry then holds the parent of the resumed
run, and the lineage diff can check the chain (``supervisor.py``).  Next
to the generations, :class:`ProgressHeartbeat` keeps ``progress.json``,
the live progress that ``python -m stateright_tpu_torch.models._cli
status DIR`` reads, SIGKILLed runs included (:func:`read_progress`).
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
from .testing import faults

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
    faults.fire("snapshot_write", gen=gen)
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


def stub_report_doc(manifest: dict) -> Optional[dict]:
    """A registry-archivable report document rebuilt from an autosave
    manifest: the parent record of a run that was killed before it could
    archive itself (``RunRegistry.record_doc``; JAX ``checkpoint.py:
    314-342``).  The totals carry ``done: false`` and ``interrupted:
    true``: this is a checkpoint of a run in flight, labelled as such.
    None when the manifest carries no run id or config."""
    from .telemetry.report import REPORT_V

    if not manifest.get("run_id") or not manifest.get("config"):
        return None
    totals = dict(manifest.get("totals") or {})
    totals["done"] = False
    totals["interrupted"] = True
    doc = {
        "generated_at": manifest.get("written_at"),
        "run_id": manifest["run_id"],
        "v": REPORT_V,
        "model": manifest.get("model"),
        "engine": manifest.get("engine"),
        "config": manifest["config"],
        "totals": totals,
        "properties": list(manifest.get("properties") or []),
    }
    if manifest.get("parent_run_id"):
        doc["parent_run_id"] = manifest["parent_run_id"]
    return doc


# -- the live progress heartbeat ------------------------------------------------

PROGRESS_V = 1
PROGRESS_FILE = "progress.json"

# a "running" heartbeat older than every_secs times this factor means the
# writer is gone (SIGKILLed) or wedged: the verdict ``status`` prints
STALE_FACTOR = 5.0


class ProgressHeartbeat:
    """Atomic ``progress.json`` writer next to the autosave generations
    (JAX ``checkpoint.py:357-417``).

    The engine beats it at every host sync that reaches its autosave seam
    (throttled to ``every_secs``), so ``python -m
    stateright_tpu_torch.models._cli status DIR`` can tail any headless
    run, one that was SIGKILLed too: the file keeps the last counters and
    a wall-clock ``ts``, and a stale ``ts`` on a ``running`` status is the
    post-mortem.  Every write is atomic (``telemetry/_atomic.py``), and a
    failed write drops the beat and keeps the run: liveness reporting
    must never kill the run it reports on."""

    def __init__(self, root: str, every_secs: float = 1.0,
                 meta: Optional[dict] = None):
        self.path = os.path.join(str(root), PROGRESS_FILE)
        self.every_secs = float(every_secs)
        self.meta = dict(meta or {})
        self._clock: Optional[float] = None
        self.beats = 0

    def beat(self, recorder=None, status: str = "running",
             force: bool = False, **extra) -> bool:
        """One heartbeat (dropped unless due or ``force``).  The payload
        samples the recorder's last step record and health snapshot, host
        values already in hand: no device work.  ``extra`` fields land in
        the document as they are (the fleet's pool tallies).  Returns
        True when a write landed."""
        now = time.monotonic()
        if not force and self._clock is not None:
            if now - self._clock < self.every_secs:
                return False
        self._clock = now
        doc = {
            "v": PROGRESS_V,
            "status": str(status),
            "ts": round(time.time(), 3),
            "every_secs": self.every_secs,
            **self.meta,
        }
        if recorder is not None:
            step = recorder.last_step()
            if step is not None:
                for k in ("states", "unique", "dt", "queue", "frontier",
                          "load_factor", "depth"):
                    if step.get(k) is not None:
                        doc[k] = step[k]
                doc["steps"] = recorder.kind_count("step")
            health = recorder.health()
            for k in ("phase", "stalled", "stall_reason",
                      "ewma_states_per_sec", "eta_secs", "oom_risk"):
                if health.get(k) is not None:
                    doc[k] = health[k]
        doc.update({k: v for k, v in extra.items() if v is not None})
        try:
            atomic_write_json(self.path, doc)
        except Exception:  # noqa: BLE001 - liveness reporting must never
            return False  # kill the run it reports on
        self.beats += 1
        return True


def read_progress(run_dir: str) -> Optional[dict]:
    """Parse ``<run_dir>/progress.json`` and attach the liveness verdict:
    ``fresh`` (the writer beat recently), ``age_secs`` and ``verdict``,
    ``running``, ``done`` or ``failed`` from the file, or ``dead`` when a
    ``running`` heartbeat went stale (the writer was SIGKILLed or
    wedged).  None when no heartbeat exists (JAX ``checkpoint.py:
    420-446``)."""
    path = os.path.join(str(run_dir), PROGRESS_FILE)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict):
        return None
    out = dict(doc)
    ts = doc.get("ts")
    if isinstance(ts, (int, float)):
        age = max(time.time() - float(ts), 0.0)
        out["age_secs"] = round(age, 3)
        every = float(doc.get("every_secs") or 1.0)
        out["fresh"] = age <= max(every * STALE_FACTOR, 5.0)
    else:
        out["fresh"] = False
    status = str(doc.get("status") or "running")
    if status == "running" and not out["fresh"]:
        out["verdict"] = "dead"
    else:
        out["verdict"] = status
    return out

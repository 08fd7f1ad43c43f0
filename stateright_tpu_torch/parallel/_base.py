"""Host-side surface shared by the port's device wavefront engines.

The port's counterpart of ``stateright_tpu/parallel/_base.py``
(``WavefrontChecker``), cut to the single-device engine: resolve the
model's tensor twin (and, under ``symmetry()``, check that it has a
vectorized canonicalizer), resolve ``prededup()`` against its env knob,
check that host and device fingerprints agree,
run the engine on a background thread (exceptions re-raise at
:meth:`join`), honour the builder's ``timeout`` and :meth:`stop` with a
cooperative stop at the next host sync, serve a live :meth:`checkpoint`
and the autosave cadence there (``checkpoint.py``), and rebuild discovery
traces on the host from the table's parent fingerprints, replayed through
the object model (``Path.from_fingerprints``, with the class-matching key
under symmetry).

**The checkpoint protocol** (JAX ``parallel/_base.py:606-772``, without
spans, faults, the heartbeat and the run identity): the caller thread
raises a request and waits on an event; the engine thread serves it at
its next host sync, right after the block's one stats read and before a
growth event, by building the snapshot itself (the caller never reads a
device tensor).  A snapshot taken at a growth boundary carries
``status != OK``, and resume re-applies the growth.  With no request and
autosave off, the sync adds no device read.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checker.base import Checker, CheckerBuilder
from ..checker.path import Path
from ..checkpoint import CKPT_V, AutosaveService, resolve_autosave
from ..fingerprint import MASK64
from ..ops.hashing import row_hash

ENV_PREDEDUP = "STATERIGHT_TPU_PREDEDUP"


def resolve_flag(mode: Optional[bool], env: str) -> bool:
    """A builder flag: an explicit setting wins, else the env knob ``=1``
    decides (JAX ``parallel/prewarm.py:226``)."""
    if mode is not None:
        return bool(mode)
    return os.environ.get(env, "") == "1"


class WavefrontChecker(Checker):
    """Common host-side surface for device wavefront engines."""

    _engine_tag = "single"

    def _init_common(self, options: CheckerBuilder) -> None:
        self.model = options.model
        tensor = self.model._tensor_cached()
        if tensor is None:
            raise TypeError(
                f"{type(self.model).__name__} has no tensor form: implement "
                "tensor_model() (see parallel/tensor_model.py) or use "
                "spawn_bfs()/spawn_dfs()"
            )
        self._symmetry = options.symmetry_fn
        if options.symmetry_fn is not None:
            if not hasattr(tensor, "representative_rows"):
                raise NotImplementedError(
                    f"{type(tensor).__name__} has no representative_rows(): "
                    "device symmetry reduction needs a vectorized "
                    "canonicalizer (see TwoPhaseTensor.representative_rows); "
                    "use spawn_dfs()"
                )
            if not options.symmetry_is_default:
                # representative_rows mirrors state.representative(); a
                # custom symmetry_with fn would silently disagree with the
                # device dedup and break trace reconstruction
                raise NotImplementedError(
                    "the GPU engine supports .symmetry() (the "
                    "representative() protocol) only; custom symmetry_with "
                    "functions require spawn_dfs()"
                )
        if options.visitor_obj is not None:
            raise NotImplementedError(
                "per-state visitors require host materialization; use "
                "spawn_bfs() (the GPU engine never materializes states)"
            )
        self.tensor = tensor
        self._props = list(self.model.properties())
        self._target = options.target_state_count
        # JAX ``parallel/_base.py:100-108``: the builder wins over the env
        self._prededup = resolve_flag(options.prededup_mode, ENV_PREDEDUP)
        self._verify_fingerprint_bridge()
        self._results: Optional[dict] = None
        self._live = (0, 0, 0)  # states, unique, maxdepth at the last sync
        self._parent_map: Optional[dict[int, int]] = None
        self._run_error: Optional[BaseException] = None
        self._done = threading.Event()
        # builder ``timeout()`` and :meth:`stop`: a cooperative stop at the
        # next host sync
        self._stop = threading.Event()
        # a live checkpoint request, served by the engine thread; the lock
        # serializes concurrent callers, which share the request, ready
        # and result slots
        self._ckpt_req = threading.Event()
        self._ckpt_ready = threading.Event()
        self._ckpt_out: Optional[dict] = None
        self._ckpt_lock = threading.Lock()
        self._autosave: Optional[AutosaveService] = None
        aopts = resolve_autosave(options.autosave_opts)
        if aopts is not None:
            self._autosave = AutosaveService(
                aopts["dir"], aopts["every_secs"], aopts["keep"])
        # (snapshot seconds, write seconds) of each autosave generation
        self.autosave_secs: list = []
        if options.timeout_secs is not None:
            timer = threading.Timer(options.timeout_secs, self._stop.set)
            timer.daemon = True
            timer.start()
        # caller errors (a snapshot from another model) raise here, in the
        # caller's thread, not inside the worker
        self._pre_run_validate()
        self._thread = threading.Thread(target=self._run_guarded, daemon=True)
        self._thread.start()

    def _run_guarded(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - re-raised at join()
            self._run_error = e
        finally:
            self._done.set()

    def _run(self) -> None:  # engine-specific
        raise NotImplementedError

    def _pre_run_validate(self) -> None:  # engine-specific, optional
        pass

    def _verify_fingerprint_bridge(self) -> None:
        """The host fingerprint must equal the device row hash, else traces
        cannot be reconstructed."""
        for s in self.model.init_states():
            host_fp = self.model.fingerprint_state(s)
            row = np.asarray([self.tensor.encode_state(s)], np.uint64)
            dev_fp = int(row_hash(torch.from_numpy(row.view(np.int64)))[0])
            if host_fp != dev_fp & MASK64:
                raise RuntimeError(
                    "model.fingerprint_state disagrees with the device row "
                    "hash; tensor-backed models must fingerprint via their "
                    "row encoding (mix in TensorBackedModel)"
                )
            break

    def _model_sig(self) -> np.ndarray:
        """Model identity guard for resume, the JAX engine's layout: sorted
        init fingerprints, then width, arity and property count."""
        fps = [self.model.fingerprint_state(s) for s in self.model.init_states()]
        return np.asarray(
            sorted(fps)
            + [self.tensor.width, self.tensor.max_actions, len(self._props)],
            np.uint64,
        )

    def _check_snapshot_sig(self, snap: dict) -> None:
        tag = str(snap.get("engine", "single"))
        if tag != self._engine_tag:
            raise ValueError(
                f"resume snapshot was taken by the {tag!r} engine; this is "
                f"the {self._engine_tag!r} engine"
            )
        sig = snap.get("model_sig")
        if sig is not None and not np.array_equal(self._model_sig(), sig):
            raise ValueError(
                "resume snapshot was taken from a different model "
                "(init fingerprints / tensor signature disagree)"
            )
        for key in ("spill_base", "spill_fp", "spill_q_fp", "spill_pend_fp"):
            if key in snap and (key != "spill_base" or int(snap[key]) > 0):
                raise ValueError(
                    "resume snapshot carries spill-tier contents, which the "
                    "port does not support yet"
                )

    # -- stop, checkpoint and autosave ---------------------------------------

    def final_snapshot(self) -> dict:  # engine-specific
        raise NotImplementedError

    def stop(self) -> "WavefrontChecker":
        """Ask the engine to stop at the next host sync (with autosave on,
        it writes one last generation there)."""
        self._stop.set()
        return self

    def checkpoint(self, timeout: Optional[float] = 60.0) -> dict:
        """Snapshot the run state (numpy arrays, serializable with
        ``np.savez``).  Mid-run the snapshot is taken at the next host
        sync; after completion it is the final state.  Continue with
        ``spawn_gpu(resume=snapshot)``, or the JAX engine's
        ``spawn_tpu(resume=snapshot)``."""
        if self._done.is_set():
            return self.final_snapshot()
        with self._ckpt_lock:
            self._ckpt_ready.clear()
            self._ckpt_req.set()
            # poll: the run can finish between the request and its next
            # sync, and then the final snapshot is the answer
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._ckpt_ready.wait(0.2):
                if self._done.is_set():
                    self._ckpt_req.clear()
                    return self.final_snapshot()
                if deadline is not None and time.monotonic() > deadline:
                    self._ckpt_req.clear()
                    raise TimeoutError("checkpoint request not served")
            out, self._ckpt_out = self._ckpt_out, None
        return out

    def _at_host_sync(self, snap_fn: Callable[[], dict]) -> bool:
        """The engine thread's seam at each host sync: serve a pending
        :meth:`checkpoint` and write an autosave generation when one is
        due.  ``snap_fn`` builds the snapshot, at most once per sync, and
        only when one is asked for.  Returns whether a generation was
        written."""
        snap = None
        if self._ckpt_req.is_set():
            snap = snap_fn()
            # the caller's own dict: it may edit keys while the autosave
            # below writes this snapshot
            self._ckpt_out = dict(snap)
            self._ckpt_req.clear()
            self._ckpt_ready.set()
        return self._maybe_autosave(snap_fn if snap is None else lambda: snap)

    def _maybe_autosave(self, snap_fn: Callable[[], dict],
                        force: bool = False) -> bool:
        """Write one autosave generation when the cadence is due (or
        ``force``: the stop path saves unless this sync already has, so a
        stopped run loses at most the current block); returns whether one
        was written.  A failure never kills the run: ``OSError`` is
        accounted inside ``save()``, anything else here."""
        svc = self._autosave
        if svc is None or not (force or svc.due()):
            return False
        t0 = time.monotonic()
        try:
            snap = snap_fn()
            t1 = time.monotonic()
            if svc.save(snap, self._autosave_manifest(snap)) is not None:
                self.autosave_secs.append((t1 - t0, time.monotonic() - t1))
                return True
        except Exception as e:  # noqa: BLE001 - see the docstring
            svc._clock = time.monotonic()  # a failing path must not turn
            # every later sync into a fresh attempt
            svc.note_failure(svc._gen, e)
        return False

    def _autosave_manifest(self, snap: dict) -> dict:
        """The generation manifest: the model, the engine, the progress at
        the checkpoint and each property's discovery flag, so resume picks
        a generation without loading its npz."""
        disc = np.asarray(snap.get("disc", np.zeros(0))).reshape(-1)
        return {
            "model": type(self.model).__name__,
            "engine": ("wavefront" if self._engine_tag == "single"
                       else self._engine_tag),
            "totals": {
                "states": int(np.asarray(snap.get("scount", 0))),
                "unique": int(np.asarray(snap.get("unique", 0))),
                "max_depth": int(np.asarray(snap.get("maxdepth", 0))),
            },
            "properties": [
                {"name": p.name,
                 "expectation": p.expectation.name.lower(),
                 "discovery": bool(i < disc.size and int(disc[i]) != 0)}
                for i, p in enumerate(self._props)
            ],
            "restarts": 0,  # no supervisor restarts a port run yet
            "written_at": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds"),
        }

    def durability_status(self) -> Optional[dict]:
        """The live durability block (the cadence, the generations written
        and failed, the age of the last one), or None when autosave is
        off."""
        if self._autosave is None:
            return None
        return {"v": CKPT_V, "restarts": 0,
                "autosave": self._autosave.status()}

    # -- Checker surface -----------------------------------------------------

    def is_done(self) -> bool:
        return self._done.is_set()

    def join(self) -> "WavefrontChecker":
        self._thread.join()
        if self._run_error is not None:
            raise self._run_error
        return self

    def state_count(self) -> int:
        return self._results["states"] if self._results else self._live[0]

    def unique_state_count(self) -> int:
        return self._results["unique"] if self._results else self._live[1]

    def max_depth(self) -> int:
        return self._results["depth"] if self._results else self._live[2]

    def _table_np(self):
        """(fingerprints, parents) of the final visited table, numpy uint64."""
        raise NotImplementedError

    @staticmethod
    def _parents_from_table(tfp: np.ndarray, tpl: np.ndarray) -> dict[int, int]:
        """fp -> parent fp map from uint64 table arrays."""
        tfp = np.asarray(tfp).reshape(-1)
        tpl = np.asarray(tpl).reshape(-1)
        occupied = tfp != np.uint64(MASK64)
        return dict(zip(tfp[occupied].tolist(), tpl[occupied].tolist()))

    @staticmethod
    def _walk(parents: dict[int, int], fp: int) -> list[int]:
        """Parent chain from an init state down to ``fp`` (0 marks "is an
        init state")."""
        fps = [fp]
        while True:
            parent = parents.get(fps[-1], 0)
            if parent == 0:
                break
            fps.append(parent)
        fps.reverse()
        return fps

    def _parents(self) -> dict[int, int]:
        if self._parent_map is None:
            self._parent_map = self._parents_from_table(*self._table_np())
        return self._parent_map

    def _trace(self, fp: int) -> list[int]:
        return self._walk(self._parents(), fp)

    def discovery_fps(self) -> dict[str, int]:
        """Property name -> discovery fingerprint (unsigned)."""
        self.join()
        disc = self._results["disc"]
        return {
            prop.name: int(disc[i])
            for i, prop in enumerate(self._props)
            if int(disc[i]) != 0
        }

    def _symmetry_key(self):
        """None, or under symmetry the host key of a state's class: the
        twin's own ``representative_key`` where it has one (a compiled
        twin hashes a virtual canonical row, not an encodable state), else
        the fingerprint of the representative."""
        if self._symmetry is None:
            return None
        tkey = getattr(self.tensor, "representative_key", None)
        if tkey is not None:
            return tkey
        sym, model = self._symmetry, self.model
        return lambda s: model.fingerprint_state(sym(s))

    def discoveries(self) -> dict[str, Path]:
        key = self._symmetry_key()
        return {
            name: Path.from_fingerprints(self.model, self._trace(fp), key=key)
            for name, fp in self.discovery_fps().items()
        }

"""Host-side surface shared by the port's device wavefront engines.

The port's counterpart of ``stateright_tpu/parallel/_base.py``
(``WavefrontChecker``), cut to the single-device engine: resolve the
model's tensor twin (and, under ``symmetry()``, check that it has a
vectorized canonicalizer), check that host and device fingerprints agree,
run the engine on a background thread (exceptions re-raise at
:meth:`join`), honour the builder's ``timeout`` with a cooperative stop at
the next host sync, and rebuild discovery traces on the host from the
table's parent fingerprints, replayed through the object model
(``Path.from_fingerprints``, with the class-matching key under symmetry).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..checker.base import Checker, CheckerBuilder
from ..checker.path import Path
from ..fingerprint import MASK64
from ..ops.hashing import row_hash


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
        self._verify_fingerprint_bridge()
        self._results: Optional[dict] = None
        self._live = (0, 0, 0)  # states, unique, maxdepth at the last sync
        self._parent_map: Optional[dict[int, int]] = None
        self._run_error: Optional[BaseException] = None
        self._done = threading.Event()
        # builder ``timeout()``: a cooperative stop at the next host sync
        self._stop = threading.Event()
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

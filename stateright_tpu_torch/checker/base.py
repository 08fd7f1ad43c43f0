"""Checker result surface + builder (reference ``src/checker.rs``).

The port's counterpart of ``stateright_tpu/checker/base.py``:
``CheckerBuilder`` carries ``symmetry``, ``target_states``, ``threads``,
``visitor``, ``timeout`` and ``autosave``, and spawns the host checkers
(:meth:`CheckerBuilder.spawn_bfs`, :meth:`CheckerBuilder.spawn_dfs`,
:meth:`CheckerBuilder.spawn_mp_bfs`), the GPU wavefront engine
(:meth:`CheckerBuilder.spawn_gpu`) and the engine chosen by a bounded host
probe (:meth:`CheckerBuilder.spawn_auto`); ``Checker`` is the result
surface (counts, discoveries, assertions, and the ``Done. states=..``
report line).  The telemetry, report, sweep and service options come with
their slices.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional, Sequence

from ..core import Expectation, Model, Property
from .path import Path
from .visitor import CheckerVisitor, FnVisitor

# States processed per lock round, as in the reference's job market
# (reference ``bfs.rs:120``, ``dfs.rs:126``).
JOB_BLOCK_SIZE = 1500


class CheckerBuilder:
    """Fluent checker configuration (reference ``checker.rs:35-179``)."""

    def __init__(self, model: Model):
        self.model = model
        self.symmetry_fn: Optional[Callable] = None
        self.symmetry_is_default = False
        self.target_state_count: Optional[int] = None
        self.thread_count: int = 1
        self.visitor_obj: Optional[CheckerVisitor] = None
        self.timeout_secs: Optional[float] = None
        self.autosave_opts: Optional[dict] = None

    def symmetry(self) -> "CheckerBuilder":
        """Dedup on symmetry-class representatives; states must define
        ``representative()`` (reference ``checker.rs:150-154``).  The host
        DFS and the GPU engine honour it; the host BFS ignores it, as the
        reference's does."""
        self.symmetry_fn = lambda s: s.representative()
        self.symmetry_is_default = True
        return self

    def symmetry_with(self, fn: Callable) -> "CheckerBuilder":
        """Dedup on ``fn(state)``: the host DFS only (the GPU engine refuses
        it, since its canonicalizer mirrors ``representative()``)."""
        self.symmetry_fn = fn
        self.symmetry_is_default = False
        return self

    def target_states(self, count: int) -> "CheckerBuilder":
        """Stop after roughly ``count`` unique states
        (reference ``checker.rs:163-167``)."""
        self.target_state_count = count
        return self

    def threads(self, count: int) -> "CheckerBuilder":
        """Worker threads of the host checkers."""
        self.thread_count = max(1, count)
        return self

    def visitor(self, v) -> "CheckerBuilder":
        """Call ``v`` (a :class:`CheckerVisitor` or a plain callable of
        ``(model, path)``) on every state the host checkers evaluate."""
        self.visitor_obj = v if isinstance(v, CheckerVisitor) else FnVisitor(v)
        return self

    def timeout(self, secs: float) -> "CheckerBuilder":
        self.timeout_secs = secs
        return self

    def autosave(self, path: str, every_secs: float = 60.0,
                 keep: int = 3) -> "CheckerBuilder":
        """Autosave a GPU engine run to rotating snapshot generations under
        ``path`` (``checkpoint.py``): at a host sync, once ``every_secs``
        has passed since the last save (``0`` = every host sync), the
        engine writes its resume snapshot as ``gen-NNNNNN/snapshot.npz``
        and then a ``MANIFEST.json``, both atomically (temp file, fsync,
        ``os.replace``), so a crash mid-save leaves a torn generation that
        resume skips.  The newest ``keep`` complete generations are kept,
        and a stopped run (``stop()``, ``timeout()``) writes one last
        generation.  Resume with ``spawn_gpu(resume=
        checkpoint.latest_generation(path)[0])``; the JAX engine resumes
        from the same files.  Env equivalent:
        ``STATERIGHT_TPU_AUTOSAVE=DIR`` (cadence and keep through
        ``STATERIGHT_TPU_AUTOSAVE_SECS``/``_KEEP``).  With autosave off a
        block still makes exactly one host read."""
        self.autosave_opts = {
            "dir": str(path),
            "every_secs": float(every_secs),
            "keep": int(keep),
        }
        return self

    # -- strategies ----------------------------------------------------------

    def spawn_bfs(self) -> "Checker":
        """Breadth-first search on host threads (``checker/bfs.py``)."""
        from .bfs import BfsChecker

        return BfsChecker(self)

    def spawn_dfs(self) -> "Checker":
        """Depth-first search on host threads (``checker/dfs.py``); the
        host checker that honours ``symmetry()``."""
        from .dfs import DfsChecker

        return DfsChecker(self)

    def spawn_mp_bfs(self, processes: Optional[int] = None) -> "Checker":
        """Process-parallel BFS: real multi-core checking (the thread pool
        is GIL-bound).  Fingerprint-ownership sharding over forked workers,
        with symmetry and visitors (``checker/mp.py``).  ``processes``
        defaults to ``threads(N)`` if set above 1, else all cores."""
        from .mp import MpBfsChecker

        return MpBfsChecker(self, processes=processes)

    def spawn_auto(self, probe_secs: float = 2.0, **gpu_kw) -> "Checker":
        """Pick the engine by *measured* space size: the GPU engine pays a
        fixed cost per run (kernel builds, table setup, a host sync per
        block) that a small space never earns back on the host BFS.

        (1) A host probe runs first, bounded by ``probe_secs``: if the
        space exhausts within the budget, the finished checker IS the
        result.  (2) A space that outlives the probe escalates to
        :meth:`spawn_gpu` (``gpu_kw`` passes through; with no CUDA device
        and no ``device="cpu"`` that raises, as ``spawn_gpu`` does: the
        probe's partial result is never returned in its place), with the
        probe's wall-clock deducted from any ``timeout()``.  With a
        visitor, which the GPU engine rejects, the heavier engine is
        :meth:`spawn_mp_bfs`, where ``fork`` exists and there is more
        than one core.  A model with no twin (or whose twin fails to
        build) checks on the host engines outright.  With ``symmetry()``
        the probe is the host DFS, the host engine that honours it
        (JAX ``checker/base.py:660-749``)."""
        import time as _time

        cpu_spawn = self.spawn_dfs if self.symmetry_fn else self.spawn_bfs

        def probe_then(escalate, small=None):
            """A visitor-free sizing probe on the host engine, then either
            the ``small`` outcome (default: the finished probe itself) or
            ``escalate``.  Without a visitor the probe's wall-clock is
            deducted from the user ``timeout()``; with one the final
            engine gets the full timeout, so callbacks fire exactly once,
            on a fully budgeted run."""
            if (self.timeout_secs is not None
                    and self.timeout_secs <= probe_secs):
                return cpu_spawn()  # the whole run fits in the probe budget
            saved = self.timeout_secs
            vis, self.visitor_obj = self.visitor_obj, None
            self.timeout_secs = probe_secs
            t0 = _time.monotonic()
            try:
                probe = cpu_spawn().join()
            finally:
                self.timeout_secs = saved
                self.visitor_obj = vis
            if not probe.timed_out:
                return probe if small is None else small()
            if saved is None or vis is not None:
                return escalate()
            remaining = saved - (_time.monotonic() - t0)
            if remaining <= 0:
                return probe  # budget gone: the partial probe result is it
            self.timeout_secs = remaining
            try:
                return escalate()
            finally:
                self.timeout_secs = saved

        if self.visitor_obj is not None:
            # the GPU engine rejects visitors (it never materializes
            # states), so a big space escalates to the process-parallel
            # BFS (visitors by replay), where there are cores to win and
            # fork exists; a small one re-runs the host engine with the
            # visitor attached
            import multiprocessing as _mp
            import os as _os

            can_mp = (_os.cpu_count() or 1) > 1 and (
                "fork" in _mp.get_all_start_methods()
            )
            if not can_mp:
                return cpu_spawn()
            return probe_then(self.spawn_mp_bfs, small=cpu_spawn)
        from ..parallel.tensor_model import twin_or_none

        if twin_or_none(self.model) is None:
            return cpu_spawn()
        return probe_then(lambda: self.spawn_gpu(**gpu_kw))

    def spawn_gpu(
        self,
        capacity: int = 1 << 17,
        batch: int = 1 << 11,
        cand: Optional[int] = None,
        steps_per_call: int = 64,
        device=None,
        resume: Optional[dict] = None,
    ) -> "Checker":
        """Wavefront BFS on the GPU (``parallel/wavefront.py``).

        ``device=None`` means ``cuda``: with no CUDA device this raises and
        never falls back to the CPU.  Tests pass ``device="cpu"``, which
        runs every kernel's plain PyTorch version.  ``resume`` takes a
        snapshot from either engine (``convert.py``)."""
        from ..parallel.wavefront import GpuChecker

        return GpuChecker(
            self, capacity=capacity, batch=batch, cand=cand,
            steps_per_call=steps_per_call, device=device, resume=resume,
        )


class Checker:
    """Uniform result surface (reference ``checker.rs:185-338``)."""

    model: Model

    # -- strategy-provided ---------------------------------------------------

    def state_count(self) -> int:
        """Total states generated, including duplicates."""
        raise NotImplementedError

    def unique_state_count(self) -> int:
        raise NotImplementedError

    def max_depth(self) -> int:
        return 0

    def discoveries(self) -> dict[str, Path]:
        """Property name -> discovered example/counterexample path."""
        raise NotImplementedError

    def join(self) -> "Checker":
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    # -- shared --------------------------------------------------------------

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        """"example" or "counterexample" (reference ``checker.rs:245-252``)."""
        exp = self.model.property_by_name(name).expectation
        return "example" if exp == Expectation.SOMETIMES else "counterexample"

    def report(self, stream=None) -> "Checker":
        """Block until done, printing 1 Hz progress then a final ``sec=`` line
        and discoveries (reference ``checker.rs:217-242``)."""
        stream = stream or sys.stdout
        start = time.monotonic()
        last = 0.0
        while not self.is_done():
            now = time.monotonic()
            if now - last >= 1.0:
                print(
                    f"Checking. states={self.state_count()}, "
                    f"unique={self.unique_state_count()}",
                    file=stream,
                )
                last = now
            time.sleep(0.05)
        self.join()
        sec = max(time.monotonic() - start, 1e-9)
        print(
            f"Done. states={self.state_count()}, "
            f"unique={self.unique_state_count()}, sec={sec:.6g}",
            file=stream,
        )
        for name, path in sorted(self.discoveries().items()):
            cls = self.discovery_classification(name)
            print(f'Discovered "{name}" {cls} {path!r}', file=stream)
        return self

    # -- assertions (reference ``checker.rs:256-338``) -----------------------

    def assert_properties(self) -> None:
        for prop in self.model.properties():
            if prop.expectation == Expectation.SOMETIMES:
                self.assert_any_discovery(prop.name)
            else:
                self.assert_no_discovery(prop.name)

    def assert_any_discovery(self, name: str) -> Path:
        path = self.discovery(name)
        if path is None:
            raise AssertionError(f"Missing discovery for {name!r}.")
        return path

    def assert_no_discovery(self, name: str) -> None:
        path = self.discovery(name)
        if path is not None:
            raise AssertionError(
                f"Unexpected \"{name}\" "
                f"{self.discovery_classification(name)} {path!r}"
            )

    def assert_discovery(self, name: str, actions: Sequence) -> None:
        """Assert a discovery exists and that ``actions`` is one valid witness
        trace, by re-executing the model (reference ``checker.rs:293-338``)."""
        self.assert_any_discovery(name)
        prop = self.model.property_by_name(name)
        model = self.model
        last_err = f"no init state admits the action sequence {list(actions)!r}"
        for init in model.init_states():
            path = Path.from_actions(model, init, actions)
            if path is None:
                continue
            final = path.final_state()
            if prop.expectation == Expectation.ALWAYS:
                if prop.condition(model, final):
                    raise AssertionError(
                        f"path does not violate always property {name!r}")
                return
            if prop.expectation == Expectation.SOMETIMES:
                if not prop.condition(model, final):
                    raise AssertionError(
                        f"path does not satisfy sometimes property {name!r}")
                return
            # an EVENTUALLY counterexample: no state along the maximal path
            # satisfies the condition, and the path ends in a terminal state
            if any(prop.condition(model, s) for s in path.states()):
                raise AssertionError(
                    f"path satisfies eventually property {name!r}")
            if model.next_steps(final):
                raise AssertionError(
                    f"path for eventually property {name!r} does not end "
                    "terminal")
            return
        raise AssertionError(last_err)


class ParentPointerTrace:
    """Path reconstruction for checkers whose visited map stores
    ``child_fp -> parent_fp`` with root sentinel 0 (the host BFS;
    reference ``bfs.rs:314-342``).  Requires ``self.model``,
    ``self._generated`` (the parent-pointer map) and ``self._discoveries``
    (property name -> discovery fp)."""

    def _trace(self, fp: int) -> list[int]:
        fps = [fp]
        while True:
            parent = self._generated.get(fps[-1], 0)
            if parent == 0:
                break
            fps.append(parent)
        fps.reverse()
        return fps

    def discoveries(self) -> dict[str, Path]:
        return {
            name: Path.from_fingerprints(self.model, self._trace(fp))
            for name, fp in dict(self._discoveries).items()
        }


def evaluate_properties(
    model, props: Sequence[Property], discoveries: dict, state, ebits, token
):
    """Per-state property evaluation (reference ``bfs.rs:192-227``): record
    always-counterexamples and sometimes-examples under ``token`` (first
    writer wins), clear satisfied eventually bits.  Returns the updated
    ebits."""
    for i, prop in enumerate(props):
        if prop.expectation is Expectation.ALWAYS:
            if prop.name not in discoveries and not prop.condition(model, state):
                discoveries.setdefault(prop.name, token)
        elif prop.expectation is Expectation.SOMETIMES:
            if prop.name not in discoveries and prop.condition(model, state):
                discoveries.setdefault(prop.name, token)
        elif i in ebits and prop.condition(model, state):
            ebits = ebits - {i}
    return ebits


def flush_terminal_ebits(
    props: Sequence[Property], discoveries: dict, ebits, token
) -> None:
    """Liveness bits still set at a terminal state are counterexamples
    (reference ``bfs.rs:265-272``)."""
    for i in ebits:
        discoveries.setdefault(props[i].name, token)


def init_ebits(properties: Sequence[Property]) -> frozenset[int]:
    """Initial liveness bits: one per ``eventually`` property, set at path
    start, cleared when satisfied; bits still set at a terminal state flush
    as counterexamples (reference ``checker.rs:341-348``).  As in the
    reference, the bits are not part of the fingerprint, which can miss
    counterexamples on DAG joins and cycles (``bfs.rs:239-257``)."""
    return frozenset(
        i for i, p in enumerate(properties)
        if p.expectation == Expectation.EVENTUALLY
    )

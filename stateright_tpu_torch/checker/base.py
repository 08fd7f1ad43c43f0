"""Checker result surface + builder (reference ``src/checker.rs``).

The port's counterpart of ``stateright_tpu/checker/base.py``, cut to what
the GPU wavefront engine needs: ``CheckerBuilder`` carries
``target_states`` and ``timeout`` and spawns the engine with
:meth:`CheckerBuilder.spawn_gpu`; ``Checker`` is the result surface
(counts, discoveries, assertions, and the ``Done. states=..`` report line).
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from ..core import Expectation, Model
from .path import Path


class CheckerBuilder:
    """Fluent checker configuration (reference ``checker.rs:35-179``)."""

    def __init__(self, model: Model):
        self.model = model
        self.target_state_count: Optional[int] = None
        self.timeout_secs: Optional[float] = None

    def target_states(self, count: int) -> "CheckerBuilder":
        """Stop after roughly ``count`` unique states
        (reference ``checker.rs:163-167``)."""
        self.target_state_count = count
        return self

    def timeout(self, secs: float) -> "CheckerBuilder":
        self.timeout_secs = secs
        return self

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

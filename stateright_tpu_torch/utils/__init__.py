"""L0 utilities (reference ``src/util.rs``, ``src/util/``).

The port's own copy of ``stateright_tpu/utils/``."""

from .densenatmap import DenseNatMap
from .vector_clock import VectorClock

__all__ = ["DenseNatMap", "VectorClock"]

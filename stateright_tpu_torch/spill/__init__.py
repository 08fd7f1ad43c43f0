"""The spill tier: a visited set larger than the card's memory.

The port's own copy of ``stateright_tpu/spill/`` (``docs/spill.md``).
The visited set becomes a tiered store:

 - **hot tier**: the device bucket table (``ops/buckets.py``), unchanged;
 - **host tier**: an append-only ``(fingerprint, parent)`` store in host
   RAM (:class:`SpillStore`) behind an open-addressing hash index
   (:class:`HostIndex`);
 - **disk tier**: mmap'd append-only segment files behind the host tier,
   written when the host tier passes its byte budget
   (``STATERIGHT_TPU_HOST_BYTES``); the index stays in RAM.

A device Bloom filter over the spilled fingerprints (``bloom.py``) rides
the engine's carry and answers "definitely not spilled" inside the step,
so only the candidates that may have been spilled are deferred to a
pending buffer and resolved against the host index at the next host
sync.  The engine wiring is in ``parallel/wavefront.py``
(``CheckerBuilder.spill()``, ``--spill``, ``STATERIGHT_TPU_SPILL=1``);
this package knows nothing of the engine.
"""

from .bloom import (
    BLOOM_K,
    bloom_est_false_pos,
    bloom_set_np,
    bloom_test,
    bloom_test_np,
)
from .store import (
    BYTES_PER_ENTRY,
    ENV_HOST_BYTES,
    HostIndex,
    SpillStore,
    default_host_budget,
)

# spill status and ring-record schema version (JAX ``spill/__init__.py``)
SPILL_V = 1

__all__ = [
    "BLOOM_K",
    "BYTES_PER_ENTRY",
    "ENV_HOST_BYTES",
    "HostIndex",
    "SPILL_V",
    "SpillStore",
    "bloom_est_false_pos",
    "bloom_set_np",
    "bloom_test",
    "bloom_test_np",
    "default_host_budget",
]

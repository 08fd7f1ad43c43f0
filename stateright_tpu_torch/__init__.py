"""stateright_tpu_torch — the PyTorch/CUDA port of ``stateright_tpu``.

A second package beside the JAX reference: the same models, fingerprints,
visited-table layout and exploration order, run by a wavefront BFS engine
on an NVIDIA GPU whose device kernels are written by hand in CUDA C++
(``csrc/``).  It imports ``torch`` and numpy, never ``jax`` and nothing of
``stateright_tpu``.  It carries the plain engine path for the 2pc twin
(``TwoPhaseSys(n).checker().spawn_gpu()``) and for the paxos benchmark
model, an actor system on the port's host actor layer (``actor/``,
``semantics/``) with the hand-written twin ``PaxosTensor``
(``paxos_model(n).checker().spawn_gpu()``), the other actor systems
through the actor compiler (ORL-wrapped systems among them), symmetry
reduction (``.symmetry().spawn_gpu()``), live checkpoints, ``stop()`` and
autosave of a GPU run (``checkpoint.py``), the host checkers
(``spawn_bfs()``, ``spawn_dfs()``, the process-parallel ``spawn_mp_bfs()``)
and ``spawn_auto()``, which sizes the space with a bounded host probe
before it escalates to the GPU engine.
"""

from .checker import Checker, CheckerBuilder, Path
from .core import Expectation, Model, Property

__all__ = [
    "Checker",
    "CheckerBuilder",
    "Expectation",
    "Model",
    "Path",
    "Property",
]

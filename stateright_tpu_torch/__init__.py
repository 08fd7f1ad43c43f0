"""stateright_tpu_torch — the PyTorch/CUDA port of ``stateright_tpu``.

A second package beside the JAX reference: the same models, fingerprints,
visited-table layout and exploration order, run by a wavefront BFS engine
on an NVIDIA GPU whose device kernels are written by hand in CUDA C++
(``csrc/``).  It imports ``torch`` and numpy, never ``jax`` and nothing of
``stateright_tpu``.  This slice carries the plain engine path for the 2pc
twin: ``TwoPhaseSys(n).checker().spawn_gpu()``.
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

"""The out-of-range gather twin of the JAX package's sanitizer tests
(``tests/test_sanitizer.py:64-80``) in the port, for the checked-mode
tests on the CPU (``test_torch_checked.py``, the ``checked`` case of
``test_torch_engine.py``'s isolation test) and on the card
(``test_torch_gpu.py``).  This file imports no JAX."""

import numpy as np
import torch

from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.parallel.tensor_model import (
    BitPacker,
    TensorBackedModel,
    TensorModel,
)


class OOBTwin(TensorModel):
    """A 3-bit count indexes a 4-entry table: 4..7 escape it."""

    width, max_actions = 1, 1
    pk = BitPacker([("count", 3)])

    def __init__(self, model):
        self.model = model
        self._tables: dict = {}

    def init_rows(self):
        return np.zeros((1, 1), np.uint64)

    def table(self, device) -> torch.Tensor:
        """The 4-entry table on ``device``, built at the first step there:
        a step issues no host-to-device copy, so the engine's block graph
        can capture it."""
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.tensor(
                [1, 2, 3, 4], dtype=torch.int64, device=device)
        return t

    def encode_state(self, s):
        return (int(s),)

    def decode_state(self, row):
        return int(row[0])

    def property_masks(self, rows):
        return torch.ones((rows.shape[0], 1), dtype=torch.bool,
                          device=rows.device)

    def step_rows(self, rows):
        c = self.pk.get(rows, "count")
        tbl = self.table(rows.device)
        succ = rows.clone()
        succ[..., 0] = tbl[c]
        return succ[:, None, :], (c < 7)[:, None]


class Counter:
    """The object model: a counter 0..7."""

    def init_states(self):
        return [0]

    def actions(self, s):
        return [0] if s < 7 else []

    def next_state(self, s, a):
        return s + 1


class OOBModel(Counter, TensorBackedModel, Model):
    def tensor_model(self):
        return OOBTwin(self)

    def properties(self):
        return [Property.always("ok", lambda m, s: True)]

"""Fixture models for partial-order reduction (POR).

The port's copies of the JAX package's ``tests/fixtures_por.py``, kept in
the package so both the tests and ``chip_smoke.py`` can run them.  The
bundled examples get little or no reduction from sound POR (2pc's
verdict-relevant actions are all property-visible); these are the models
where reduction IS sound, so the ample-set machinery's effect and the
cycle proviso's necessity can be pinned exactly:

 - :class:`WorkersSys`: ``n`` independent workers, each advancing a
   private 2-bit counter 0 -> 1 -> 2; the properties read worker 0 only,
   so workers 1..n-1 are invisible and pairwise independent.  The full
   space is ``3^n`` states; the reduced search is linear in ``n``.
 - :class:`ToggleSys`: a cycle (worker A toggles a private bit) and a
   visible one-shot action B.  Without the duplicate-based cycle proviso
   the reduced search would starve B forever on the A-cycle and lose the
   ``y set`` discovery; with it, all 4 states are found with fewer
   generated candidates (6 < 7).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import Model, Property
from ..parallel.tensor_model import BitPacker, TensorBackedModel, TensorModel


class WorkersTensor(TensorModel):
    def __init__(self, sys: "WorkersSys"):
        self.model = sys
        self.n = sys.n
        self.packer = BitPacker([(f"f{i}", 2) for i in range(sys.n)])
        self.width = self.packer.width
        self.max_actions = sys.n

    def init_rows(self):
        return np.zeros((1, self.width), np.uint64)

    def encode_state(self, s):
        return self.packer.pack(**{f"f{i}": v for i, v in enumerate(s)})

    def decode_state(self, row):
        f = self.packer.unpack(row)
        return tuple(f[f"f{i}"] for i in range(self.n))

    def step_rows(self, rows):
        pk = self.packer
        succs, valids = [], []
        for i in range(self.n):
            f = pk.get(rows, f"f{i}")
            valids.append(f < 2)
            succs.append(pk.set(rows, f"f{i}", f + 1))
        return torch.stack(succs, -2), torch.stack(valids, -1)

    def property_masks(self, rows):
        f0 = self.packer.get(rows, "f0")
        return torch.stack([f0 == 2, f0 <= 2], -1)


@dataclass(frozen=True)
class WorkersSys(TensorBackedModel, Model):
    """``n`` independent private counters; properties read worker 0 only.
    The always-property never discovers, so full runs crawl the whole
    ``3^n`` space instead of exiting early."""

    n: int

    def tensor_model(self):
        return WorkersTensor(self)

    def init_states(self):
        return [(0,) * self.n]

    def actions(self, s):
        return [i for i in range(self.n) if s[i] < 2]

    def next_state(self, s, a):
        out = list(s)
        out[a] += 1
        return tuple(out)

    def properties(self):
        return [
            Property.sometimes("w0 done", lambda m, s: s[0] == 2),
            Property.always("w0 bounded", lambda m, s: s[0] <= 2),
        ]


class ToggleTensor(TensorModel):
    def __init__(self, sys: "ToggleSys"):
        self.model = sys
        self.packer = BitPacker([("x", 1), ("y", 1)])
        self.width = 1
        self.max_actions = 2

    def init_rows(self):
        return np.zeros((1, 1), np.uint64)

    def encode_state(self, s):
        return self.packer.pack(x=s[0], y=s[1])

    def decode_state(self, row):
        f = self.packer.unpack(row)
        return (f["x"], f["y"])

    def step_rows(self, rows):
        pk = self.packer
        x = pk.get(rows, "x")
        y = pk.get(rows, "y")
        s_a = pk.set(rows, "x", x ^ 1)
        v_a = torch.ones(rows.shape[:-1], dtype=torch.bool,
                         device=rows.device)
        s_b = pk.set(rows, "y", 1)
        v_b = y == 0
        return torch.stack([s_a, s_b], -2), torch.stack([v_a, v_b], -1)

    def property_masks(self, rows):
        y = self.packer.get(rows, "y")
        # the always-property also reads ONLY y: the toggle action stays
        # invisible, and the never-discovered always keeps the crawl from
        # exiting once "y set" is found
        return torch.stack([y == 1, y <= 1], -1)


@dataclass(frozen=True)
class ToggleSys(TensorBackedModel, Model):
    """A toggle cycle (invisible) racing a visible one-shot set."""

    def tensor_model(self):
        return ToggleTensor(self)

    def init_states(self):
        return [(0, 0)]

    def actions(self, s):
        return ["toggle"] + (["set"] if s[1] == 0 else [])

    def next_state(self, s, a):
        if a == "toggle":
            return (1 - s[0], s[1])
        return (s[0], 1)

    def properties(self):
        return [
            Property.sometimes("y set", lambda m, s: s[1] == 1),
            Property.always("y bounded", lambda m, s: s[1] <= 1),
        ]

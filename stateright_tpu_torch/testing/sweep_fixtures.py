"""A parametric model family for sweeps: the lifted cohort's fixture.

The port's copy of the JAX package's ``tests/fixtures_sweep.py``, kept in
the package so both the tests and ``chip_smoke.py`` can run it.
``BoundedCounterSys(bound, counters)`` is ``counters`` independent
counters, each incrementable up to ``bound``.  Its *bound* is twin data:
every member shares one row layout and one kernel structure, and the
bound appears in the captured aten graph as a scalar argument
(``aten.lt.Scalar(v, bound)``, ``aten.ge.Scalar(vals, bound)``), so a
family of bounds exercises the cohort unifier's scalar lifting: one
program, per-member state spaces of ``(bound + 1) ^ counters`` states and
depth ``counters * bound``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Expectation, Model, Property
from ..parallel.tensor_model import BitPacker, TensorBackedModel, TensorModel

_BITS = 6  # one field width: bounds up to 63 share one layout


class BoundedCounterTensor(TensorModel):
    def __init__(self, model: "BoundedCounterSys"):
        self.model = model
        self.n = model.n
        self.bound = model.bound
        self.pk = BitPacker([(f"c{i}", _BITS) for i in range(self.n)])
        self.width = self.pk.width
        self.max_actions = self.n

    def init_rows(self) -> np.ndarray:
        return np.asarray(
            [self.encode_state(s) for s in self.model.init_states()],
            np.uint64,
        )

    def encode_state(self, state) -> tuple:
        return self.pk.pack(**{f"c{i}": v for i, v in enumerate(state)})

    def decode_state(self, row):
        d = self.pk.unpack(row)
        return tuple(d[f"c{i}"] for i in range(self.n))

    def step_rows(self, rows):
        succs, valids = [], []
        for i in range(self.n):
            v = self.pk.get(rows, f"c{i}")
            # the bound is per-member twin data: a scalar argument of the
            # captured graph, which the cohort unifier lifts
            ok = v < self.bound
            succs.append(self.pk.set(rows, f"c{i}", torch.where(ok, v + 1, v)))
            valids.append(ok)
        return torch.stack(succs, -2), torch.stack(valids, -1)

    def property_masks(self, rows):
        vals = torch.stack([self.pk.get(rows, f"c{i}") for i in range(self.n)],
                           -1)
        maxed = (vals >= self.bound).any(-1)
        over = (vals > (1 << _BITS) - 1).any(-1)
        return torch.stack([~over, maxed], -1)


class BoundedCounterSys(TensorBackedModel, Model):
    """``counters`` independent counters, each incrementable to ``bound``;
    "in range" always holds, and "some counter maxed" is a sometimes
    example found at depth ``bound``."""

    def __init__(self, bound: int, counters: int = 2):
        if not 1 <= bound <= (1 << _BITS) - 1:
            raise ValueError(f"bound must be in 1..{(1 << _BITS) - 1}")
        self.bound = int(bound)
        self.n = int(counters)

    def properties(self):
        return [
            Property(Expectation.ALWAYS, "in range",
                     lambda m, s: all(v <= m.bound for v in s)),
            Property(Expectation.SOMETIMES, "some counter maxed",
                     lambda m, s: any(v >= m.bound for v in s)),
        ]

    def init_states(self):
        return [tuple(0 for _ in range(self.n))]

    def actions(self, state):
        return [i for i in range(self.n) if state[i] < self.bound]

    def next_state(self, state, action):
        out = list(state)
        out[action] += 1
        return tuple(out)

    def tensor_model(self):
        return BoundedCounterTensor(self)


def bounded_counter_spec(bounds, counters: int = 2, seeds=None):
    """One member ``bc-b<bound>`` per bound, in order, with optional
    per-member table seeds."""
    from ..sweep import SweepInstance, SweepSpec

    return SweepSpec([
        SweepInstance(
            f"bc-b{b}", BoundedCounterSys(b, counters),
            params={"bound": int(b), "counters": int(counters)},
            seed=(seeds[i] if seeds is not None else 0),
        )
        for i, b in enumerate(bounds)
    ])

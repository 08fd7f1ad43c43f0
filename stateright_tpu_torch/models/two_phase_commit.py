"""Two-phase commit, after the Gray/Lamport TLA+ model "Consensus on
Transaction Commit" (reference ``examples/2pc.rs``).

The port's counterpart of ``stateright_tpu/models/two_phase_commit.py``:
the same object model (``TwoPhaseState``/``TwoPhaseSys``) and the same row
encoding, with the device twin :class:`TwoPhaseTensor` written in PyTorch.
Both forms agree on fingerprints bit for bit, and with the JAX twin.

Pinned counts (reference ``examples/2pc.rs:125-140``): 288 unique / 1,146
states @ 3 RMs, 8,832 unique @ 5 RMs, 296,448 unique @ 7 RMs.

Run: ``python -m stateright_tpu_torch.models.two_phase_commit check-gpu 7``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..core import Model, Property
from ..parallel.tensor_model import (
    BitPacker,
    FieldWriter,
    TensorBackedModel,
    TensorModel,
)

# RM states
WORKING = "working"
PREPARED = "prepared"
COMMITTED = "committed"
ABORTED = "aborted"

# TM states
TM_INIT = "init"
TM_COMMITTED = "committed"
TM_ABORTED = "aborted"


@dataclass(frozen=True)
class TwoPhaseState:
    rm_state: tuple  # one of the RM states per RM
    tm_state: str
    tm_prepared: tuple  # bool per RM
    msgs: frozenset  # ("prepared", rm) | ("commit",) | ("abort",)


@dataclass
class TwoPhaseSys(TensorBackedModel, Model):
    """Abstract 2PC over ``rm_count`` resource managers
    (reference ``2pc.rs:43-121``)."""

    rm_count: int

    def tensor_model(self) -> "TwoPhaseTensor":
        return TwoPhaseTensor(self)

    def init_states(self):
        n = self.rm_count
        return [
            TwoPhaseState(
                rm_state=(WORKING,) * n,
                tm_state=TM_INIT,
                tm_prepared=(False,) * n,
                msgs=frozenset(),
            )
        ]

    def actions(self, state: TwoPhaseState):
        acts = []
        if state.tm_state == TM_INIT and all(state.tm_prepared):
            acts.append(("tm_commit",))
        if state.tm_state == TM_INIT:
            acts.append(("tm_abort",))
        for rm in range(self.rm_count):
            if state.tm_state == TM_INIT and ("prepared", rm) in state.msgs:
                acts.append(("tm_rcv_prepared", rm))
            if state.rm_state[rm] == WORKING:
                acts.append(("rm_prepare", rm))
                acts.append(("rm_choose_abort", rm))
            if ("commit",) in state.msgs:
                acts.append(("rm_rcv_commit", rm))
            if ("abort",) in state.msgs:
                acts.append(("rm_rcv_abort", rm))
        return acts

    def next_state(self, state: TwoPhaseState, action) -> Optional[TwoPhaseState]:
        kind = action[0]
        if kind == "tm_rcv_prepared":
            rm = action[1]
            prepared = list(state.tm_prepared)
            prepared[rm] = True
            return replace(state, tm_prepared=tuple(prepared))
        if kind == "tm_commit":
            return replace(
                state, tm_state=TM_COMMITTED, msgs=state.msgs | {("commit",)}
            )
        if kind == "tm_abort":
            return replace(
                state, tm_state=TM_ABORTED, msgs=state.msgs | {("abort",)}
            )
        rm = action[1]
        rm_state = list(state.rm_state)
        if kind == "rm_prepare":
            rm_state[rm] = PREPARED
            return replace(
                state,
                rm_state=tuple(rm_state),
                msgs=state.msgs | {("prepared", rm)},
            )
        if kind == "rm_choose_abort":
            rm_state[rm] = ABORTED
        elif kind == "rm_rcv_commit":
            rm_state[rm] = COMMITTED
        elif kind == "rm_rcv_abort":
            rm_state[rm] = ABORTED
        else:
            raise ValueError(action)
        return replace(state, rm_state=tuple(rm_state))

    def properties(self):
        return [
            Property.sometimes(
                "abort agreement",
                lambda m, s: all(x == ABORTED for x in s.rm_state),
            ),
            Property.sometimes(
                "commit agreement",
                lambda m, s: all(x == COMMITTED for x in s.rm_state),
            ),
            Property.always(
                "consistent",
                lambda m, s: not (
                    ABORTED in s.rm_state and COMMITTED in s.rm_state
                ),
            ),
        ]


# ---------------------------------------------------------------------------
# Tensor form (device twin)
# ---------------------------------------------------------------------------

# Numeric RM-state codes for the row encoding.
_RM_CODE = {WORKING: 0, PREPARED: 1, COMMITTED: 2, ABORTED: 3}
_RM_NAME = {v: k for k, v in _RM_CODE.items()}
_TM_CODE = {TM_INIT: 0, TM_COMMITTED: 1, TM_ABORTED: 2}
_TM_NAME = {v: k for k, v in _TM_CODE.items()}


class TwoPhaseTensor(TensorModel):
    """Row encoding of :class:`TwoPhaseState` with a static-arity batched
    transition, word for word the JAX twin's.

    Layout (word-aligned by :class:`BitPacker`): ``rm`` packs 2 bits per RM;
    ``tm`` 2 bits; ``tm_prepared`` / ``msg_prepared`` one bit per RM;
    ``msg_commit`` / ``msg_abort`` one bit each.

    Static action arity A = 2 + 5·rm_count, slots ordered:
    ``tm_commit, tm_abort,`` then per RM ``tm_rcv_prepared, rm_prepare,
    rm_choose_abort, rm_rcv_commit, rm_rcv_abort``.
    """

    def __init__(self, sys: TwoPhaseSys):
        n = sys.rm_count
        if n > 29:
            raise ValueError("tensor 2PC supports up to 29 RMs per word")
        self.model = sys
        self.n = n
        self.packer = BitPacker(
            [
                ("rm", 2 * n),
                ("tm", 2),
                ("tm_prepared", n),
                ("msg_prepared", n),
                ("msg_commit", 1),
                ("msg_abort", 1),
            ]
        )
        self.width = self.packer.width
        self.max_actions = 2 + 5 * n

    # -- host bridge ---------------------------------------------------------

    def encode_state(self, s: TwoPhaseState) -> tuple:
        rm = 0
        for i, st in enumerate(s.rm_state):
            rm |= _RM_CODE[st] << (2 * i)
        prep = sum(1 << i for i, p in enumerate(s.tm_prepared) if p)
        mprep = sum(1 << m[1] for m in s.msgs if m[0] == "prepared")
        return self.packer.pack(
            rm=rm,
            tm=_TM_CODE[s.tm_state],
            tm_prepared=prep,
            msg_prepared=mprep,
            msg_commit=int(("commit",) in s.msgs),
            msg_abort=int(("abort",) in s.msgs),
        )

    def decode_state(self, row) -> TwoPhaseState:
        f = self.packer.unpack(row)
        n = self.n
        msgs = set()
        for i in range(n):
            if (f["msg_prepared"] >> i) & 1:
                msgs.add(("prepared", i))
        if f["msg_commit"]:
            msgs.add(("commit",))
        if f["msg_abort"]:
            msgs.add(("abort",))
        return TwoPhaseState(
            rm_state=tuple(_RM_NAME[(f["rm"] >> (2 * i)) & 3] for i in range(n)),
            tm_state=_TM_NAME[f["tm"]],
            tm_prepared=tuple(bool((f["tm_prepared"] >> i) & 1) for i in range(n)),
            msgs=frozenset(msgs),
        )

    def init_rows(self) -> np.ndarray:
        rows = [self.encode_state(s) for s in self.model.init_states()]
        return np.asarray(rows, dtype=np.uint64)

    # -- device --------------------------------------------------------------

    def step_rows(self, rows: torch.Tensor):
        pk, n = self.packer, self.n
        rm = pk.get(rows, "rm")
        tm = pk.get(rows, "tm")
        prep = pk.get(rows, "tm_prepared")
        mprep = pk.get(rows, "msg_prepared")
        mc = pk.get(rows, "msg_commit")
        ma = pk.get(rows, "msg_abort")

        tm_init = tm == 0
        all_prepared = prep == (1 << n) - 1

        succs, valids = [], []

        def emit(valid, fw):
            valids.append(valid)
            succs.append(fw.done())

        def w():  # one writer per action, all reads come from `rows`
            return FieldWriter(pk, rows)

        # tm_commit / tm_abort
        emit(tm_init & all_prepared, w().set("tm", 1).set("msg_commit", 1))
        emit(tm_init, w().set("tm", 2).set("msg_abort", 1))

        for i in range(n):
            bit = 1 << i
            rm_i = (rm >> (2 * i)) & 3
            rm_clear = rm & (~(3 << (2 * i)) & ((1 << (2 * n)) - 1))

            # tm_rcv_prepared(i)
            emit(
                tm_init & (((mprep >> i) & 1) == 1),
                w().set("tm_prepared", prep | bit),
            )
            # rm_prepare(i): rm working -> prepared + send prepared msg
            emit(
                rm_i == 0,
                w().set("rm", rm_clear | (1 << (2 * i)))
                .set("msg_prepared", mprep | bit),
            )
            # rm_choose_abort(i)
            emit(rm_i == 0, w().set("rm", rm_clear | (3 << (2 * i))))
            # rm_rcv_commit(i)
            emit(mc == 1, w().set("rm", rm_clear | (2 << (2 * i))))
            # rm_rcv_abort(i)
            emit(ma == 1, w().set("rm", rm_clear | (3 << (2 * i))))

        succ = torch.stack(succs, dim=-2)  # [B, A, W]
        valid = torch.stack(valids, dim=-1)  # [B, A]
        return succ, valid

    def property_masks(self, rows: torch.Tensor) -> torch.Tensor:
        pk, n = self.packer, self.n
        rm = pk.get(rows, "rm")
        all_aborted = rm == (1 << (2 * n)) - 1  # 0b11 per RM
        all_committed = rm == int("10" * n, 2)  # 0b10 per RM
        any_committed = torch.zeros(rows.shape[:-1], dtype=torch.bool,
                                    device=rows.device)
        any_aborted = torch.zeros_like(any_committed)
        for i in range(n):
            rm_i = (rm >> (2 * i)) & 3
            any_committed |= rm_i == 2
            any_aborted |= rm_i == 3
        consistent = ~(any_committed & any_aborted)
        # order matches TwoPhaseSys.properties()
        return torch.stack([all_aborted, all_committed, consistent], dim=-1)


def main(argv=None) -> int:
    from ._cli import check_gpu_main

    return check_gpu_main(
        "two_phase_commit", "[RESOURCE_MANAGER_COUNT]", argv,
        lambda rest: TwoPhaseSys(int(rest[0]) if rest else 2),
        lambda rest: ("Checking two phase commit with "
                      f"{int(rest[0]) if rest else 2} RMs on the GPU."),
        max_args=1,
    )


if __name__ == "__main__":
    sys.exit(main())

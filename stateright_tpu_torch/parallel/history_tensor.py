"""Device-side linearizability verdicts for register histories.

The port's counterpart of ``stateright_tpu/parallel/history_tensor.py``:
:func:`closure_verdict`, the verdict the paxos twin evaluates on every
popped row, :class:`LinHistoryCodec`, the ``put_count=1`` history codec
the actor compiler (``parallel/actor_compiler.py``) packs into its rows,
and :class:`MultiOpLinHistoryCodec`, its ``put_count >= 2`` counterpart.

The joint tester state of the ``put_count=1`` register workload is small
and enumerable.  Per thread it is three fields (2 + 2·(C−1) + 3 bits):

 - ``phase``: 0 = write in flight, 1 = read in flight, 2 = read returned,
   3 = write returned / read not yet invoked (only an intermediate of the
   event enumeration: the client invokes its read in the same transition
   that returns its write);
 - ``snap``: the read-invocation snapshot — for each other thread, the
   number of operations it had completed (0..2), 2 bits each;
 - ``rval``: the index of the value the read returned (0 = the register's
   null value, 1.. = client values), once phase = 2.

Two strategies turn those fields into the ``linearizable`` verdict:

 - **closure** (every write returns ``write_ok``): :func:`closure_verdict`
   on the fields, no enumeration;
 - **table** (a write may also return ``write_fail``): every joint tester
   state reachable under any interleaving of invoke/return events is
   enumerated on the host, its exact verdict taken once, and the sorted
   packed keys (at most 4 threads × 11 bits = 44 bits, so ``int64`` order
   is unsigned order) with their verdicts go to the device, where the
   lookup is one ``torch.searchsorted`` and a gather.

Why the reduction is exact (``put_count=1`` register workload): every
client invokes its write at start (so writes have no prerequisites and no
write→write real-time order), in-flight ops may always be left
unserialized, and each completed read R_i must sit immediately after its
dictating write W_d(i) (unique values).  A serialization therefore exists
iff some permutation π of the writes satisfies π(k) ≤ π(d(i)) for every
write k completed before R_i's invocation (plus k = i), and π(d(j)) ≤
π(d(i)) for every read R_j completed before R_i's invocation — strict edges
between distinct writes, so a valid π exists iff the edge graph is acyclic.
A completed read returning the null value is always a violation (its own
write precedes it).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..semantics import LinearizabilityTester
from ..semantics.register import READ, Register, write

PHASE_W_INFLIGHT = 0
PHASE_R_INFLIGHT = 1
PHASE_DONE = 2
PHASE_W_DONE = 3

#: thread cap for the enumerated-table strategy (63-bit key width)
MAX_THREADS = 4
#: thread cap for the closure strategy (3-bit rval field: <= 7 client values)
MAX_THREADS_CLOSURE = 7


def closure_verdict(done: torch.Tensor, s: torch.Tensor,
                    rvals: torch.Tensor) -> torch.Tensor:
    """Plain-register (put_count=1, unique values) linearizability verdict
    as a write-precedence-graph acyclicity check.

    ``done``  [..., C] bool — thread i's read has completed;
    ``s``     [..., C, C] int — ops thread j had completed when thread i's
              read was invoked (diagonal ignored);
    ``rvals`` [..., C] int — value index thread i's read returned
              (0 = null/initial, 1.. = thread value), meaningful where done.
    Returns [...] bool.  O(C^3 log C) boolean work per state.
    """
    C = done.shape[-1]
    batch = done.shape[:-1]
    null_read = (done & (rvals == 0)).any(dim=-1)
    d = (rvals - 1).clamp(0, C - 1).long()  # dictating writer per read

    eye = torch.eye(C, dtype=torch.bool, device=done.device)
    d_oh = eye[d]  # [..., C, C]: d_oh[..., i, :] = one-hot of d(i)
    edges = torch.zeros(batch + (C, C), dtype=torch.bool, device=done.device)
    for i in range(C):
        di = d_oh[..., i, :]  # [..., C] target one-hot
        gate = done[..., i, None, None]
        # writes that must precede R_i: its own, plus every write
        # completed before R_i's invocation -> edge k -> d(i)
        pre = (s[..., i, :] >= 1) | eye[i]
        edges = edges | (gate & pre[..., :, None] & di[..., None, :])
        # reads completed before R_i's invocation: R_j < R_i forces
        # window order -> edge d(j) -> d(i)
        rr = (s[..., i, :] == 2) & done  # [..., C] over j
        src = (rr[..., :, None] & d_oh).any(dim=-2)  # [..., C]
        edges = edges | (gate & src[..., :, None] & di[..., None, :])
    edges = edges & ~eye  # k == d(i) cases are vacuous, not cycles

    # transitive closure by squaring; cycle <=> any diagonal entry
    reach = edges
    for _ in range(max(1, (C - 1).bit_length())):
        reach = reach | (reach[..., :, :, None] & reach[..., None, :, :]).any(
            dim=-2
        )
    cycle = (reach & eye).any(dim=-1).any(dim=-1)
    return ~(null_read | cycle)


class _TableCodecBase:
    """Value/thread/slot coding, per-thread key packing and the sorted-table
    device lookup (``stateright_tpu``'s ``_TableCodecBase``)."""

    def _thread_index(self, t) -> int:
        return self.threads.index(int(t))

    def _snap_slot(self, i: int, j: int) -> int:
        """Bit-slot of peer ``j`` inside thread ``i``'s snapshot field
        (peers are numbered skipping ``i`` itself)."""
        return j if j < i else j - 1

    def _value_code(self, v) -> int:
        return 0 if v == self.null_value else self.values.index(v) + 1

    def _value_decode(self, code: int):
        return self.null_value if code == 0 else self.values[code - 1]

    def key_of_fields(self, fields: list) -> int:
        """Per-thread field tuples -> packed joint key."""
        key = 0
        for i, f in enumerate(fields):
            key |= self.pack_thread(*f) << (i * self.thread_bits)
        return key

    def ensure_table(self) -> None:
        if not self._table_built:
            self._enumerate(self._max_states)
            self._table_built = True

    def _table_on(self, device):
        """The (keys, verdicts) table as tensors on ``device``, built once
        per device."""
        self.ensure_table()
        t = self._table_dev.get(device)
        if t is None:
            t = (torch.from_numpy(self.table_keys).to(device),
                 torch.from_numpy(self.table_ok).to(device))
            self._table_dev[device] = t
        return t

    def device_lookup(self, keys: torch.Tensor) -> torch.Tensor:
        """Verdicts by binary search over the sorted key table.  Keys absent
        from the table (combinations no interleaving can produce) are
        False."""
        tk, ok = self._table_on(keys.device)
        idx = torch.searchsorted(tk, keys.contiguous()).clamp_(
            max=tk.shape[0] - 1)
        return ok[idx] & (tk[idx] == keys)


class LinHistoryCodec(_TableCodecBase):
    """Host+device codec for the joint linearizability-tester state of a
    ``put_count=1`` register workload.

    ``strategy`` is ``"closure"`` for plain-register workloads (every write
    returns ``write_ok``): :meth:`device_verdict` computes the verdict with
    no enumeration.  Workloads where a write may return ``write_fail`` use
    ``"table"``: every reachable joint tester state is enumerated on the
    host, and :meth:`device_lookup` reads its verdict."""

    def __init__(
        self,
        threads: list,
        values: list,
        null_value,
        tester_factory=None,
        max_states: int = 2_000_000,
        write_rets: tuple = (("write_ok",),),
    ):
        self.write_rets = tuple(tuple(r) for r in write_rets)
        self.strategy = (
            "closure" if self.write_rets == (("write_ok",),) else "table"
        )
        cap = MAX_THREADS_CLOSURE if self.strategy == "closure" else MAX_THREADS
        if len(threads) > cap:
            raise ValueError(
                f"at most {cap} client threads supported for the "
                f"{self.strategy} strategy (got {len(threads)})"
            )
        self.threads = [int(t) for t in threads]
        self.values = list(values)  # values[i] is thread i's written value
        self.null_value = null_value
        self.C = C = len(threads)
        self.phase_bits = 2
        self.snap_bits = 2 * (C - 1)
        self.rval_bits = 3
        # one extra bit per thread when a write can fail: which of the two
        # write returns completed the op
        self.wfail_bits = 1 if len(self.write_rets) > 1 else 0
        self.thread_bits = (
            self.phase_bits + self.snap_bits + self.rval_bits + self.wfail_bits
        )
        if tester_factory is None:
            tester_factory = lambda: LinearizabilityTester(Register(null_value))
        self._tester_factory = tester_factory
        self._max_states = max_states
        self._table_dev: dict = {}
        # built lazily: the closure strategy never needs the table, and the
        # enumeration is super-exponential in C
        self._table_built = False
        if self.strategy == "table":
            self.ensure_table()

    # -- field packing (host ints; the device mirrors this) ------------------

    def pack_thread(
        self, phase: int, snap: int, rval: int, wfail: int = 0
    ) -> int:
        return (
            phase
            | (snap << self.phase_bits)
            | (rval << (self.phase_bits + self.snap_bits))
            | (wfail << (self.phase_bits + self.snap_bits + self.rval_bits))
        )

    # -- tester <-> fields ---------------------------------------------------

    def fields_of_tester(self, tester: LinearizabilityTester) -> list:
        """Per-thread ``(phase, snap, rval, wfail)`` of a tester state.
        Raises if the tester is not a state this workload can produce."""
        if not tester.valid:
            raise ValueError("invalid (protocol-misuse) tester state")
        fields = []
        for i, t in enumerate(self.threads):
            completed = tester.history_by_thread.get(t, ())
            in_flight = tester.in_flight_by_thread.get(t)
            w_expect = write(self.values[i])
            snap_src = None
            rval = 0
            wfail = 0
            if len(completed) == 0:
                if in_flight is None or in_flight[1] != w_expect:
                    raise ValueError(f"thread {t}: expected write in flight")
                phase = PHASE_W_INFLIGHT
            else:
                if completed[0][1] != w_expect or completed[0][
                    2
                ] not in self.write_rets:
                    raise ValueError(f"thread {t}: unexpected first op")
                wfail = int(completed[0][2] == ("write_fail",))
                if len(completed) == 2:
                    snap_src, op, ret = completed[1]
                    if op != READ or ret[0] != "read_ok":
                        raise ValueError(f"thread {t}: unexpected second op")
                    rval = self._value_code(ret[1])
                    phase = PHASE_DONE
                elif in_flight is not None:
                    snap_src, op = in_flight
                    if op != READ:
                        raise ValueError(f"thread {t}: unexpected in-flight op")
                    phase = PHASE_R_INFLIGHT
                else:
                    phase = PHASE_W_DONE
            snap = 0
            if snap_src is not None:
                for peer, idx in snap_src:
                    j = self._thread_index(peer)
                    snap |= (idx + 1) << (2 * self._snap_slot(i, j))
            fields.append((phase, snap, rval, wfail))
        return fields

    def tester_of_fields(self, fields: list) -> LinearizabilityTester:
        history: dict = {}
        in_flight: dict = {}
        for i, f in enumerate(fields):
            phase, snap, rval = f[0], f[1], f[2]
            wfail = f[3] if len(f) > 3 else 0
            t = self.threads[i]
            w_ret = ("write_fail",) if wfail else ("write_ok",)
            w_complete = ((), write(self.values[i]), w_ret)
            snap_t = tuple(
                sorted(
                    (self.threads[j],
                     ((snap >> (2 * self._snap_slot(i, j))) & 3) - 1)
                    for j in range(self.C)
                    if j != i and (snap >> (2 * self._snap_slot(i, j))) & 3
                )
            )
            if phase == PHASE_W_INFLIGHT:
                history[t] = ()
                in_flight[t] = ((), write(self.values[i]))
            elif phase == PHASE_W_DONE:
                history[t] = (w_complete,)
            elif phase == PHASE_R_INFLIGHT:
                history[t] = (w_complete,)
                in_flight[t] = (snap_t, READ)
            else:
                history[t] = (
                    w_complete,
                    (snap_t, READ, ("read_ok", self._value_decode(rval))),
                )
        tester = self._tester_factory()
        return type(tester)(
            tester.init_ref_obj, history, in_flight, valid=True
        )

    # -- enumeration ---------------------------------------------------------

    def _enumerate(self, max_states: int) -> None:
        """BFS over invoke/return events; a superset of the joint tester
        states the protocol can reach."""
        init = self._tester_factory()
        for i, t in enumerate(self.threads):
            init = init.on_invoke(t, write(self.values[i]))
        seen = {init}
        queue = deque([init])
        read_rets = [("read_ok", self.null_value)] + [
            ("read_ok", v) for v in self.values
        ]
        while queue:
            tester = queue.popleft()
            if len(seen) > max_states:
                raise RuntimeError(
                    f"joint tester enumeration exceeded {max_states} states"
                )
            for t in self.threads:
                in_flight = tester.in_flight_by_thread.get(t)
                completed = tester.history_by_thread.get(t, ())
                if in_flight is not None:
                    op = in_flight[1]
                    if op == READ:
                        succs = [tester.on_return(t, r) for r in read_rets]
                    else:
                        succs = [
                            tester.on_return(t, r) for r in self.write_rets
                        ]
                elif len(completed) == 1:
                    succs = [tester.on_invoke(t, READ)]
                else:
                    continue
                for s in succs:
                    if s not in seen:
                        seen.add(s)
                        queue.append(s)

        keys = np.empty(len(seen), np.int64)
        oks = np.empty(len(seen), bool)
        for n, tester in enumerate(seen):
            keys[n] = self.key_of_fields(self.fields_of_tester(tester))
            oks[n] = tester.is_consistent()
        order = np.argsort(keys, kind="stable")
        self.table_keys = keys[order]
        self.table_ok = oks[order]

    # -- device --------------------------------------------------------------

    def device_key(self, phases, snaps, rvals, wfails=None) -> torch.Tensor:
        """Pack per-thread field tensors (each ``[..., C]`` int64) into keys,
        mirroring :meth:`key_of_fields`."""
        key = torch.zeros(phases.shape[:-1], dtype=torch.int64,
                          device=phases.device)
        for i in range(self.C):
            word = (
                phases[..., i]
                | (snaps[..., i] << self.phase_bits)
                | (rvals[..., i] << (self.phase_bits + self.snap_bits))
            )
            if wfails is not None and self.wfail_bits:
                word = word | (
                    wfails[..., i]
                    << (self.phase_bits + self.snap_bits + self.rval_bits)
                )
            key = key | (word << (i * self.thread_bits))
        return key

    def device_verdict(self, phases, snaps, rvals) -> torch.Tensor:
        """Closure-strategy verdict per row: each input is ``[..., C]``
        int64 (the per-thread row fields); returns ``[...]`` bool.  Decodes
        the packed snapshot fields into the completion-count matrix for
        :func:`closure_verdict`.  Exact for the plain-register workload
        only: a failed write takes no effect, which breaks the
        reads-dictate-writes reduction, so write-fail workloads use
        :meth:`device_lookup`."""
        if self.strategy != "closure":
            raise ValueError(
                "device_verdict is only exact for the plain-register "
                "workload; this codec's strategy is " + self.strategy
            )
        C = self.C
        done = phases == PHASE_DONE  # [..., C] completed reads
        # s[..., i, j] = ops thread j had completed when R_i was invoked
        zero = torch.zeros_like(phases[..., 0])
        s = torch.stack([
            torch.stack([
                zero if j == i
                else (snaps[..., i] >> (2 * self._snap_slot(i, j))) & 3
                for j in range(C)
            ], dim=-1)
            for i in range(C)
        ], dim=-2)
        return closure_verdict(done, s, rvals)


class MultiOpLinHistoryCodec(_TableCodecBase):
    """Host+device codec for ``put_count >= 2`` register workloads
    (reference ``src/actor/register.rs:96,178-186``: each client performs
    ``put_count`` writes then one read, every op invoked in the same
    transition that returns its predecessor).

    Per-thread packed fields:

     - ``phase`` = ``2*completed + in_flight``: ``completed`` ops have
       returned (0..K+1) and the next op is in flight or not.  Stored
       states always have an op in flight until the read returns, so
       stored phases are odd, plus the final ``2*(K+1)``; even
       intermediates appear only inside the event enumeration.
     - ``snap[m]`` for ``m`` in ``0..K-1``: the invocation snapshot of op
       ``m+2`` (op 1 is invoked at start with an empty snapshot): per
       peer, how many ops it had completed, ``ceil(log2(K+2))`` bits
       each.  Write invocations carry real-time snapshots here too.
     - ``rval``: index of the value the read returned (0 = null).

    Only the table strategy exists: every reachable joint tester state is
    enumerated on the host through the real
    :class:`~stateright_tpu_torch.semantics.LinearizabilityTester`, and the
    sorted keys with their exact verdicts go to the device
    (:meth:`device_lookup`)."""

    def __init__(
        self,
        threads: list,
        scripts: list,
        null_value,
        tester_factory=None,
        max_states: int = 2_000_000,
    ):
        self.threads = [int(t) for t in threads]
        self.scripts = [list(s) for s in scripts]  # per-thread write values
        if not self.scripts or any(len(s) < 1 for s in self.scripts):
            raise ValueError("every thread needs at least one write")
        self.null_value = null_value
        self.C = C = len(threads)
        self.K = K = max(len(s) for s in self.scripts)
        if any(len(s) != K for s in self.scripts):
            raise ValueError("per-thread put_counts must be uniform")
        # distinct written values, first-appearance order, code 1..V
        self.values: list = []
        for s in self.scripts:
            for v in s:
                if v not in self.values:
                    self.values.append(v)
        self.phase_bits = max(1, int(np.ceil(np.log2(2 * (K + 1) + 1))))
        self.snap_entry_bits = max(1, int(np.ceil(np.log2(K + 2))))
        self.snap_bits = self.snap_entry_bits * max(1, C - 1)
        self.rval_bits = max(3, int(np.ceil(np.log2(len(self.values) + 2))))
        self.thread_bits = self.phase_bits + K * self.snap_bits + self.rval_bits
        if C * self.thread_bits > 62:
            raise ValueError(
                f"joint key needs {C * self.thread_bits} bits (> 62): "
                f"too many clients/ops for the table strategy "
                f"(C={C}, put_count={K})"
            )
        self.strategy = "table"
        self.wfail_bits = 0  # write-once workloads are K=1-only
        if tester_factory is None:
            tester_factory = lambda: LinearizabilityTester(Register(null_value))
        self._tester_factory = tester_factory
        self._max_states = max_states
        self._table_dev: dict = {}
        self._table_built = False
        self.ensure_table()

    def _ops(self, i: int) -> list:
        """Thread ``i``'s full op script: K writes then the read."""
        return [write(v) for v in self.scripts[i]] + [READ]

    # -- packing -------------------------------------------------------------

    def pack_thread(self, phase: int, snaps: tuple, rval: int) -> int:
        word = phase
        off = self.phase_bits
        for m in range(self.K):
            word |= (snaps[m] if m < len(snaps) else 0) << off
            off += self.snap_bits
        word |= rval << off
        return word

    def _snap_of(self, i: int, snap_src) -> int:
        snap = 0
        for peer, idx in snap_src:
            j = self._thread_index(peer)
            snap |= (idx + 1) << (
                self.snap_entry_bits * self._snap_slot(i, j)
            )
        return snap

    # -- tester <-> fields ---------------------------------------------------

    def fields_of_tester(self, tester: LinearizabilityTester) -> list:
        """Per-thread ``(phase, snaps, rval)`` of a tester state."""
        if not tester.valid:
            raise ValueError("invalid (protocol-misuse) tester state")
        fields = []
        for i, t in enumerate(self.threads):
            ops = self._ops(i)
            completed = tester.history_by_thread.get(t, ())
            in_flight = tester.in_flight_by_thread.get(t)
            j = len(completed)
            snaps = [0] * self.K
            rval = 0
            for m, (snap_src, op, ret) in enumerate(completed):
                if op != ops[m]:
                    raise ValueError(f"thread {t}: op {m} mismatch")
                if m >= 1:
                    snaps[m - 1] = self._snap_of(i, snap_src)
                if op == READ:
                    if ret[0] != "read_ok":
                        raise ValueError(f"thread {t}: bad read return")
                    rval = self._value_code(ret[1])
                elif ret != ("write_ok",):
                    raise ValueError(f"thread {t}: bad write return")
            if in_flight is not None:
                if j >= len(ops) or in_flight[1] != ops[j]:
                    raise ValueError(f"thread {t}: unexpected in-flight op")
                if j >= 1:
                    snaps[j - 1] = self._snap_of(i, in_flight[0])
                phase = 2 * j + 1
            else:
                phase = 2 * j
            fields.append((phase, tuple(snaps), rval))
        return fields

    def _snap_tuple(self, i: int, snaps: tuple, m: int) -> tuple:
        """The invocation snapshot of thread ``i``'s op ``m`` (0-based; op
        0 is invoked at start with an empty snapshot)."""
        if m == 0:
            return ()
        raw = snaps[m - 1]
        eb = self.snap_entry_bits
        out = []
        for p in range(self.C):
            if p == i:
                continue
            v = (raw >> (eb * self._snap_slot(i, p))) & ((1 << eb) - 1)
            if v:
                out.append((self.threads[p], v - 1))
        return tuple(sorted(out))

    def tester_of_fields(self, fields: list) -> LinearizabilityTester:
        history: dict = {}
        in_flight: dict = {}
        for i, (phase, snaps, rval) in enumerate(fields):
            t = self.threads[i]
            ops = self._ops(i)
            j, fl = phase >> 1, phase & 1
            hist = []
            for m in range(j):
                op = ops[m]
                ret = (
                    ("read_ok", self._value_decode(rval))
                    if op == READ
                    else ("write_ok",)
                )
                hist.append((self._snap_tuple(i, snaps, m), op, ret))
            history[t] = tuple(hist)
            if fl:
                in_flight[t] = (self._snap_tuple(i, snaps, j), ops[j])
        tester = self._tester_factory()
        return type(tester)(
            tester.init_ref_obj, history, in_flight, valid=True
        )

    # -- enumeration ---------------------------------------------------------

    def _enumerate(self, max_states: int) -> None:
        init = self._tester_factory()
        for i, t in enumerate(self.threads):
            init = init.on_invoke(t, write(self.scripts[i][0]))
        seen = {init}
        queue = deque([init])
        read_rets = [("read_ok", self.null_value)] + [
            ("read_ok", v) for v in self.values
        ]
        while queue:
            tester = queue.popleft()
            if len(seen) > max_states:
                raise RuntimeError(
                    f"joint tester enumeration exceeded {max_states} states"
                )
            for i, t in enumerate(self.threads):
                ops = self._ops(i)
                in_flight = tester.in_flight_by_thread.get(t)
                completed = tester.history_by_thread.get(t, ())
                if in_flight is not None:
                    rets = (
                        read_rets if in_flight[1] == READ else [("write_ok",)]
                    )
                    succs = [tester.on_return(t, r) for r in rets]
                elif len(completed) < len(ops):
                    succs = [tester.on_invoke(t, ops[len(completed)])]
                else:
                    continue
                for s in succs:
                    if s not in seen:
                        seen.add(s)
                        queue.append(s)
        keys = np.empty(len(seen), np.int64)
        oks = np.empty(len(seen), bool)
        for n, tester in enumerate(seen):
            keys[n] = self.key_of_fields(self.fields_of_tester(tester))
            oks[n] = tester.is_consistent()
        order = np.argsort(keys)
        self.table_keys = keys[order]
        self.table_ok = oks[order]

    # -- device --------------------------------------------------------------

    def device_key(self, phases, snaps, rvals, wfails=None) -> torch.Tensor:
        """``phases``/``rvals``: ``[..., C]`` int64; ``snaps``:
        ``[..., C, K]`` int64.  Packs int64 keys mirroring
        :meth:`key_of_fields` (at most 62 bits, so signed order is the
        table's order)."""
        key = torch.zeros(phases.shape[:-1], dtype=torch.int64,
                          device=phases.device)
        for i in range(self.C):
            word = phases[..., i]
            off = self.phase_bits
            for m in range(self.K):
                word = word | (snaps[..., i, m] << off)
                off += self.snap_bits
            word = word | (rvals[..., i] << off)
            key = key | (word << (i * self.thread_bits))
        return key

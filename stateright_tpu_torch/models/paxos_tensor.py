"""Tensor (device) twin of the Paxos register system — the benchmark model.

The port's counterpart of ``stateright_tpu/models/paxos_tensor.py``: the
same row layout, envelope codes and transition, word for word, with
``step_rows`` written in PyTorch on int64 bit patterns
(``ops/hashing.py``), its packed words assembled by the coalesced
:class:`FieldWriter` (JAX ``step_rows_coalesced``, :403 and :642).

Encodes the full :class:`~stateright_tpu_torch.actor.model.ActorModelState`
of ``paxos_model(C, 3)`` — three server actor states, C register clients,
the in-flight message multiset, and the linearizability-tester history —
into fixed-width 64-bit rows, with the complete protocol step (deliver →
handler → sends → history update) as one batched function.

 - **Network**: sorted-slot multiset (``parallel/actor_tensor.py``); one
   deliver action per slot, matching the object model's
   one-``Deliver``-per-distinct-envelope actions (``actor/model.py``).
 - **Message universe**: every Paxos message is determined by a handful of
   small fields (kind, src, dst, ballot round/leader, and an aux payload:
   a proposal's client index, a ``last_accepted`` code, or a read value),
   about 21 bits at C <= 3.  Request ids and values are derivable: client
   ``i``'s put is always ``Put(3+i, chr(65+i))`` and its get
   ``Get(2*(3+i))`` (``actor/register.py``).
 - **History**: with ``put_count=1`` clients, the linearizability tester's
   state is a function of (per-thread phase, read return value, and the
   read-invocation snapshot of peer completion counts).
 - **Linearizable property**: evaluated on the device by
   ``parallel/history_tensor.py::closure_verdict``.
 - **No-op pruning** parity: deliveries whose handler returns None with no
   sends are masked invalid, mirroring the object model's prune
   (reference ``model.rs:253-260``).

Each successor's packed words start from the parent's packed words only
(``rows[:, None, :pw]``): the slot words are rebuilt separately, so the
per-field writes never copy them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..actor import Id
from ..actor.model import ActorModelState
from ..actor.network import Envelope, UnorderedNonDuplicatingNetwork
from ..actor.register import NULL_VALUE, RegisterClientState
from ..parallel.actor_tensor import (
    _EMPTY,
    SlotCodec,
    slot_canonicalize,
    slot_codes,
    slot_counts,
    slot_occupied,
    slot_send,
)
from ..parallel.history_tensor import closure_verdict
from ..parallel.tensor_model import BitPacker, FieldWriter, TensorModel
from ..semantics.linearizability import LinearizabilityTester
from ..semantics.register import READ, Register, write

S = 3  # servers (the benchmark configuration is fixed at 3)

# message kinds
PUT, GET, PUT_OK, GET_OK = 1, 2, 3, 4
PREPARE, PREPARED, ACCEPT, ACCEPTED, DECIDED = 5, 6, 7, 8, 9

MAX_CLIENTS = 7  # 3-bit read-value code + the closure strategy's own cap

_SERVER_FIELDS = ("rnd", "ldr", "prop", "prep0", "prep1", "prep2", "acc",
                  "accd", "dec")


class PaxosTensor(TensorModel):
    """Device twin of ``paxos_model(client_count, 3)`` on an unordered
    non-duplicating network (the reference benchmark configuration,
    ``examples/paxos.rs:323-338``)."""

    #: the twin packs the network as ONE sorted slot multiset, so the
    #: independence pass's JX305 pointer applies: ``per_channel_()`` routes
    #: to the actor compiler's per-channel layout (JAX paxos_tensor.py:78-82)
    network_encoding = "slot-multiset"

    def __init__(self, model, client_count: int):
        if client_count > MAX_CLIENTS:
            raise ValueError(
                f"tensor paxos supports <={MAX_CLIENTS} clients"
            )
        self.model = model
        self.C = C = client_count
        self.n_slots = max(16, 10 * C)  # distinct envelopes in flight
        self.max_actions = self.n_slots

        # -- C-dependent widths --------------------------------------------
        # Each put starts exactly one ballot (a put consumes one of the C PUT
        # envelopes on a non-duplicating network), so rounds never exceed C.
        self.max_rnd = max_rnd = max(C, 1)
        la_max = 1 + ((max_rnd - 1) * S + (S - 1)) * C + (C - 1)
        self._aux_b = max(6, la_max.bit_length())
        self._rnd_b = max(3, max_rnd.bit_length())
        self._id_b = max(3, (S + C - 1).bit_length())
        # envelope code bit layout: kind | src | dst | rnd | ldr | aux
        self._ldr_s = self._aux_b
        self._rnd_s = self._ldr_s + 2
        self._dst_s = self._rnd_s + self._rnd_b
        self._src_s = self._dst_s + self._id_b
        self._kind_s = self._src_s + self._id_b
        self._la_max = la_max
        prep_b = (la_max + 1).bit_length()
        prop_b = max(3, (C + 1).bit_length())

        fields = []
        for s in range(S):
            fields += [
                (f"s{s}_rnd", self._rnd_b),
                (f"s{s}_ldr", 2),
                (f"s{s}_prop", prop_b),
                (f"s{s}_prep0", prep_b),
                (f"s{s}_prep1", prep_b),
                (f"s{s}_prep2", prep_b),
                (f"s{s}_acc", 3),
                (f"s{s}_accd", self._aux_b),
                (f"s{s}_dec", 1),
            ]
        for c in range(C):
            fields += [
                (f"c{c}_phase", 2),
                (f"c{c}_rval", 3),
                (f"c{c}_snap", 2 * C),
            ]
        fields += [("hvalid", 1), ("overflow", 1)]
        self.pk = BitPacker(fields)
        self.pw = self.pk.width
        self.width = self.pw + self.n_slots
        self.codec = SlotCodec(self.n_slots, self._encode_env, self._decode_env)

    # ------------------------------------------------------------------
    # host-side: la / proposal / envelope codes
    # ------------------------------------------------------------------

    def _la_code(self, la) -> int:
        """Option<(Ballot, Proposal)> -> ``_aux_b``-bit code; numeric order
        matches the tuple order used by the prepare-quorum ``max``
        (``paxos.py``)."""
        if la is None:
            return 0
        (rnd, ldr), proposal = la
        ci = int(proposal[1]) - S
        code = 1 + ((rnd - 1) * S + int(ldr)) * self.C + ci
        assert 0 < code <= self._la_max, la
        return code

    def _la_decode(self, code: int):
        if code == 0:
            return None
        x = code - 1
        ci = x % self.C
        x //= self.C
        ldr = x % S
        rnd = x // S + 1
        return ((rnd, Id(ldr)), self._proposal(ci))

    def _proposal(self, ci: int) -> tuple:
        return (S + ci, Id(S + ci), chr(ord("A") + ci))

    def _encode_env(self, env: Envelope) -> int:
        kind = rnd = ldr = aux = 0
        src, dst = int(env.src), int(env.dst)
        m = env.msg
        if m[0] == "put":
            kind = PUT
        elif m[0] == "get":
            kind = GET
        elif m[0] == "put_ok":
            kind = PUT_OK
        elif m[0] == "get_ok":
            kind, aux = GET_OK, self._value_code(m[2])
        else:  # internal
            im = m[1]
            (rnd, ldr_id) = im[1]
            ldr = int(ldr_id)
            if im[0] == "prepare":
                kind = PREPARE
            elif im[0] == "prepared":
                kind, aux = PREPARED, self._la_code(im[2])
            elif im[0] == "accept":
                kind, aux = ACCEPT, int(im[2][1]) - S
            elif im[0] == "accepted":
                kind = ACCEPTED
            elif im[0] == "decided":
                kind, aux = DECIDED, int(im[2][1]) - S
            else:
                raise ValueError(f"unknown internal message {im!r}")
        assert rnd <= self.max_rnd and aux < (1 << self._aux_b), env
        return (
            (kind << self._kind_s)
            | (src << self._src_s)
            | (dst << self._dst_s)
            | (rnd << self._rnd_s)
            | (ldr << self._ldr_s)
            | aux
        )

    def _decode_env(self, code: int) -> Envelope:
        idm = (1 << self._id_b) - 1
        aux = code & ((1 << self._aux_b) - 1)
        ldr = (code >> self._ldr_s) & 3
        rnd = (code >> self._rnd_s) & ((1 << self._rnd_b) - 1)
        dst = (code >> self._dst_s) & idm
        src = (code >> self._src_s) & idm
        kind = code >> self._kind_s
        ballot = (rnd, Id(ldr))
        if kind == PUT:
            ci = src - S
            msg = ("put", S + ci, chr(ord("A") + ci))
        elif kind == GET:
            msg = ("get", 2 * src)
        elif kind == PUT_OK:
            msg = ("put_ok", dst)
        elif kind == GET_OK:
            msg = ("get_ok", 2 * dst, self._value_decode(aux))
        elif kind == PREPARE:
            msg = ("internal", ("prepare", ballot))
        elif kind == PREPARED:
            msg = ("internal", ("prepared", ballot, self._la_decode(aux)))
        elif kind == ACCEPT:
            msg = ("internal", ("accept", ballot, self._proposal(aux)))
        elif kind == ACCEPTED:
            msg = ("internal", ("accepted", ballot))
        elif kind == DECIDED:
            msg = ("internal", ("decided", ballot, self._proposal(aux)))
        else:
            raise ValueError(f"bad envelope code {code:#x}")
        return Envelope(src=Id(src), dst=Id(dst), msg=msg)

    def _value_code(self, v: str) -> int:
        return 0 if v == NULL_VALUE else ord(v) - ord("A") + 1

    def _value_decode(self, code: int) -> str:
        return NULL_VALUE if code == 0 else chr(ord("A") + code - 1)

    # ------------------------------------------------------------------
    # host-side: state <-> row
    # ------------------------------------------------------------------

    def encode_state(self, st: ActorModelState) -> tuple:
        C = self.C
        vals: dict[str, int] = {}
        for s in range(S):
            a = st.actor_states[s]
            rnd, ldr = a.ballot
            assert rnd <= self.max_rnd, a
            vals[f"s{s}_rnd"] = rnd
            vals[f"s{s}_ldr"] = int(ldr)
            vals[f"s{s}_prop"] = (
                0 if a.proposal is None else int(a.proposal[1]) - S + 1
            )
            prep = dict(a.prepares)
            for j in range(S):
                la = prep.get(Id(j), "absent")
                vals[f"s{s}_prep{j}"] = (
                    0 if la == "absent" else 1 + self._la_code(la)
                )
            vals[f"s{s}_acc"] = sum(1 << int(i) for i in a.accepts)
            vals[f"s{s}_accd"] = self._la_code(a.accepted)
            vals[f"s{s}_dec"] = int(a.is_decided)

        tester: LinearizabilityTester = st.history
        for c in range(C):
            thread = S + c
            cs = st.actor_states[thread]
            completed = tester.history_by_thread.get(thread, ())
            in_flight = tester.in_flight_by_thread.get(thread)
            phase = len(completed)
            assert (phase == 2) == (in_flight is None), (c, tester)
            # client actor state is in lockstep with the tester phase
            expect = {
                0: (thread, 1),
                1: (2 * thread, 2),
                2: (None, 3),
            }[phase]
            assert (cs.awaiting, cs.op_count) == expect, (c, cs, phase)
            vals[f"c{c}_phase"] = phase
            rval = 0
            snap_src = None
            if phase == 2:
                snap_src, op, ret = completed[1]
                assert op == READ and ret[0] == "read_ok", completed
                rval = self._value_code(ret[1])
            elif phase == 1:
                snap_src, op = in_flight
                assert op == READ, in_flight
            if phase >= 1:
                assert completed[0][0] == () and completed[0][1] == write(
                    chr(ord("A") + c)
                ), completed
            snap = 0
            if snap_src is not None:
                for peer, idx in snap_src:
                    t = int(peer) - S
                    assert 0 <= t < C and 0 <= idx <= 1, snap_src
                    snap |= (idx + 1) << (2 * t)
            vals[f"c{c}_rval"] = rval
            vals[f"c{c}_snap"] = snap
        vals["hvalid"] = int(tester.valid)
        vals["overflow"] = 0

        counts = st.network._counts
        return self.pk.pack(**vals) + self.codec.pack(
            (env, cnt) for env, cnt in counts.items()
        )

    def decode_state(self, row) -> ActorModelState:
        from .paxos import PaxosState

        C = self.C
        d = self.pk.unpack(row[: self.pw])
        if d["overflow"]:
            raise RuntimeError(
                f"network slot overflow: more than {self.n_slots} distinct "
                f"envelopes in flight"
            )
        actors = []
        for s in range(S):
            prepares = tuple(
                sorted(
                    (Id(j), self._la_decode(d[f"s{s}_prep{j}"] - 1))
                    for j in range(S)
                    if d[f"s{s}_prep{j}"] > 0
                )
            )
            prop = d[f"s{s}_prop"]
            actors.append(
                PaxosState(
                    ballot=(d[f"s{s}_rnd"], Id(d[f"s{s}_ldr"])),
                    proposal=None if prop == 0 else self._proposal(prop - 1),
                    prepares=prepares,
                    accepts=frozenset(
                        Id(i) for i in range(S) if d[f"s{s}_acc"] & (1 << i)
                    ),
                    accepted=self._la_decode(d[f"s{s}_accd"]),
                    is_decided=bool(d[f"s{s}_dec"]),
                )
            )

        history: dict[int, tuple] = {}
        in_flight: dict[int, tuple] = {}
        for c in range(C):
            thread = S + c
            phase = d[f"c{c}_phase"]
            snap = tuple(
                sorted(
                    (S + t, ((d[f"c{c}_snap"] >> (2 * t)) & 3) - 1)
                    for t in range(C)
                    if (d[f"c{c}_snap"] >> (2 * t)) & 3
                )
            )
            w_complete = ((), write(chr(ord("A") + c)), ("write_ok",))
            if phase == 0:
                history[thread] = ()
                in_flight[thread] = ((), write(chr(ord("A") + c)))
                cs = RegisterClientState(awaiting=thread, op_count=1)
            elif phase == 1:
                history[thread] = (w_complete,)
                in_flight[thread] = (snap, READ)
                cs = RegisterClientState(awaiting=2 * thread, op_count=2)
            else:
                rv = self._value_decode(d[f"c{c}_rval"])
                history[thread] = (w_complete, (snap, READ, ("read_ok", rv)))
                cs = RegisterClientState(awaiting=None, op_count=3)
            actors.append(cs)

        tester = LinearizabilityTester(
            Register(NULL_VALUE),
            history,
            in_flight,
            valid=bool(d["hvalid"]),
        )
        network = UnorderedNonDuplicatingNetwork(
            dict(self.codec.unpack(row[self.pw :]))
        )
        return ActorModelState(
            actor_states=tuple(actors),
            network=network,
            is_timer_set=(False,) * (S + C),
            history=tester,
        )

    def init_rows(self) -> np.ndarray:
        return np.asarray(
            [self.encode_state(s) for s in self.model.init_states()],
            np.uint64,
        )

    # ------------------------------------------------------------------
    # device-side
    # ------------------------------------------------------------------

    def _env_fields(self, code: torch.Tensor) -> dict:
        """Envelope fields of slot codes (non-negative: ``slot_codes``
        shifts logically, so arithmetic shifts below are logical too)."""
        idm = (1 << self._id_b) - 1
        return dict(
            aux=code & ((1 << self._aux_b) - 1),
            ldr=(code >> self._ldr_s) & 3,
            rnd=(code >> self._rnd_s) & ((1 << self._rnd_b) - 1),
            dst=(code >> self._dst_s) & idm,
            src=(code >> self._src_s) & idm,
            kind=code >> self._kind_s,
        )

    def step_rows(self, rows: torch.Tensor):
        C, NS, pk, pw = self.C, self.n_slots, self.pk, self.pw
        B, A = rows.shape[0], NS
        dev = rows.device

        slots = rows[:, pw:]  # [B, NS]
        count = slot_counts(slots)
        occupied = slot_occupied(slots)
        # envelope fields per slot (= per action)  [B, A]
        f = self._env_fields(slot_codes(slots))
        aux, ldr, rnd, dst, src, kind = (
            f["aux"], f["ldr"], f["rnd"], f["dst"], f["src"], f["kind"]
        )
        eb = rnd * 4 + ldr  # env ballot, lexicographic key

        def gi(name):  # packed field as [B, 1] (broadcasts over A)
            return pk.get(rows, name)[:, None]

        # server fields stacked [B, S]; then gathered at dst -> [B, A]
        srv = {
            name: torch.cat([gi(f"s{s}_{name}") for s in range(S)], dim=1)
            for name in _SERVER_FIELDS
        }
        dstc = dst.clamp(0, S - 1)

        def at_dst(name):  # [B, A]
            return torch.gather(srv[name], 1, dstc)

        srnd, sldr = at_dst("rnd"), at_dst("ldr")
        sprop, sacc, saccd, sdec = (
            at_dst("prop"), at_dst("acc"), at_dst("accd"), at_dst("dec"),
        )
        sprep = [at_dst(f"prep{j}") for j in range(S)]
        sb = srnd * 4 + sldr
        is_server = dst < S
        undecided = is_server & (sdec == 0)

        # client fields at dst  [B, A]; every peer's phase for the
        # read-invocation snapshot
        cph = torch.cat([gi(f"c{c}_phase") for c in range(C)], dim=1)  # [B, C]
        clic = (dst - S).clamp(0, C - 1)
        cphase = torch.gather(cph, 1, clic)
        is_client = dst >= S

        def la_code(r, lead, ci):
            return 1 + ((r - 1) * S + lead) * C + ci

        def ci_of_la(la):  # floor mod, as in the JAX twin, on la = 0 too
            return (la - 1) % C

        # -- branch masks ---------------------------------------------------
        k_put = (kind == PUT) & undecided & (sprop == 0)
        k_prepare = (kind == PREPARE) & undecided & (sb < eb)
        k_prepared = (kind == PREPARED) & undecided & (eb == sb)
        k_accept = (kind == ACCEPT) & undecided & (sb <= eb)
        k_accepted = (kind == ACCEPTED) & undecided & (eb == sb)
        k_decided = (kind == DECIDED) & undecided
        k_getdec = (kind == GET) & is_server & (sdec == 1)
        k_cputok = (kind == PUT_OK) & is_client & (cphase == 0)
        k_cgetok = (kind == GET_OK) & is_client & (cphase == 1)
        valid = occupied & (
            k_put | k_prepare | k_prepared | k_accept | k_accepted
            | k_decided | k_getdec | k_cputok | k_cgetok
        )

        # -- server successor fields (computed "at dst") --------------------
        ci_src = src - S  # for put: the client index
        put_rnd = srnd + 1

        # prepared bookkeeping
        prep_new = [
            torch.where(
                k_prepared & (src == j),
                1 + aux,
                torch.where(k_put, torch.where(dst == j, 1 + saccd, 0),
                            sprep[j]),
            )
            for j in range(S)
        ]
        prep_count = sum((p > 0).long() for p in prep_new)
        best_la = torch.maximum(torch.maximum(prep_new[0], prep_new[1]),
                                prep_new[2]) - 1
        quorum_p = k_prepared & (prep_count == 2)
        # adopt the most recently accepted proposal from the quorum, else keep
        prop_adopt = torch.where(best_la > 0, ci_of_la(best_la) + 1, sprop)

        acc_new = torch.where(
            quorum_p,
            1 << dstc,
            torch.where(k_put, 0,
                        torch.where(k_accepted, sacc | (1 << src), sacc)),
        )
        acc_pop = (acc_new & 1) + ((acc_new >> 1) & 1) + ((acc_new >> 2) & 1)
        quorum_a = k_accepted & (acc_pop == 2)

        ballot_in = k_prepare | k_accept | k_decided
        new_rnd = torch.where(k_put, put_rnd,
                              torch.where(ballot_in, rnd, srnd))
        new_ldr = torch.where(k_put, dstc, torch.where(ballot_in, ldr, sldr))
        new_prop = torch.where(k_put, ci_src + 1,
                               torch.where(quorum_p, prop_adopt, sprop))
        new_accd = torch.where(
            quorum_p,
            la_code(srnd, sldr, prop_adopt - 1),
            torch.where(k_accept | k_decided, la_code(rnd, ldr, aux), saccd),
        )
        new_dec = torch.where(quorum_a | k_decided, 1, sdec)

        # -- client successor fields ----------------------------------------
        new_phase = torch.where(k_cputok, 1, torch.where(k_cgetok, 2, cphase))
        new_rval = torch.where(k_cgetok, aux, 0)
        # snapshot at get-invocation: peer completed counts == phases
        snap_val = torch.zeros_like(dst)
        for t in range(C):
            peer_phase = cph[:, t : t + 1].clamp(max=2)
            contrib = torch.where(clic == t, 0, peer_phase) << (2 * t)
            snap_val = snap_val + torch.where(k_cputok, contrib, 0)

        # -- sends (3 channels) ---------------------------------------------
        z = torch.zeros_like(dst)

        def env_code(knd, esrc, edst, ernd, eldr, eaux):
            return (
                ((z + knd) << self._kind_s)
                | (esrc << self._src_s)
                | (edst << self._dst_s)
                | (ernd << self._rnd_s)
                | (eldr << self._ldr_s)
                | eaux
            )

        p1 = torch.where(dstc + 1 >= S, dstc + 1 - S, dstc + 1)
        p2 = torch.where(dstc + 2 >= S, dstc + 2 - S, dstc + 2)

        # ch0: single-target sends
        ch0_en = k_prepare | k_accept | quorum_a | k_getdec | k_cputok
        ch0_code = torch.where(
            k_prepare,
            env_code(PREPARED, dst, src, rnd, ldr, saccd),
            torch.where(
                k_accept,
                env_code(ACCEPTED, dst, src, rnd, ldr, z),
                torch.where(
                    quorum_a,
                    env_code(PUT_OK, dst, S + sprop - 1, z, z, z),
                    torch.where(
                        k_getdec,
                        env_code(GET_OK, dst, src, z, z, ci_of_la(saccd) + 1),
                        # k_cputok: the follow-up get, to server
                        # (index + op_count) % S with op_count == 1
                        env_code(GET, dst, (dst + 1) % S, z, z, z),
                    ),
                ),
            ),
        )

        # ch1/ch2: peer broadcasts (prepare / accept / decided)
        bcast = k_put | quorum_p | quorum_a
        bc_kind = torch.where(k_put, PREPARE,
                              torch.where(quorum_p, ACCEPT, DECIDED))
        bc_rnd = torch.where(k_put, put_rnd, srnd)
        bc_ldr = torch.where(k_put, dstc, sldr)
        bc_aux = torch.where(quorum_p, prop_adopt - 1,
                             torch.where(quorum_a, sprop - 1, z))
        ch1_code = env_code(bc_kind, dst, p1, bc_rnd, bc_ldr, bc_aux)
        ch2_code = env_code(bc_kind, dst, p2, bc_rnd, bc_ldr, bc_aux)

        # -- assemble successor slot arrays ---------------------------------
        slots_b = slots[:, None, :].expand(B, A, NS)
        diag = torch.eye(A, NS, dtype=torch.bool, device=dev)[None]
        # the delivered slot of action a is slot a: one instance consumed
        neww = torch.where(count <= 1, _EMPTY, slots - 1)  # [B, A]
        slots_d = torch.where(diag, neww[:, :, None], slots_b)

        of = torch.zeros((B, A), dtype=torch.bool, device=dev)
        for en, cd in ((ch0_en, ch0_code), (bcast, ch1_code),
                       (bcast, ch2_code)):
            slots_d, o = slot_send(slots_d, cd, en & valid)
            of = of | o
        slots_d = slot_canonicalize(slots_d)

        # -- assemble successor packed words --------------------------------
        fw = FieldWriter(pk, rows[:, None, :pw].expand(B, A, pw))

        def scatter_server(name, new_val, old_stacked):
            for s in range(S):
                old = old_stacked[:, s : s + 1]
                v = torch.where(valid & is_server & (dst == s), new_val, old)
                fw.set(f"s{s}_{name}", v)

        scatter_server("rnd", new_rnd, srv["rnd"])
        scatter_server("ldr", new_ldr, srv["ldr"])
        scatter_server("prop", new_prop, srv["prop"])
        for j in range(S):
            scatter_server(f"prep{j}", prep_new[j], srv[f"prep{j}"])
        scatter_server("acc", acc_new, srv["acc"])
        scatter_server("accd", new_accd, srv["accd"])
        scatter_server("dec", new_dec, srv["dec"])

        for c in range(C):
            m = valid & is_client & (dst == S + c)
            fw.set(f"c{c}_phase",
                   torch.where(m, new_phase, cph[:, c : c + 1]))
            fw.set(f"c{c}_rval",
                   torch.where(m & k_cgetok, new_rval, gi(f"c{c}_rval")))
            fw.set(f"c{c}_snap",
                   torch.where(m & k_cputok, snap_val, gi(f"c{c}_snap")))
        fw.set("overflow",
               torch.maximum(of.long(), gi("overflow")))

        succ = torch.cat([fw.done(), slots_d], dim=-1)
        return succ, valid

    def property_masks(self, rows: torch.Tensor) -> torch.Tensor:
        C, pk = self.C, self.pk
        B = rows.shape[0]

        def fields(name):  # [B, C]
            return torch.stack(
                [pk.get(rows, f"c{c}_{name}") for c in range(C)], dim=-1
            )

        phase, rval, snap = fields("phase"), fields("rval"), fields("snap")
        hvalid = pk.get(rows, "hvalid") == 1

        # s[b, i, t] = ops thread t had completed when thread i's read was
        # invoked (the snapshot recorded at get-invocation; self slot 0)
        done = phase == 2
        s = torch.zeros((B, C, C), dtype=torch.int64, device=rows.device)
        for i in range(C):
            for t in range(C):
                if t != i:
                    s[:, i, t] = (snap[:, i] >> (2 * t)) & 3
        linearizable = closure_verdict(done, s, rval) & hvalid

        # "value chosen": some get_ok with a non-null value is in flight
        slots = rows[:, self.pw :]
        f = self._env_fields(slot_codes(slots))
        chosen = (slot_occupied(slots) & (f["kind"] == GET_OK)
                  & (f["aux"] > 0)).any(dim=-1)
        return torch.stack([linearizable, chosen], dim=-1)


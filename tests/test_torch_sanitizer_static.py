"""The static half of the port's sanitizer (``stateright_tpu_torch/analysis/
interval.py`` + ``sanitizer.py``) against the JAX package's, tolerance 0.

 - Each fault-injection twin of ``tests/test_sanitizer.py:186-249`` (the
   JAX classes themselves) has a torch twin here with the same defect, and
   both give the same ``(rule_id, severity)`` pairs in ``JX2xx`` (sites are
   not compared).  The dead-branch case fails in the JAX package in some
   sandboxes (ROADMAP Queue 3 item 1): there the port is held to the value
   the JAX test pins, ``JX205`` info.
 - The preflight refuses the out-of-range twin with ``JX201`` before the
   engine is built, and names it machine-readably.
 - The port's 2pc, ``PaxosTensor`` and compiled twins in both packings
   prove every indexed site (no undecided escape); the compiled twin is
   proved through its ``RowDomain`` (JAX ``test_compiled_actor_twin_
   proves_every_site``, which fails in the JAX package here: the port is
   held to its pin).
 - ``RowDomain`` tightens a field bound below its width, as JAX's test does.
 - The interval unit cases of ``tests/test_sanitizer.py:333`` give JAX's
   bounds, and ``RowDomain.words_ival`` gives JAX's seeds.
 - The ``sanitize`` verbs."""

import sys

import numpy as np
import pytest
import torch

from stateright_tpu.analysis import audit_model as jax_audit
from stateright_tpu.analysis.interval import IVal as JaxIVal
from stateright_tpu.parallel.tensor_model import BitPacker as JaxPacker
from stateright_tpu.parallel.tensor_model import RowDomain as JaxRowDomain
from stateright_tpu_torch.analysis import AuditError, Severity, audit_model
from stateright_tpu_torch.analysis.interval import IVal
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.models import _cli
from stateright_tpu_torch.parallel.tensor_model import (
    BitPacker,
    RowDomain,
    TensorBackedModel,
    TensorModel,
)

sys.path.insert(0, "tests")
from test_sanitizer import (  # noqa: E402 - the JAX fixtures themselves
    DeadBranchTwin,
    EmptyReadTwin,
    OOBGatherTwin,
    OOBScatterTwin,
    OverflowCounterTwin,
)
from test_sanitizer import _host_model as jax_host_model  # noqa: E402
from test_torch_oob_twin import OOBModel  # noqa: E402

EMPTY = -1  # the port's EMPTY word


class FaultBase(TensorModel):
    width = 1
    max_actions = 1

    def __init__(self, model):
        self.model = model

    def init_rows(self):
        return np.zeros((1, 1), np.uint64)

    def encode_state(self, s):
        return (int(s),)

    def decode_state(self, row):
        return int(row[0])

    def property_masks(self, rows):
        return torch.ones((rows.shape[0], 1), dtype=torch.bool,
                          device=rows.device)


def set_word0(rows, value):
    succ = rows.clone()
    succ[..., 0] = value
    return succ[:, None, :]


class PortOOBGather(FaultBase):
    """A 3-bit count indexes a 4-entry table (JAX ``OOBGatherTwin``)."""

    def __init__(self, model):
        super().__init__(model)
        self.pk = BitPacker([("count", 3)])

    def step_rows(self, rows):
        c = self.pk.get(rows, "count")
        tbl = torch.tensor([1, 2, 3, 4], dtype=torch.int64,
                           device=rows.device)
        return set_word0(rows, tbl[c]), (c < 7)[:, None]


class PortOOBScatter(FaultBase):
    """A 3-bit field as the column of an indexed write into a 4-wide
    vector (JAX ``OOBScatterTwin``'s dynamic-update start)."""

    def __init__(self, model):
        super().__init__(model)
        self.pk = BitPacker([("slot", 3)])

    def step_rows(self, rows):
        s = self.pk.get(rows, "slot")
        b = rows.shape[0]
        vec = torch.zeros((b, 4), dtype=torch.int64, device=rows.device)
        # the start's negative-index normalization, as jnp writes it for
        # a dynamic update (its dead case is JAX's JX205 here too)
        col = torch.where(s < 0, s + 4, s)
        vec[torch.arange(b, device=rows.device), col] = 1
        return set_word0(rows, vec[:, 0] + rows[..., 0]), (s < 7)[:, None]


class PortOverflowCounter(FaultBase):
    """``count + 5`` into a 2-bit field (JAX ``OverflowCounterTwin``)."""

    def __init__(self, model):
        super().__init__(model)
        self.pk = BitPacker([("count", 2)])

    def step_rows(self, rows):
        c = self.pk.get(rows, "count")
        succ = self.pk.set(rows, "count", c + 5)[:, None, :]
        return succ, (c < 3)[:, None]


class PortEmptyRead(FaultBase):
    """A gather from a table with EMPTY padding, then arithmetic with no
    EMPTY comparison (JAX ``EmptyReadTwin``)."""

    def step_rows(self, rows):
        tbl = torch.tensor([1, 2, EMPTY, EMPTY], dtype=torch.int64,
                           device=rows.device)
        v = tbl[rows[..., 0] & 3]
        return set_word0(rows, v + 1), (rows[..., 0] < 3)[:, None]


class PortDeadBranch(FaultBase):
    """A 3-bit field compared against 8 (JAX ``DeadBranchTwin``)."""

    def __init__(self, model):
        super().__init__(model)
        self.pk = BitPacker([("v", 3)])

    def step_rows(self, rows):
        v = self.pk.get(rows, "v")
        nxt = torch.where(v < 8, v + 1, 99)  # the false case is dead
        succ = self.pk.set(rows, "v", nxt & 7)[:, None, :]
        return succ, (v < 1)[:, None]


class _Counter:
    def init_states(self):
        return [0]

    def actions(self, s):
        return [0] if s < 7 else []

    def next_state(self, s, a):
        return s + 1


def host_model(twin_cls):
    def tensor_model(self):
        return twin_cls(self)

    def properties(self):
        return [Property.always("ok", lambda m, s: True)]

    cls = type(f"Host_{twin_cls.__name__}", (_Counter, TensorBackedModel,
                                             Model),
               {"tensor_model": tensor_model, "properties": properties})
    return cls()


def san_rules(report) -> set:
    return {(f.rule_id, f.severity) for f in report.findings
            if f.rule_id.startswith("JX2")}


# (jax twin or None where the JAX test fails here, port twin, pinned)
FIXTURES = {
    "oob_gather": (OOBGatherTwin, PortOOBGather, ("JX201", Severity.ERROR)),
    "oob_update": (OOBScatterTwin, PortOOBScatter, ("JX202", Severity.ERROR)),
    "overflow": (OverflowCounterTwin, PortOverflowCounter,
                 ("JX203", Severity.WARNING)),
    "empty_read": (EmptyReadTwin, PortEmptyRead, ("JX204", Severity.WARNING)),
    "dead_branch": (None, PortDeadBranch, ("JX205", Severity.INFO)),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fault_twin_gives_the_jax_rules(name):
    jax_cls, port_cls, pinned = FIXTURES[name]
    report = audit_model(host_model(port_cls))
    got = san_rules(report)
    hits = report.by_rule(pinned[0])
    assert hits and all(f.severity == pinned[1] for f in hits), \
        report.format()
    if jax_cls is not None:
        assert got == san_rules(jax_audit(jax_host_model(jax_cls))), got
    else:  # the JAX test's pin: JX205 info, and the report stays clean
        assert pinned in got and report.ok and not report.warnings, got


def test_dead_branch_in_the_jax_package_is_the_pinned_case():
    """The JAX twin of the dead-branch case gives no error either; its
    JX205 is what the JAX test pins (it does not fire here)."""
    got = san_rules(jax_audit(jax_host_model(DeadBranchTwin)))
    assert not {r for r in got if r[1] == Severity.ERROR}


def test_messages_name_the_interval_and_axis():
    hits = audit_model(host_model(PortOOBGather)).by_rule("JX201")
    assert "[0, 7]" in hits[0].message and "axis 4" in hits[0].message
    hits = audit_model(host_model(PortOverflowCounter)).by_rule("JX203")
    assert "[5, 8]" in hits[0].message


def test_preflight_refuses_the_out_of_range_twin_with_jx201(monkeypatch):
    """The out-of-range twin of the checked-mode tests: the light
    preflight aborts with JX201 before the engine is built (on CUDA the
    gather would end the context), the rule id machine-readable."""
    from stateright_tpu_torch.parallel.wavefront import GpuChecker

    def refuse(*a, **k):
        raise AssertionError("the engine was built despite JX201")

    monkeypatch.setattr(GpuChecker, "__init__", refuse)
    with pytest.raises(AuditError, match="JX201") as exc:
        OOBModel().checker().spawn_gpu(device="cpu", batch=8,
                                       capacity=1 << 10)
    assert exc.value.rule_ids == ("JX201",)


@pytest.mark.parametrize("name", ["2pc-3", "paxos-1", "dining-3",
                                  "single-copy-2", "per-channel-paxos-1"])
def test_shipped_twin_proves_every_site(name):
    from stateright_tpu_torch.models.dining import dining_model
    from stateright_tpu_torch.models.paxos import paxos_model
    from stateright_tpu_torch.models.single_copy_register import (
        single_copy_model,
    )
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = {
        "2pc-3": lambda: TwoPhaseSys(3),
        "paxos-1": lambda: paxos_model(1),
        "dining-3": lambda: dining_model(3),
        "single-copy-2": lambda: single_copy_model(2, 1),
        "per-channel-paxos-1": lambda: paxos_model(1).per_channel_(),
    }[name]()
    report = audit_model(model, deep=True, share=False)
    s = report.metrics["sanitizer"]
    assert s["clean"] and s["undecided"] == 0, s
    assert s["proved"] == s["sites"], s
    assert not report.by_rule("JX201") and not report.by_rule("JX202")
    if name not in ("2pc-3",):  # 2pc's kernel indexes nothing
        assert s["sites"] > 0 and s["seeded"], s


def test_row_domain_field_bound_tightens_below_field_width():
    """A 3-bit field declared to hold codes 0..4 proves a gather from a
    5-entry table; the field width alone (0..7) cannot (JAX
    tests/test_sanitizer.py:252-277)."""

    class FiveState(FaultBase):
        def __init__(self, model):
            super().__init__(model)
            self.pk = BitPacker([("code", 3)])

        def row_domain(self):
            return RowDomain.from_packer(self.pk, field_bounds={"code": 4})

        def step_rows(self, rows):
            c = self.pk.get(rows, "code")
            tbl = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int64,
                               device=rows.device)
            return set_word0(rows, tbl[c]), (c < 4)[:, None]

    report = audit_model(host_model(FiveState))
    s = report.metrics["sanitizer"]
    assert not report.by_rule("JX201"), report.format()
    assert s["proved"] == s["sites"] > 0

    class FiveStateUnseeded(FiveState):
        def row_domain(self):
            return None  # the field width: 0..7 escapes

    report = audit_model(host_model(FiveStateUnseeded))
    assert report.by_rule("JX201"), report.format()


def test_compiled_twin_field_bound_is_below_its_width():
    """``CompiledActorTensor.row_domain``: an actor's state-code field is
    bound by its universe, below the field's width, as in the JAX
    compiler's domain (JAX actor_compiler.py:1421)."""
    from stateright_tpu.models.dining import dining_model as jax_dining
    from stateright_tpu_torch.models.dining import dining_model

    port, ref = dining_model(3).tensor_model(), jax_dining(3).tensor_model()
    pd, jd = port.row_domain(), ref.row_domain()
    assert pd._fields == jd._fields and pd._words == jd._words
    tight = [(k, hi) for k, hi in pd._fields.items() if hi < (1 << k[2]) - 1]
    assert tight, pd._fields


def test_per_channel_row_domain_equals_jax():
    from stateright_tpu.models.paxos import paxos_model as jax_paxos
    from stateright_tpu_torch.models.paxos import paxos_model

    port = paxos_model(1).per_channel_().tensor_model().row_domain()
    ref = jax_paxos(1).per_channel_().tensor_model().row_domain()
    assert port._fields == ref._fields and port._words == ref._words


def _pair(fn):
    return fn(IVal), fn(JaxIVal)


def test_interval_unit_cases_equal_jax():
    """The IVal algebra of JAX tests/test_sanitizer.py:333, in both
    packages: the same bounds, tolerance 0."""
    U = (1 << 64) - 1
    cases = [
        lambda V: V(0, 7).join(V(3, 12)).hull(),
        lambda V: V(0, 7).clip(2, 5).hull(),
        lambda V: V(0, 7).clip(9, 12),
        lambda V: V(0, 100, frozenset({U})).may_contain(U),
        lambda V: V(0, 100, frozenset({U})).drop_point(U).hull(),
        lambda V: V(0, 100, frozenset({U})).map_exact(lambda v: v >> 6)
        .hull(),
        lambda V: V(5, 5).singleton(),
        lambda V: V(0, 3, frozenset({10, 20, 30}))._norm().hull(),
        lambda V: V(2, 9).drop_point(2).hull(),
        lambda V: V.top(np.int32).hull(),
        lambda V: V.const(np.asarray([3, 9, 4])).hull(),
    ]
    for case in cases:
        port, ref = _pair(case)
        assert port == ref, (port, ref)


def test_row_domain_seeds_equal_jax():
    """``words_ival`` gives JAX's unsigned seeds; ``signed=True`` the
    port's bit patterns (EMPTY -> -1)."""
    pk, jpk = BitPacker([("a", 3), ("b", 5)]), JaxPacker([("a", 3), ("b", 5)])
    dom = RowDomain.from_packer(pk, width=3, field_bounds={"b": 17})
    ref = JaxRowDomain.from_packer(jpk, width=3, field_bounds={"b": 17})
    dom.declare_word(1, 40, may_empty=True)
    ref.declare_word(1, 40, may_empty=True)
    for a, b in ((0, 1), (1, 2), (0, 2), (2, 3), (0, 3)):
        got, want = dom.words_ival(a, b), ref.words_ival(a, b)
        assert (got.lo, got.hi, got.outliers, got.word) == (
            want.lo, want.hi, want.outliers, want.word)
    s = dom.words_ival(1, 2, signed=True)
    assert (s.lo, s.hi, s.outliers) == (0, 40, frozenset({-1}))
    assert dom.words_ival(2, 3, signed=True).hull() == (-(1 << 63),
                                                        (1 << 63) - 1)


def test_model_sanitize_verb(capsys):
    from stateright_tpu_torch.models import two_phase_commit

    assert two_phase_commit.main(["sanitize"]) == 0
    out = capsys.readouterr().out
    assert "proved in range" in out


def test_fleet_sanitize_subset(capsys):
    assert _cli.main(["sanitize", "two_phase_commit", "increment"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("sanitize fleet: CLEAN")

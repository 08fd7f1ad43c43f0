"""The port's kernel audit (``stateright_tpu_torch/analysis/kernel_audit.py``)
against the JAX package's jaxpr audit, tolerance 0.

Each JAX fixture of ``tests/test_analysis.py:94-253`` has a torch twin
here with the same defect, and both packages' audits give the same
``(rule_id, severity)`` pairs in ``JX0xx`` and ``JX1xx`` (sites are not
compared).  Two defects take the port's form: JAX's host callback
(``jax.debug.print``, ``JX101``) is a host read of a tensor value in
torch (``int(rows[0, 0])``, an ``aten._local_scalar_dense``), and JAX's
untraceable branch on a traced value (``JX000``) is a branch on a
many-valued tensor, which torch cannot capture either.  Also: the
shipped twins audit without a kernel error or warning, the preflight
aborts before the engine is built and ``skip_audit()`` turns it off, the
light tier captures ``property_masks`` once and the deep tier twice, and
the per-row metrics ride the report."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stateright_tpu.analysis import audit_model as jax_audit
from stateright_tpu.core import Model as JaxModel
from stateright_tpu.core import Property as JaxProperty
from stateright_tpu.parallel.tensor_model import (
    TensorBackedModel as JaxBacked,
)
from stateright_tpu.parallel.tensor_model import TensorModel as JaxTwin
from stateright_tpu_torch.analysis import (
    AuditError,
    AuditReport,
    Severity,
    audit_model,
)
from stateright_tpu_torch.core import Model, Property
from stateright_tpu_torch.parallel.tensor_model import (
    TensorBackedModel,
    TensorModel,
)

# -- the twins: a 2-state chain 0 -> 1 (JAX tests/test_analysis.py:37-91) ---


class JaxBase(JaxTwin):
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

    def step_rows(self, rows):
        succ = (rows + jnp.uint64(1))[:, None, :]
        valid = (rows[..., 0] < jnp.uint64(1))[:, None]
        return succ, valid

    def property_masks(self, rows):
        return jnp.ones((rows.shape[0], 1), bool)


class PortBase(TensorModel):
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

    def step_rows(self, rows):
        succ = (rows + 1)[:, None, :]
        valid = (rows[..., 0] < 1)[:, None]
        return succ, valid

    def property_masks(self, rows):
        return torch.ones((rows.shape[0], 1), dtype=torch.bool,
                          device=rows.device)


class _Chain:
    def init_states(self):
        return [0]

    def actions(self, s):
        return [0] if s < 1 else []

    def next_state(self, s, a):
        return s + 1


def host_model(twin_cls):
    """A fresh host model class per twin (the audit caches by class)."""
    jax_side = issubclass(twin_cls, JaxTwin)
    bases = (_Chain, JaxBacked, JaxModel) if jax_side else (
        _Chain, TensorBackedModel, Model)
    prop = JaxProperty if jax_side else Property

    def tensor_model(self):
        return twin_cls(self)

    def properties(self):
        return [prop.always("ok", lambda m, s: True)]

    cls = type(f"Host_{twin_cls.__name__}", bases,
               {"tensor_model": tensor_model, "properties": properties})
    return cls()


# -- the defects, one pair per JAX fixture ------------------------------------


class JaxImpure(JaxBase):
    def __init__(self, model):
        super().__init__(model)
        self.trace_log = []

    def step_rows(self, rows):
        self.trace_log.append(len(self.trace_log))
        k = jnp.uint64(len(self.trace_log))
        return (rows + k)[:, None, :], (rows[..., 0] < jnp.uint64(1))[:, None]


class PortImpure(PortBase):
    def __init__(self, model):
        super().__init__(model)
        self.trace_log = []

    def step_rows(self, rows):
        self.trace_log.append(len(self.trace_log))
        k = len(self.trace_log)  # differs per capture
        return (rows + k)[:, None, :], (rows[..., 0] < 1)[:, None]


class JaxConstMut(JaxBase):
    def __init__(self, model):
        super().__init__(model)
        self.offsets = np.zeros(4, np.uint64)

    def step_rows(self, rows):
        self.offsets = self.offsets + np.uint64(1)
        k = jnp.asarray(self.offsets)[0]
        return (rows + k)[:, None, :], (rows[..., 0] < jnp.uint64(1))[:, None]


class PortConstMut(PortBase):
    def __init__(self, model):
        super().__init__(model)
        self.offsets = np.zeros(4, np.int64)

    def step_rows(self, rows):
        self.offsets = self.offsets + 1  # drifts per capture
        k = torch.as_tensor(self.offsets)[0]
        return (rows + k)[:, None, :], (rows[..., 0] < 1)[:, None]


class JaxFloat(JaxBase):
    def step_rows(self, rows):
        f = rows.astype(jnp.float32) + 1.0
        return (f.astype(jnp.uint64)[:, None, :],
                (rows[..., 0] < jnp.uint64(1))[:, None])


class PortFloat(PortBase):
    def step_rows(self, rows):
        f = rows.to(torch.float32) + 1.0
        return f.to(torch.int64)[:, None, :], (rows[..., 0] < 1)[:, None]


class JaxI32(JaxBase):
    def step_rows(self, rows):
        succ = (rows + jnp.uint64(1)).astype(jnp.int32)[:, None, :]
        return succ, (rows[..., 0] < jnp.uint64(1))[:, None]


class PortI32(PortBase):
    def step_rows(self, rows):
        succ = (rows + 1).to(torch.int32)[:, None, :]
        return succ, (rows[..., 0] < 1)[:, None]


class JaxWrongArity(JaxBase):
    max_actions = 2


class PortWrongArity(PortBase):
    max_actions = 2


class JaxNarrow(JaxBase):
    def step_rows(self, rows):
        w = rows.astype(jnp.uint32)
        succ = (w + jnp.uint32(1)).astype(jnp.uint64)[:, None, :]
        return succ, (rows[..., 0] < jnp.uint64(1))[:, None]


class PortNarrow(PortBase):
    def step_rows(self, rows):
        w = rows.to(torch.int32)  # raw words: the top 32 bits dropped
        succ = (w + 1).to(torch.int64)[:, None, :]
        return succ, (rows[..., 0] < 1)[:, None]


class JaxMasked(JaxBase):
    def step_rows(self, rows):
        field = (rows & jnp.uint64(0xFF)).astype(jnp.int32)
        succ = (field + 1).astype(jnp.uint64)[:, None, :]
        return succ, (rows[..., 0] < jnp.uint64(1))[:, None]


class PortMasked(PortBase):
    def step_rows(self, rows):
        field = (rows & 0xFF).to(torch.int32)  # provably small
        succ = (field + 1).to(torch.int64)[:, None, :]
        return succ, (rows[..., 0] < 1)[:, None]


class JaxCallback(JaxBase):
    def step_rows(self, rows):
        jax.debug.print("row {}", rows[0, 0])
        return super().step_rows(rows)


class PortHostRead(PortBase):
    def step_rows(self, rows):
        first = int(rows[0, 0])  # a host read: a sync on the card
        assert first >= 0
        return super().step_rows(rows)


class JaxBroken(JaxBase):
    def step_rows(self, rows):
        if rows[0, 0] > 0:  # traced-bool branch
            return rows[:, None, :], jnp.ones((rows.shape[0], 1), bool)
        return rows[:, None, :], jnp.zeros((rows.shape[0], 1), bool)


class PortBroken(PortBase):
    def step_rows(self, rows):
        if rows[:, 0] > 0:  # a branch on a many-valued tensor
            return rows[:, None, :], torch.ones((rows.shape[0], 1),
                                                dtype=torch.bool)
        return rows[:, None, :], torch.zeros((rows.shape[0], 1),
                                             dtype=torch.bool)


# (jax twin, port twin, the JAX test's pinned (rule, severity))
FIXTURES = {
    "clean": (JaxBase, PortBase, ("JX106", Severity.INFO)),
    "impure_literal": (JaxImpure, PortImpure, ("JX104", Severity.ERROR)),
    "impure_consts": (JaxConstMut, PortConstMut, ("JX104", Severity.ERROR)),
    "float": (JaxFloat, PortFloat, ("JX102", Severity.WARNING)),
    "int32_contract": (JaxI32, PortI32, ("JX103", Severity.ERROR)),
    "wrong_arity": (JaxWrongArity, PortWrongArity, ("JX103", Severity.ERROR)),
    "narrowing": (JaxNarrow, PortNarrow, ("JX107", Severity.WARNING)),
    "masked": (JaxMasked, PortMasked, ("JX106", Severity.INFO)),
    "side_effect": (JaxCallback, PortHostRead, ("JX101", Severity.ERROR)),
    "untraceable": (JaxBroken, PortBroken, ("JX000", Severity.ERROR)),
}


def kernel_rules(report) -> set:
    return {(f.rule_id, f.severity) for f in report.findings
            if f.rule_id.startswith(("JX0", "JX1"))}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_gives_the_jax_rules(name):
    jax_cls, port_cls, pinned = FIXTURES[name]
    jr = kernel_rules(jax_audit(host_model(jax_cls)))
    pr = kernel_rules(audit_model(host_model(port_cls)))
    assert pinned in pr, pr
    assert pr == jr, (pr, jr)


def test_clean_twin_reports_per_row_metrics():
    report = audit_model(host_model(PortBase), deep=True)
    assert report.ok and not report.warnings, report.format()
    m = report.metrics["step_rows"]
    assert m["eqns"] > 0 and m["bytes_per_row"] > 0
    assert "perf: step_rows" in report.format()


def test_report_merge_dedupes_across_passes():
    """``merge`` folds another pass's report in: findings dedupe, this
    report's metrics win (JAX tests/test_sanitizer.py's merge case)."""
    a = AuditReport(model="M")
    a.add("JX201", Severity.ERROR, "step_rows:index#1", "x")
    a.metrics["sanitizer"] = {"sites": 1}
    b = AuditReport(model="M")
    b.add("JX201", Severity.ERROR, "step_rows:index#1", "x")
    b.add("JX106", Severity.INFO, "step_rows", "y")
    b.metrics.update(sanitizer={"sites": 9}, step_rows={"eqns": 3})
    assert a.merge(b) is a
    assert [f.rule_id for f in a.findings] == ["JX201", "JX106"]
    assert a.metrics == {"sanitizer": {"sites": 1}, "step_rows": {"eqns": 3}}


def test_masked_field_narrowing_stays_quiet():
    assert "JX107" not in audit_model(host_model(PortMasked)).rule_ids()


def test_deep_tier_recaptures_property_masks(monkeypatch):
    """The light tier diffs ``step_rows`` only, as JAX's
    ``_audit_one_kernel`` (:246) does; the deep tier diffs
    ``property_masks`` too."""
    from stateright_tpu_torch.analysis import kernel_audit

    seen = []
    fresh = kernel_audit.capture_fresh

    def counted(tensor, kernel, *a, **k):
        seen.append(kernel)
        return fresh(tensor, kernel, *a, **k)

    monkeypatch.setattr(kernel_audit, "capture_fresh", counted)
    kernel_audit.run_kernel_audit(PortBase(None), AuditReport())
    assert seen == ["step_rows"]
    seen.clear()
    kernel_audit.run_kernel_audit(PortBase(None), AuditReport(), deep=True)
    assert seen == ["step_rows", "property_masks"]


def test_preflight_aborts_before_the_engine_and_skip_audit_runs_it(
        monkeypatch):
    from stateright_tpu_torch.parallel.wavefront import GpuChecker

    built = []
    init = GpuChecker.__init__

    def tracked(self, *a, **k):
        built.append(1)
        return init(self, *a, **k)

    monkeypatch.setattr(GpuChecker, "__init__", tracked)
    m = host_model(PortI32)
    with pytest.raises(AuditError, match="JX103") as exc:
        m.checker().spawn_gpu(device="cpu", batch=8, capacity=1 << 10)
    assert "JX103" in exc.value.rule_ids and not built
    b = m.checker().skip_audit()
    assert b._preflight_audit() is None


def test_float_warning_does_not_abort(capsys):
    m = host_model(PortFloat)
    c = m.checker().spawn_gpu(device="cpu", batch=8,
                              capacity=1 << 10).join()
    assert c.unique_state_count() == 2
    assert "JX102" in capsys.readouterr().err


def test_tensor_override_is_never_cached():
    """``tensor=`` audits a bare twin once: neither the model nor the
    process-wide cache serves its findings for the model's own twin."""
    m = host_model(PortBase)
    probe = audit_model(m, tensor=PortI32(m))
    assert "JX103" in probe.rule_ids()
    assert "JX103" not in audit_model(m).rule_ids()
    assert m._audit_report.ok


SHIPPED = [
    ("two_phase_commit", lambda: __import__(
        "stateright_tpu_torch.models.two_phase_commit",
        fromlist=["x"]).TwoPhaseSys(3)),
    ("paxos", lambda: __import__(
        "stateright_tpu_torch.models.paxos", fromlist=["x"]).paxos_model(1)),
    ("single_copy", lambda: __import__(
        "stateright_tpu_torch.models.single_copy_register",
        fromlist=["x"]).single_copy_model(2, 1)),
    ("per_channel_paxos", lambda: __import__(
        "stateright_tpu_torch.models.paxos",
        fromlist=["x"]).paxos_model(1).per_channel_()),
]


@pytest.mark.parametrize("name", [n for n, _ in SHIPPED])
def test_shipped_twins_have_no_kernel_error_or_warning(name):
    model = dict(SHIPPED)[name]()
    report = audit_model(model, share=False)
    bad = [f for f in report.findings if f.rule_id.startswith(("JX0", "JX1"))
           and f.severity != Severity.INFO]
    assert not bad, report.format()
    assert "JX106" in report.rule_ids()

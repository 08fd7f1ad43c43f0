"""The port's static audit (``stateright_tpu_torch/analysis/``: the audit
report, the actor-handler lint and the config rules) and the
``spawn_gpu`` preflight, against the JAX package's (the port's
counterparts of ``tests/test_analysis.py:305-560``), tolerance 0:

 - each handler-lint fixture is written once against each package's
   ``Actor`` and gives the same set of ``(rule_id, severity)`` in both
   (AH201-AH205, the AH205 downgrade under a ``state_bound``);
 - CF301, including the mutation that the signature cannot see (the deep
   re-resolve), and CF302;
 - the port's shipped models audit clean, and their AH and CF findings
   are the JAX package's; the quickstart's pinned AH205 warnings;
 - the preflight aborts before any buffer is allocated, warns once,
   never masks the engine's own error, and both ``skip_audit()`` and
   ``STATERIGHT_TPU_SKIP_AUDIT=1`` turn it off;
 - the ``audit`` verbs.

The kernel passes' findings (``JX*``) are compared in
``test_torch_kernel_audit.py`` and ``test_torch_sanitizer_static.py``;
here they are left out of every comparison."""

import random  # noqa: F401 - referenced by a linted handler below
import time  # noqa: F401 - referenced by a linted handler below
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stateright_tpu.actor as jax_actor
from stateright_tpu.actor.device_props import forall_actors as jax_forall
from stateright_tpu.analysis import audit_model as jax_audit
from stateright_tpu.core import Expectation as JaxExpectation
from stateright_tpu.core import Model as JaxModel
from stateright_tpu.core import Property as JaxProperty
from stateright_tpu.parallel.actor_compiler import (
    compile_actor_model as jax_compile,
)
from stateright_tpu.parallel.tensor_model import (
    TensorBackedModel as JaxBacked,
)
from stateright_tpu.parallel.tensor_model import TensorModel as JaxTwin
import stateright_tpu_torch.actor as port_actor
from stateright_tpu_torch.actor.device_props import forall_actors
from stateright_tpu_torch.analysis import (
    AuditError,
    AuditReport,
    Severity,
    audit_model,
    config_signature,
)
from stateright_tpu_torch.core import Expectation, Model, Property
from stateright_tpu_torch.models import _cli
from stateright_tpu_torch.models import two_phase_commit
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel.actor_compiler import compile_actor_model
from stateright_tpu_torch.parallel.tensor_model import (
    TensorBackedModel,
    TensorModel,
)
from stateright_tpu_torch.parallel.wavefront import GpuChecker

PACKAGES = {
    "port": dict(actor=port_actor, audit=audit_model, compile=compile_actor_model,
                 backed=TensorBackedModel, forall=forall_actors,
                 expectation=Expectation),
    "jax": dict(actor=jax_actor, audit=jax_audit, compile=jax_compile,
                backed=JaxBacked, forall=jax_forall,
                expectation=JaxExpectation),
}


# -- the handler-lint fixtures, one source for both packages -----------------------


@dataclass(frozen=True)
class TickState:
    n: int


def fixtures(a):
    """The fixture actor classes over one package's actor module ``a``."""
    Actor, Id, Out = a.Actor, a.Id, a.Out

    class DiceActor(Actor):
        def on_start(self, id: Id, out: Out):
            return 0

        def on_msg(self, id: Id, state, src: Id, msg, out: Out):
            return int(random.random() * 10)  # AH201

    class ClockActor(Actor):
        def on_start(self, id: Id, out: Out):
            return 0

        def on_msg(self, id: Id, state, src: Id, msg, out: Out):
            return int(time.time()) % 2  # AH201

    class MutActor(Actor):
        def on_start(self, id: Id, out: Out):
            return 0

        def on_msg(self, id: Id, state, src: Id, msg, out: Out):
            state.items.append(msg)  # AH203: a mutating method call
            state.count = 1  # AH203: an assignment into the state
            return state

    class CopyActor(Actor):
        def on_start(self, id: Id, out: Out):
            return (0,)

        def on_msg(self, id: Id, state, src: Id, msg, out: Out):
            state = list(state)  # a fresh local copy under the same name
            state.append(msg)
            return tuple(state)

    class SetActor(Actor):
        def on_start(self, id: Id, out: Out):
            return 0

        def on_msg(self, id: Id, state, src: Id, msg, out: Out):
            for peer in {Id(1), Id(2)}:  # AH202: hash-ordered sends
                out.send(peer, msg)
            return None

    class ListActor(Actor):
        def on_start(self, id: Id, out: Out):
            return []  # AH204: unhashable

        def on_msg(self, id: Id, state, src: Id, msg, out: Out):
            return None

    class Ticker(Actor):
        def on_start(self, id: Id, out: Out):
            out.send(id, ("tick",))
            return TickState(0)

        def on_msg(self, id: Id, state, src: Id, msg, out: Out):
            out.send(id, ("tick",))
            return TickState(state.n + 1)  # AH205 under the deep probe

    return {"dice": DiceActor, "clock": ClockActor, "mut": MutActor,
            "copy": CopyActor, "set": SetActor, "list": ListActor,
            "ticker": Ticker}


FIXTURES = {name: fixtures(p["actor"]) for name, p in PACKAGES.items()}
EXPECTED = {
    "dice": {("AH201", Severity.ERROR)},
    "clock": {("AH201", Severity.ERROR)},
    "mut": {("AH203", Severity.ERROR)},
    "copy": set(),
    "set": {("AH202", Severity.WARNING)},
    "list": {("AH204", Severity.ERROR)},
    "ticker": {("AH205", Severity.WARNING)},
}


def actor_model(pkg: str, name: str):
    a = PACKAGES[pkg]["actor"]
    m = a.ActorModel(cfg=None)
    m.actor(FIXTURES[pkg][name]())
    m.init_network_(a.Network.new_unordered_nonduplicating())
    return m


def rules(report, prefixes=("AH", "CF")) -> set:
    return {(f.rule_id, f.severity) for f in report.findings
            if f.rule_id.startswith(prefixes)}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_handler_lint_fixture_gives_the_jax_findings(name):
    deep = name == "ticker"
    port = audit_model(actor_model("port", name), deep=deep)
    ref = jax_audit(actor_model("jax", name), deep=deep)
    assert rules(port) == rules(ref) == EXPECTED[name], port.format()
    # the same locations, lines included (one source for both)
    assert sorted(f.location for f in port.findings) == sorted(
        f.location for f in ref.findings if f.rule_id.startswith("AH"))


def test_mutation_fixture_finds_both_mutations():
    hits = audit_model(actor_model("port", "mut")).by_rule("AH203")
    assert len(hits) == 2 and "MutActor" in hits[0].location


def test_unbounded_domain_downgraded_with_state_bound():
    """AH205 drops to info when the compiled twin declares a
    ``state_bound`` (``_has_state_bound``), in both packages."""
    got = {}
    for pkg, p in PACKAGES.items():
        compile_fn, base = p["compile"], p["backed"]
        a = p["actor"]

        class BoundedTicker(base, a.ActorModel):
            def tensor_model(self):
                return compile_fn(self, state_bound=lambda i, s: s.n <= 3)

        m = BoundedTicker(cfg=None, init_history=None)
        m.actor(FIXTURES[pkg]["ticker"]())
        m.init_network_(a.Network.new_unordered_nonduplicating())
        m.property(p["expectation"].ALWAYS, "trivial",
                   p["forall"](lambda i, s: True))
        report = p["audit"](m, deep=True)
        got[pkg] = rules(report)
        assert report.ok and not [f for f in report.warnings
                                  if f.rule_id.startswith("AH")]
    assert got["port"] == got["jax"] == {("AH205", Severity.INFO)}


# -- the config rules ------------------------------------------------------------------


def test_config_mutation_after_resolution_flagged(monkeypatch):
    """CF301: ``_config_mutated`` raises only after the first fingerprint;
    the audit flags the silent window before it, and the preflight aborts
    the spawn before the engine allocates anything."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxSys

    for model, audit in ((TwoPhaseSys(3), audit_model),
                         (JaxSys(3), jax_audit)):
        assert model._tensor_cached() is not None
        model.rm_count = 2  # a direct write: no _config_mutated
        assert rules(audit(model)) == {("CF301", Severity.ERROR)}
    m = TwoPhaseSys(3)
    m._tensor_cached()
    m.rm_count = 2

    def allocate(*a, **k):
        raise AssertionError("the engine was built despite the audit error")

    monkeypatch.setattr(GpuChecker, "__init__", allocate)
    with pytest.raises(AuditError, match="CF301") as ei:
        m.checker().spawn_gpu(device="cpu")
    assert ei.value.rule_ids == ("CF301",)
    assert "spawn_gpu(TwoPhaseSys)" in str(ei.value)


class _PortTwin(TensorModel):
    """A conformant twin whose width comes from a dict the signature
    cannot see into by value (it signs the dict's content, not its
    identity: the deep re-resolve catches what it misses)."""

    max_actions = 1

    def __init__(self, model):
        self.model = model
        self.width = model.cfg["w"]

    def init_rows(self):
        return np.zeros((1, self.width), np.uint64)

    def encode_state(self, s):
        return (int(s),) * self.width

    def decode_state(self, row):
        return int(row[0])

    def step_rows(self, rows):
        return rows[:, None, :] + 1, (rows[..., 0] < 1)[:, None]

    def property_masks(self, rows):
        return torch.ones((rows.shape[0], 1), dtype=torch.bool)


class _JaxTwin(_PortTwin, JaxTwin):
    def step_rows(self, rows):
        return (rows + jnp.uint64(1))[:, None, :], (rows[..., 0] <
                                                    jnp.uint64(1))[:, None]

    def property_masks(self, rows):
        return jnp.ones((rows.shape[0], 1), bool)


def host_model(backed, base, prop, twin_cls, tensor_fn=None):
    class DictCfg(backed, base):
        def __init__(self):
            self.cfg = {"w": 1}

        def tensor_model(self):
            return tensor_fn(self) if tensor_fn else twin_cls(self)

        def init_states(self):
            return [0]

        def actions(self, s):
            return [0] if s < 1 else []

        def next_state(self, s, a):
            return s + 1

        def properties(self):
            return [prop.always("ok", lambda m, s: True)]

    return DictCfg()


HOSTS = {"port": (TensorBackedModel, Model, Property, _PortTwin, audit_model),
         "jax": (JaxBacked, JaxModel, JaxProperty, _JaxTwin, jax_audit)}


@pytest.mark.parametrize("pkg", list(HOSTS))
def test_config_mutation_invisible_to_the_signature_caught_deep(pkg):
    backed, base, prop, twin, audit = HOSTS[pkg]
    m = host_model(backed, base, prop, twin)
    assert m._tensor_cached() is not None
    sig = config_signature(m)
    m.cfg["w"] = 2
    assert ("CF301", Severity.ERROR) in rules(audit(m, deep=True))
    if pkg == "port":
        assert config_signature(m) != sig  # the dict is signed by content


def _no_twin(model):
    raise NotImplementedError("no twin for this configuration")


@pytest.mark.parametrize("pkg", list(HOSTS))
@pytest.mark.parametrize("fn", [_no_twin, lambda model: None])
def test_a_model_without_a_twin_is_cf302_info(pkg, fn):
    backed, base, prop, twin, audit = HOSTS[pkg]
    report = audit(host_model(backed, base, prop, twin, tensor_fn=fn))
    assert rules(report) == {("CF302", Severity.INFO)} and report.ok


def test_report_surface():
    r = AuditReport(model="M")
    r.add("AH202", Severity.WARNING, "actor[0] A.on_msg:3", "x")
    r.add("CF301", Severity.ERROR, "builder", "y")
    assert len(r.findings) == 2 and not r.ok
    assert r.rule_ids() == {"AH202", "CF301"}
    assert (len(r.errors), len(r.warnings), len(r.infos)) == (1, 1, 0)
    assert r.format().splitlines()[1].startswith("  ERROR   CF301")
    assert r.format(min_severity=Severity.ERROR).count("\n") == 1
    c = r.copy()
    c.add("CF302", Severity.INFO, "tensor_model", "z")
    assert len(r.findings) == 2  # a copy has its own findings
    assert AuditError(r).rule_ids == ("CF301",)


# -- the shipped models ----------------------------------------------------------------


SHIPPED = ["two_phase_commit", "paxos", "linearizable_register",
           "single_copy_register", "write_once_register", "increment",
           "increment_lock", "raft", "dining", "quickstart"]


def test_every_model_module_has_an_audit_hook():
    from stateright_tpu_torch import models

    assert set(SHIPPED) | {"orl"} == set(models.__all__)


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_models_audit_like_jax(name):
    """Every shipped configuration audits free of errors, and of warnings
    but for the quickstart's Lamport clocks (two AH205, pinned), with the
    JAX package's AH and CF findings."""
    import importlib

    port = importlib.import_module(f"stateright_tpu_torch.models.{name}")
    ref = importlib.import_module(f"stateright_tpu.models.{name}")
    for (label, pm), (_, jm) in zip(port._audit_models([]),
                                    ref._audit_models([])):
        pr = audit_model(pm, deep=True)
        assert pr.ok, pr.format()
        if label.endswith("lamport_clocks"):
            assert {f.rule_id for f in pr.warnings} == {"AH205"}
            assert len(pr.warnings) == 2
        else:
            assert not pr.warnings, pr.format()
        assert rules(pr) == rules(jax_audit(jm, deep=True)), label


def test_fleet_audit_is_clean(capsys):
    assert _cli.fleet_audit() == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("audit fleet: CLEAN")
    # eleven modules, and quickstart has three configurations
    assert out.count("--- ") == 13


# -- the preflight ----------------------------------------------------------------------


def test_preflight_warns_once_and_never_masks_the_engines_error(capsys):
    m = actor_model("port", "set")  # an AH202 warning, and no device twin
    for _ in range(2):
        with pytest.raises(TypeError, match="has no tensor form"):
            m.checker().spawn_gpu(device="cpu")
    err = capsys.readouterr().err
    assert err.count("AH202") == 1


def test_an_exception_in_the_audit_never_masks_the_engine(monkeypatch):
    import stateright_tpu_torch.analysis as analysis

    def broken(*a, **k):
        raise RuntimeError("audit bug")

    monkeypatch.setattr(analysis, "audit_model", broken)
    with pytest.raises(TypeError, match="has no tensor form"):
        actor_model("port", "dice").checker().spawn_gpu(device="cpu")


def test_preflight_error_aborts_and_the_switches_turn_it_off(monkeypatch):
    m = TwoPhaseSys(3)
    m._tensor_cached()
    m.rm_count = 2
    with pytest.raises(AuditError):
        m.checker().spawn_gpu(device="cpu", batch=64)
    c = m.checker().skip_audit().spawn_gpu(device="cpu", batch=64).join()
    assert c.unique_state_count() == 288  # the cached twin's space
    monkeypatch.setenv("STATERIGHT_TPU_SKIP_AUDIT", "1")
    c = m.checker().spawn_gpu(device="cpu", batch=64).join()
    assert c.unique_state_count() == 288


def test_preflight_is_cached_by_configuration(monkeypatch):
    """The light tier runs once per configuration: a respawn, and a fresh
    model of the same configuration, hit the cache."""
    from stateright_tpu_torch.analysis import audit as audit_mod

    calls = []
    lint = audit_mod.run_handler_lint

    def counted(*a, **k):
        calls.append(1)
        return lint(*a, **k)

    monkeypatch.setattr(audit_mod, "run_handler_lint", counted)
    monkeypatch.setattr(audit_mod, "_SHARED_REPORTS", {})
    from stateright_tpu_torch.models.single_copy_register import (
        single_copy_model,
    )

    for _ in range(3):
        single_copy_model(1).checker()._preflight_audit()
    assert len(calls) == 1


def test_builder_audit_is_the_deep_tier(monkeypatch):
    """The closure probe (AH205) runs in the deep tier only: the light
    tier the preflight runs leaves it out (with an empty process-wide
    cache: a deep report cached earlier also serves a light request), and
    ``.audit()`` is deep."""
    from stateright_tpu_torch.analysis import audit as audit_mod

    monkeypatch.setattr(audit_mod, "_SHARED_REPORTS", {})
    assert not actor_model("port", "ticker").checker().audit(
        deep=False).warnings
    m = actor_model("port", "ticker")
    assert ("AH205", Severity.WARNING) in rules(m.checker().audit())


# -- the audit verbs ----------------------------------------------------------------------


def test_model_audit_verb(capsys):
    assert two_phase_commit.main(["audit"]) == 0
    out = capsys.readouterr().out
    assert "--- two_phase_commit rm=3" in out and "0 error(s)" in out


def test_fleet_audit_entry(capsys):
    assert _cli.main(["audit", "two_phase_commit", "quickstart"]) == 0
    out = capsys.readouterr().out
    assert "AH205" in out and "audit fleet: CLEAN" in out

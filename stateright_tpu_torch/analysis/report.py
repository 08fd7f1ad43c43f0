"""Structured audit results: findings, severities and the report surface.

The port's own copy of ``stateright_tpu/analysis/report.py``.  Every
static-analysis pass (``kernel_audit``, ``sanitizer``, ``handler_lint``,
the config drift check, and for callers that fold them in, the
independence analysis and the cost model) produces :class:`AuditFinding`
values; :class:`AuditReport` gathers them per model with their metrics
(per-row FLOPs and bytes, the sanitizer summary).  The report is the one artifact shared by the
``spawn_gpu`` preflight (errors abort before any buffer is allocated),
``CheckerBuilder.audit()`` and the ``audit`` CLI verbs.

Rule-id namespaces (the JAX package's ``docs/analysis.md`` catalogue):

 - ``AH*`` -- actor-handler lint (``analysis/handler_lint.py``)
 - ``CF*`` -- builder/config lifecycle checks (``analysis/audit.py``)
 - ``JX0*``/``JX1*`` -- the kernel audit (``analysis/kernel_audit.py``)
 - ``JX2*`` -- the static sanitizer (``analysis/sanitizer.py``)
 - ``JX3*`` -- the independence pass (``analysis/independence.py``)
 - ``JX4*`` -- the cost model's tensor-core candidates
   (``analysis/costmodel.py``)

The ``JX*`` passes walk the captured aten graph of ``analysis/graph.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class Severity:
    """Ordered severity levels.  ``ERROR`` findings abort the ``spawn_gpu``
    preflight; ``WARNING`` findings print once; ``INFO`` findings are
    advisory (downgraded rules)."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

    @classmethod
    def rank(cls, sev: str) -> int:
        return cls._ORDER.get(sev, 3)


@dataclass(frozen=True)
class AuditFinding:
    """One diagnostic: a stable rule id, a severity, where, and why."""

    rule_id: str
    severity: str
    location: str  # e.g. "tensor_model", "actor[2].on_msg:14", "builder"
    message: str

    def format(self) -> str:
        return f"{self.severity.upper():7s} {self.rule_id} {self.location}: {self.message}"


@dataclass
class AuditReport:
    """All findings for one model, and ``metrics``: non-finding
    diagnostics -- per-kernel FLOPs/bytes (``metrics["step_rows"]``,
    ``["property_masks"]``), the sanitizer summary
    (``metrics["sanitizer"]``), and where folded in, the independence and
    cost-model summaries."""

    model: str = ""
    findings: list = field(default_factory=list)
    metrics: dict = field(default_factory=dict)

    def copy(self) -> "AuditReport":
        """A copy with its own findings list and metrics dict: the
        process-wide cache hands each model its own report."""
        return AuditReport(model=self.model, findings=list(self.findings),
                           metrics=dict(self.metrics))

    def add(self, rule_id: str, severity: str, location: str, message: str) -> None:
        self.findings.append(AuditFinding(rule_id, severity, location, message))

    def extend(self, findings) -> None:
        """Append findings, skipping exact duplicates: several passes and
        cache re-extends fold into one report without repeating a
        finding."""
        seen = set(self.findings)
        for f in findings:
            if f not in seen:
                self.findings.append(f)
                seen.add(f)

    def merge(self, other: "AuditReport") -> "AuditReport":
        """Fold another pass's report into this one: findings dedupe (see
        :meth:`extend`), metrics merge without overwriting this report's
        entries.  Returns self."""
        self.extend(other.findings)
        for k, v in other.metrics.items():
            self.metrics.setdefault(k, v)
        return self

    # -- queries -------------------------------------------------------------

    @property
    def errors(self) -> list:
        return [f for f in self.findings if f.severity == Severity.ERROR]

    @property
    def warnings(self) -> list:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    @property
    def infos(self) -> list:
        return [f for f in self.findings if f.severity == Severity.INFO]

    @property
    def ok(self) -> bool:
        """No errors (warnings/infos permitted)."""
        return not self.errors

    def by_rule(self, rule_id: str) -> list:
        return [f for f in self.findings if f.rule_id == rule_id]

    def rule_ids(self) -> set:
        return {f.rule_id for f in self.findings}

    # -- rendering -----------------------------------------------------------

    def format(self, min_severity: str = Severity.INFO) -> str:
        """Human-readable report, most severe first."""
        cut = Severity.rank(min_severity)
        shown = sorted(
            (f for f in self.findings if Severity.rank(f.severity) <= cut),
            key=lambda f: (Severity.rank(f.severity), f.rule_id, f.location),
        )
        head = (
            f"audit {self.model}: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s), {len(self.infos)} info"
        )
        lines = [head] + ["  " + f.format() for f in shown]
        if "step_rows" in self.metrics:
            m = self.metrics["step_rows"]
            lines.append(
                "  perf: step_rows ~{flops:.0f} flops/row, "
                "~{bytes:.0f} bytes/row, {eqns} operations".format(
                    flops=m.get("flops_per_row", 0.0),
                    bytes=m.get("bytes_per_row", 0.0),
                    eqns=m.get("eqns", 0),
                )
            )
        return "\n".join(lines)

    def to_json(self) -> dict:
        """A JSON-safe dict for the Explorer's ``/.status`` and tooling
        (JAX ``analysis/report.py:153``)."""
        return {
            "model": self.model,
            "ok": self.ok,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "infos": len(self.infos),
            "findings": [
                {
                    "rule_id": f.rule_id,
                    "severity": f.severity,
                    "location": f.location,
                    "message": f.message,
                }
                for f in self.findings
            ],
            "metrics": self.metrics,
        }


class AuditError(RuntimeError):
    """Preflight audit found errors; raised by ``spawn_gpu`` before any
    device work happens.  Carries the full report plus ``rule_ids`` — the
    error-severity rule ids, machine-readable for CLI exit paths.
    Silence deliberately with ``CheckerBuilder.skip_audit()``."""

    def __init__(self, report: AuditReport, context: Optional[str] = None):
        self.report = report
        self.rule_ids: tuple = tuple(
            sorted({f.rule_id for f in report.errors})
        )
        prefix = f"{context}: " if context else ""
        super().__init__(
            prefix
            + "preflight audit failed (skip_audit() to override)\n"
            + report.format(min_severity=Severity.WARNING)
        )

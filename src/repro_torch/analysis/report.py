"""Findings and reports for the static schedule verifier.

A verification run produces an :class:`AnalysisReport`: a flat list of
:class:`Finding`\\ s, each attributed to a pass and an op, so CI output /
the CLI can say *exactly which invariant broke on which layer* instead
of a bare nonzero exit.
"""
from __future__ import annotations

from collections.abc import Iterable, Sequence
from dataclasses import dataclass, field

#: the verifier's pass catalog (see repro_torch.analysis.__doc__): the
#: reference's five, and ``launch`` for the CUDA kernels' own launches
PASSES = ("coverage", "residency", "race", "accounting", "determinism",
          "launch")

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One violated (or suspicious) invariant.

    ``pass_name`` names the verifier pass (:data:`PASSES`); ``op`` the
    schedule entry / file location it anchors to; ``message`` the precise
    diagnostic (expected vs found)."""
    pass_name: str
    op: str
    message: str
    severity: str = "error"

    def __post_init__(self) -> None:
        if self.pass_name not in PASSES:
            raise ValueError(f"unknown pass {self.pass_name!r}; "
                             f"known: {PASSES}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"known: {SEVERITIES}")

    def __str__(self) -> str:
        return f"[{self.pass_name}] {self.op}: {self.message}"


class ScheduleVerificationError(RuntimeError):
    """A schedule (or scheduler source file) failed static verification.
    Carries the full report so handlers can enumerate the findings."""

    def __init__(self, report: AnalysisReport) -> None:
        self.report = report
        super().__init__(report.summary())


@dataclass
class AnalysisReport:
    """Outcome of one verification run: what was checked, what failed."""
    label: str = ""
    findings: list[Finding] = field(default_factory=list)
    checked_ops: int = 0
    checked_files: int = 0

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def add(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def merge(self, other: AnalysisReport) -> None:
        self.findings.extend(other.findings)
        self.checked_ops += other.checked_ops
        self.checked_files += other.checked_files

    def summary(self) -> str:
        head = self.label or "analysis"
        counts = (f"{self.checked_ops} op(s)"
                  + (f", {self.checked_files} file(s)"
                     if self.checked_files else ""))
        if self.ok and not self.warnings:
            return f"[{head}] OK: {counts} verified, 0 findings"
        lines = [f"[{head}] {'FAIL' if not self.ok else 'OK'}: {counts} "
                 f"verified, {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        lines.extend(f"  {f}" for f in self.findings)
        return "\n".join(lines)

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise ScheduleVerificationError(self)


def merge_reports(label: str,
                  reports: Sequence[AnalysisReport]) -> AnalysisReport:
    out = AnalysisReport(label=label)
    for r in reports:
        out.merge(r)
    return out

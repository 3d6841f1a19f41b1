"""Findings, rule table and the JSON-shippable :class:`AuditReport`.

Every check in ``occam.audit`` emits :class:`Finding` objects carrying a
stable rule ID (``OCM0xx``), a severity, and a locus (a repo path for
source lints, a logical path like ``plan[vgg_mini].span[2:5]`` for plan
audits). The IDs are a public contract — tests, CI gates and benchmark
stamps key on them — so a rule is never renumbered, only retired.

Rule families:

* ``OCM00x`` — document schema (stray keys, mislabeled versions).
* ``OCM01x`` — closure residency / capacity (paper §III-A/B/C, Eqn. 1).
* ``OCM02x`` — DP cut optimality (paper §III-D).
* ``OCM03x`` — placement geometry (paper §III-E: ppermute bijections,
  conveyor banking, ring/round divisibility, chip accounting).
* ``OCM04x`` — engine routing feasibility (``occam.registry``).
* ``OCM05x`` — serve-loop concurrency (``occam.serve`` asyncio lint).
"""
from __future__ import annotations

import dataclasses
import json

AUDIT_FORMAT_VERSION = 1

ERROR = "error"
WARN = "warn"

_SEVERITIES = (ERROR, WARN)


class AuditError(ValueError):
    """Raised by ``AuditReport.raise_if_error`` / ``audit="error"`` when
    an audit surfaces error-severity findings."""


class AuditWarning(UserWarning):
    """Emitted by the ``audit="warn"`` gate (the default) when an audit
    surfaces error-severity findings but the caller chose not to fail."""


@dataclasses.dataclass(frozen=True)
class Rule:
    """One auditable invariant: what it proves and where the paper says
    it must hold."""

    id: str
    severity: str      # default severity of findings under this rule
    invariant: str     # one-line statement of what a finding violates
    paper: str         # paper section the invariant reproduces


AUDIT_RULES: dict[str, Rule] = {r.id: r for r in (
    Rule("OCM001", ERROR,
         "document top-level keys match the stamped schema version "
         "(no stray blocks, no fields from a later version)", "—"),
    Rule("OCM002", ERROR,
         "document is structurally loadable as a plan/frontier", "—"),
    Rule("OCM010", ERROR,
         "every fitting span's closure residency re-proves: the static "
         "row schedule retains all reuse (ring caps sufficient)",
         "§III-A/B/C"),
    Rule("OCM011", ERROR,
         "every span flagged fits=true has footprint <= capacity under "
         "the plan's quant block (Eqn. 1, byte-denominated)", "§III-D"),
    Rule("OCM012", WARN,
         "a span flagged fits=false actually fits (over-conservative "
         "flag degrades routing to the oracle lower bound)", "§III-D"),
    Rule("OCM020", ERROR,
         "no single-boundary move (shift/add/drop one cut) improves the "
         "plan's cost under any COST_MODE", "§III-D"),
    Rule("OCM021", ERROR,
         "the plan's cuts match the exact brute-force optimum "
         "(small nets)", "§III-D"),
    Rule("OCM022", WARN,
         "the recorded transfer count replays from the cuts under at "
         "least one COST_MODE", "§III-D"),
    Rule("OCM030", ERROR,
         "every slot-level ppermute pairing is a bijection on the "
         "(stage, replica) or packed chip mesh", "§III-E"),
    Rule("OCM031", ERROR,
         "serving geometry divides: round_batch is a positive multiple "
         "of the round width, ring_depth is one round per stage",
         "§III-E"),
    Rule("OCM032", ERROR,
         "chip accounting holds: pipeline chips == sum(replicas) and "
         "fit the fleet budget", "§III-E"),
    Rule("OCM033", ERROR,
         "output conveyor bank rows cover all rounds injectively within "
         "ceil(rounds/stages) slots per row", "§III-E"),
    Rule("OCM040", ERROR,
         "every routed engine is registered", "—"),
    Rule("OCM041", ERROR,
         "the span's compute dtype sits inside the routed engine's "
         "declared dtype envelope", "—"),
    Rule("OCM042", ERROR,
         "the routed engine accepts the span (tile shape, residency "
         "proof, oversized lower-bound rules)", "§III-C"),
    Rule("OCM043", ERROR,
         "pipeline-placed spans route to an engine with an SPMD stage "
         "body (directly or via fallback)", "§III-E"),
    Rule("OCM050", ERROR,
         "no blocking call (time.sleep, block_until_ready, sync "
         "Session.pump) inside an async def body", "—"),
    Rule("OCM051", ERROR,
         "no unguarded shared-state mutation from a callable handed "
         "off the event loop (thread target / executor job)", "—"),
)}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one locus."""

    rule: str
    severity: str
    locus: str
    message: str
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.rule not in AUDIT_RULES:
            raise ValueError(f"unknown audit rule {self.rule!r}")
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "locus": self.locus, "message": self.message,
                "detail": dict(self.detail)}

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(rule=str(d["rule"]), severity=str(d["severity"]),
                   locus=str(d["locus"]), message=str(d["message"]),
                   detail=dict(d.get("detail") or {}))


def finding(rule: str, locus: str, message: str, **detail) -> Finding:
    """A :class:`Finding` at the rule's default severity."""
    return Finding(rule, AUDIT_RULES[rule].severity, locus, message,
                   detail)


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """The outcome of one ``occam.audit`` pass — JSON-shippable like
    plans, so CI gates and benchmark artifacts can persist the verdict
    next to the thing they audited."""

    subject: str
    findings: tuple[Finding, ...] = ()

    @property
    def ok(self) -> bool:
        """True when no error-severity finding survived (warnings do
        not fail an audit)."""
        return not self.errors

    @property
    def errors(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def warnings(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == WARN)

    def rules(self) -> tuple[str, ...]:
        """Distinct rule IDs present, sorted — the stable signature a
        corpus test keys on."""
        return tuple(sorted({f.rule for f in self.findings}))

    def merged(self, other: "AuditReport") -> "AuditReport":
        return AuditReport(self.subject, self.findings + other.findings)

    def summary(self) -> str:
        if not self.findings:
            return f"audit clean: {self.subject}"
        head = ", ".join(f"{f.rule}({f.severity})" for f in self.findings)
        return (f"audit of {self.subject}: {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s) [{head}]")

    def raise_if_error(self) -> "AuditReport":
        if not self.ok:
            lines = [self.summary()]
            lines += [f"  {f.rule} @ {f.locus}: {f.message}"
                      for f in self.errors]
            raise AuditError("\n".join(lines))
        return self

    def verdict(self) -> dict:
        """The compact stamp benchmark artifacts embed: pass/fail plus
        the rule signature (never the full finding list)."""
        return {"ok": self.ok, "rules": list(self.rules()),
                "findings": len(self.findings)}

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {"version": AUDIT_FORMAT_VERSION, "subject": self.subject,
                "ok": self.ok,
                "findings": [f.to_dict() for f in self.findings]}

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "AuditReport":
        version = d.get("version")
        if version != AUDIT_FORMAT_VERSION:
            raise ValueError(f"unsupported audit report version "
                             f"{version!r} (this build reads "
                             f"{AUDIT_FORMAT_VERSION})")
        return cls(subject=str(d.get("subject", "")),
                   findings=tuple(Finding.from_dict(f)
                                  for f in d.get("findings", ())))

    @classmethod
    def from_json(cls, doc: str) -> "AuditReport":
        return cls.from_dict(json.loads(doc))

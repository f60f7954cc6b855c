"""Typed findings emitted by the ``repro_torch.analysis`` passes.

Every analyzer — the trace-based schedule-conformance passes and the
AST lints — reports problems as :class:`Finding` records so the CLI,
tests and CI share one serialization (JSON) and one human rendering.  A
finding is identified by a short stable ``code`` (catalogued in the
README) plus a free-form message; ``path``/``line`` locate it when it
maps to source.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = ["Finding", "findings_to_json", "render_findings"]

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One problem located by an analysis pass.

    ``code`` is a stable machine-readable identifier (e.g.
    ``SCHED-AG-COUNT``, ``DET-RANDOM``); ``detail`` carries
    pass-specific JSON-serializable context (expected/actual values,
    operand names, ...).
    """

    code: str
    message: str
    severity: str = ERROR
    path: Optional[str] = None
    line: Optional[int] = None
    detail: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
        }
        if self.path is not None:
            d["path"] = self.path
        if self.line is not None:
            d["line"] = self.line
        if self.detail:
            d["detail"] = dict(self.detail)
        return d

    def format(self) -> str:
        loc = ""
        if self.path is not None:
            loc = f"{self.path}:{self.line}: " if self.line else f"{self.path}: "
        return f"{loc}{self.severity}[{self.code}] {self.message}"


def findings_to_json(findings: Iterable[Finding], **extra: Any) -> str:
    """Serialize findings (plus top-level metadata) to a JSON document."""
    fs: List[Finding] = list(findings)
    doc: Dict[str, Any] = {
        "findings": [f.to_dict() for f in fs],
        "num_findings": len(fs),
        "num_errors": sum(1 for f in fs if f.severity == ERROR),
    }
    doc.update(extra)
    return json.dumps(doc, indent=2, sort_keys=True)


def render_findings(findings: Iterable[Finding],
                    header: Optional[str] = None) -> str:
    """Human-readable multi-line rendering; empty-finding sets say so."""
    fs = list(findings)
    lines: List[str] = []
    if header:
        lines.append(header)
    if not fs:
        lines.append("no findings")
    lines.extend(f.format() for f in fs)
    return "\n".join(lines)

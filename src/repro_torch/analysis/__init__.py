"""``repro_torch.analysis`` — static analysis for the DynaComm port.

Two layers:

* **trace analyzers** (:mod:`repro_torch.analysis.trace`,
  :mod:`repro_torch.analysis.conformance`) — a recorder of the
  ``torch.distributed`` calls an executed window makes (the port has no
  compiled HLO: it takes the place of the reference's ``analysis/hlo.py``
  and ``launch/hlo_analysis.py``) and the schedule-conformance passes
  proving a step runs exactly the collectives its ``BucketPlan``
  prescribes, with operand and wire bytes matching the
  ``FlatSpec``/``Compressor`` byte math;
* **AST lints** (:mod:`repro_torch.analysis.lints`) — repo-specific
  determinism hazards (unseeded RNG, torch's default generator included,
  wall-clock in event loops, order-sensitive param-tree walks,
  hard-coded kernel ``interpret=``, deprecated import aliases).

CLI: ``python -m repro_torch.analysis lint src/repro_torch`` and
``python -m repro_torch.analysis verify --config <runtime config>``.

This package imports no torch at the top level
(``repro_torch.analysis.runtime_verify``, which drives a built runtime,
is imported lazily by the CLI; the recorder imports ``torch.distributed``
when a window opens), so lints and conformance over hand-built traces
stay usable in import-light contexts.
"""

from repro_torch.analysis.conformance import (expected_ag_bytes,
                                              expected_rs_bytes,
                                              independent_wire_bytes,
                                              segment_wire_bytes,
                                              verify_cache,
                                              verify_fleet_membership,
                                              verify_no_collectives,
                                              verify_push_ledger,
                                              verify_schedule,
                                              verify_wire_model)
from repro_torch.analysis.findings import (Finding, findings_to_json,
                                           render_findings)
from repro_torch.analysis.lints import (LINT_CODES, LintConfig, lint_file,
                                        lint_paths, lint_source)
from repro_torch.analysis.trace import (COLLECTIVES, CollectiveRecord,
                                        collective_counts,
                                        collective_summary,
                                        record_collectives)

__all__ = [
    "COLLECTIVES", "CollectiveRecord", "Finding", "LINT_CODES",
    "LintConfig", "collective_counts", "collective_summary",
    "expected_ag_bytes", "expected_rs_bytes", "findings_to_json",
    "independent_wire_bytes", "lint_file", "lint_paths", "lint_source",
    "record_collectives", "render_findings", "segment_wire_bytes",
    "verify_cache", "verify_fleet_membership", "verify_no_collectives",
    "verify_push_ledger", "verify_schedule", "verify_wire_model",
]

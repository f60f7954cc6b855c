"""``python -m repro_torch.analysis`` — lint and verify subcommands.

``lint`` walks source trees with the AST lints (torch never imported);
``verify`` builds a runtime from a ``RuntimeConfig`` JSON, runs it and
holds the collectives it records against the plan.  Both print the human
rendering, write the findings JSON with ``--json``, and exit non-zero iff
any error-severity finding was produced — which is what gates CI.

``verify`` runs on the card by default (one NCCL rank; it raises without
a card, with no fallback).  ``--device cpu`` runs the plain PyTorch
path on the host, where ``--devices N`` (default 2, the reference's
forged device count) spawns N gloo ranks for the regimes that run over a
process group (``zero``, ``ps``, ``dynamic``, ``dynamic-ps``); every
other regime runs on one rank.  Each rank records its own trace, and the
findings of all ranks are reported.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import (ERROR, Finding, findings_to_json,
                                           render_findings)

#: regimes whose step runs collectives over a process group
PROCESS_GROUP_REGIMES = ("zero", "ps", "dynamic", "dynamic-ps")

Result = Tuple[List[Finding], Dict[str, Any]]


def _write_json(path: str, findings: List[Finding], **extra) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(findings_to_json(findings, **extra))
        f.write("\n")


def _exit_code(findings: List[Finding]) -> int:
    return 1 if any(f.severity == ERROR for f in findings) else 0


def _run_lint(args: argparse.Namespace) -> int:
    from repro_torch.analysis.lints import lint_paths
    findings = lint_paths(args.paths)
    print(render_findings(
        findings,
        header=f"lint over {', '.join(args.paths)}: "
               f"{len(findings)} finding(s)"))
    if args.json_path:
        _write_json(args.json_path, findings, command="lint",
                    paths=list(args.paths))
    return _exit_code(findings)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finding(d: Dict[str, Any]) -> Finding:
    return Finding(code=d["code"], message=d["message"],
                   severity=d["severity"], path=d.get("path"),
                   line=d.get("line"), detail=d.get("detail", {}))


def _rank_main(rank: int, world: int, port: int, paths: List[str],
               steps: Optional[int], out: str) -> None:
    """One gloo rank: verify each config in turn; rank 0 writes every
    rank's findings (each distinct finding once) and its own info."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.runtime_verify import verify_runtime
    from repro_torch.runtime.config import RuntimeConfig
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        results = []
        for path in paths:
            findings, info = verify_runtime(RuntimeConfig.load(path),
                                            steps=steps, device="cpu")
            every: List[Any] = [None] * world
            dist.all_gather_object(every, [f.to_dict() for f in findings])
            merged: List[Dict[str, Any]] = []
            for part in every:
                merged.extend(f for f in part if f not in merged)
            results.append({"findings": merged, "info": info})
        if rank == 0:
            with open(out, "w", encoding="utf-8") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def verify_on_ranks(paths: Sequence[str], world: int,
                    steps: Optional[int] = None) -> List[Result]:
    """Verify each config on ``world`` gloo CPU ranks (spawned once for
    all of them); one ``(findings, info)`` per config."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "verify.json")
        mp.spawn(_rank_main, args=(world, _free_port(), list(paths), steps,
                                   out), nprocs=world)
        with open(out, encoding="utf-8") as f:
            results = json.load(f)
    return [([_finding(d) for d in r["findings"]], r["info"])
            for r in results]


def _run_verify(args: argparse.Namespace) -> int:
    from repro_torch.runtime.config import RuntimeConfig
    config = RuntimeConfig.load(args.config)
    ranks = 1
    if args.device == "cpu" and args.devices > 1 and \
            config.runtime in PROCESS_GROUP_REGIMES:
        ranks = args.devices
        [(findings, info)] = verify_on_ranks([args.config], ranks,
                                             args.steps)
    else:
        from repro_torch.analysis.runtime_verify import verify_runtime
        findings, info = verify_runtime(
            config, steps=args.steps,
            device="cpu" if args.device == "cpu" else None)
    print(render_findings(
        findings,
        header=f"verify {args.config} [{config.runtime}, {args.device}, "
               f"{ranks} rank(s)]: {len(findings)} finding(s)"))
    if args.json_path:
        _write_json(args.json_path, findings, command="verify",
                    config=args.config, device=args.device, ranks=ranks,
                    info=info)
    return _exit_code(findings)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis: determinism lints + trace-based "
                    "schedule-conformance verification")
    sub = parser.add_subparsers(dest="command", required=True)

    lint_p = sub.add_parser(
        "lint", help="run the AST determinism lints over files/trees")
    lint_p.add_argument("paths", nargs="+",
                        help="python files or directory trees")
    lint_p.add_argument("--json", dest="json_path", default=None,
                        help="also write the findings JSON here")

    verify_p = sub.add_parser(
        "verify", help="build a runtime, run it and verify the "
                       "collectives it records against the plan")
    verify_p.add_argument("--config", required=True,
                          help="RuntimeConfig JSON "
                               "(examples/runtime_configs/*.json)")
    verify_p.add_argument("--steps", type=int, default=None,
                          help="units of progress to run where needed "
                               "(default: regime-appropriate minimum)")
    verify_p.add_argument("--device", choices=("cuda", "cpu"),
                          default="cuda",
                          help="where the runtime runs (default: the "
                               "card, one NCCL rank; raises without one)")
    verify_p.add_argument("--devices", type=int, default=2,
                          help="gloo CPU ranks for the process-group "
                               "regimes with --device cpu (default 2; "
                               "1 = one rank)")
    verify_p.add_argument("--json", dest="json_path", default=None,
                          help="also write the findings JSON here")

    args = parser.parse_args(argv)
    if args.command == "lint":
        return _run_lint(args)
    return _run_verify(args)


if __name__ == "__main__":
    sys.exit(main())

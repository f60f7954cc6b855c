"""AST lints for repo-specific determinism hazards (layer 2).

Five rules, each motivated by a class of bug this codebase has to stay
immune to (bit-identical losses across strategies, deterministic
discrete-event replay, TPU/CPU kernel parity):

* ``DET-RANDOM`` — draws from the *global* ``random`` / legacy
  ``numpy.random`` state, ``default_rng()``/``Random()`` constructed
  without a seed, or torch draws (``torch.rand``/``randn``/``randint``/
  ``randperm``/``normal``/``bernoulli``/``multinomial``/``poisson`` and
  the ``*_like`` draws) without ``generator=``, which read torch's hidden
  default generator.  All randomness must flow from an explicit seed
  (``np.random.default_rng(seed)`` /
  ``torch.Generator(device).manual_seed(seed)``).
* ``DET-WALL-CLOCK`` — wall-clock reads (``time.time``,
  ``perf_counter``, ``datetime.now``, ...) inside the deterministic
  modules (the async event loop, the PS server, the simulator), whose
  replay guarantees break the moment real time leaks in.  Timing code
  elsewhere (profilers, schedulers measuring DP wall time) is
  legitimate and not linted.
* ``DET-DICT-ORDER`` — iteration over ``.items()/.keys()/.values()`` of
  param-tree-shaped dicts without ``sorted(...)``: flatten order must
  not depend on insertion history.
* ``KERNEL-INTERPRET`` — literal ``interpret=True/False`` defaults or
  call arguments in Pallas kernel modules; backend routing must go
  through ``repro._compat.pallas.default_interpret``/
  ``resolve_interpret`` so the same code runs fused on TPU and
  interpreted elsewhere.
* ``DEPRECATED-IMPORT`` — importing names that moved to
  ``repro_torch.runtime.replan`` from the ``repro_torch.dist.dynamic`` /
  ``repro_torch.ps.dynamic`` alias paths.

Suppression: append ``# noqa`` (all codes) or ``# noqa: DET-RANDOM``
(specific codes, comma-separated) to the flagged line.

Stdlib ``ast`` only — no new dependencies.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

__all__ = ["LintConfig", "LINT_CODES", "lint_source", "lint_file",
           "lint_paths"]

LINT_CODES = ("DET-RANDOM", "DET-WALL-CLOCK", "DET-DICT-ORDER",
              "KERNEL-INTERPRET", "DEPRECATED-IMPORT")

#: Names whose canonical home is ``repro_torch.runtime.replan``.
MOVED_REPLAN_NAMES = frozenset({
    "PlanStepCache", "RescheduleEvent", "hlo_collective_counts",
    "sequential_plan", "ReplanMixin"})
DEPRECATED_ALIAS_MODULES = ("repro_torch.dist.dynamic",
                            "repro_torch.ps.dynamic")

# numpy.random attributes that are explicit-seed constructions, not
# draws from the hidden global state.
_NP_RANDOM_SAFE = frozenset({
    "default_rng", "Generator", "SeedSequence", "RandomState", "PCG64",
    "MT19937", "Philox", "SFC64", "BitGenerator"})
# stdlib random attributes that construct an independent RNG object.
_PY_RANDOM_SAFE = frozenset({"Random", "SystemRandom"})
# zero-arg constructors that fall back to OS entropy (unseeded).
_SEEDED_CTORS = frozenset({"default_rng", "Random", "RandomState"})
# torch functions that draw from the default generator unless given
# ``generator=`` (jax has no global RNG state; torch does).
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like"})

_WALL_CLOCK_TIME = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns"})
_WALL_CLOCK_DATETIME = frozenset({"now", "utcnow", "today"})

_PARAM_TREE_NAME = re.compile(
    r"(param|grad|tree|layer|leav|weight)", re.IGNORECASE)

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[\w\-,\s]+))?", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """Where each path-scoped rule applies (suffix / substring match on
    ``/``-normalized paths)."""

    deterministic_modules: Tuple[str, ...] = (
        "core/simulator.py", "core/scheduler.py", "core/planner.py",
        "ps/async_mode.py", "ps/server.py",
        "fleet/engine.py", "fleet/membership.py", "fleet/drift.py",
        "fleet/trainer.py",
        "pipeline/partition.py", "pipeline/schedule.py",
        "pipeline/transfer.py", "pipeline/trainer.py")
    kernel_dirs: Tuple[str, ...] = ("kernels",)


DEFAULT_CONFIG = LintConfig()


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _in_deterministic_module(path: str, config: LintConfig) -> bool:
    p = _norm(path)
    return any(p.endswith(m) for m in config.deterministic_modules)


def _in_kernel_dir(path: str, config: LintConfig) -> bool:
    parts = _norm(path).split("/")
    return any(d in parts for d in config.kernel_dirs)


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost name of a dotted access (``a.b.c`` → ``a``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` as a string, or None for non-trivial expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class _Linter(ast.NodeVisitor):

    def __init__(self, path: str, config: LintConfig):
        self.path = path
        self.config = config
        self.findings: List[Finding] = []
        # module-alias maps built from the file's imports
        self.py_random: Set[str] = set()      # aliases of stdlib `random`
        self.np_aliases: Set[str] = set()     # aliases of `numpy`
        self.np_random: Set[str] = set()      # aliases of `numpy.random`
        self.time_aliases: Set[str] = set()   # aliases of `time`
        self.dt_modules: Set[str] = set()     # aliases of `datetime` module
        self.dt_classes: Set[str] = set()     # `datetime`/`date` classes
        self.unseeded_ctor_aliases: Set[str] = set()  # from-imported ctors
        self.torch_aliases: Set[str] = set()  # aliases of `torch`
        self.torch_draws: Set[str] = set()    # from-imported torch draws
        self.lint_clock = _in_deterministic_module(path, config)
        self.lint_kernel = _in_kernel_dir(path, config)

    def flag(self, code: str, node: ast.AST, message: str, **detail) -> None:
        self.findings.append(Finding(
            code=code, message=message, path=self.path,
            line=getattr(node, "lineno", None), detail=detail))

    # -- imports --------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            asname = alias.asname or alias.name.split(".")[0]
            if alias.name == "random":
                self.py_random.add(asname)
            elif alias.name == "numpy":
                self.np_aliases.add(asname)
            elif alias.name == "numpy.random":
                self.np_random.add(alias.asname or "numpy")
                if alias.asname is None:
                    self.np_aliases.add("numpy")
            elif alias.name == "time":
                self.time_aliases.add(asname)
            elif alias.name == "datetime":
                self.dt_modules.add(asname)
            elif alias.name == "torch" or (
                    alias.name.startswith("torch.") and alias.asname is None):
                self.torch_aliases.add(asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        names = {a.name: (a.asname or a.name) for a in node.names}
        if mod in DEPRECATED_ALIAS_MODULES:
            moved = sorted(set(names) & MOVED_REPLAN_NAMES)
            if moved:
                self.flag(
                    "DEPRECATED-IMPORT", node,
                    f"{', '.join(moved)} moved to "
                    f"repro_torch.runtime.replan; "
                    f"the {mod} alias path is a deprecation shim",
                    module=mod, names=moved)
        if mod == "random":
            drawn = sorted(n for n in names if n not in _PY_RANDOM_SAFE)
            if drawn:
                self.flag(
                    "DET-RANDOM", node,
                    f"from random import {', '.join(drawn)} draws from "
                    f"the global RNG state; use a seeded "
                    f"np.random.default_rng / random.Random instance",
                    names=drawn)
            for n, asname in names.items():
                if n in _SEEDED_CTORS:
                    self.unseeded_ctor_aliases.add(asname)
        elif mod in ("numpy.random", "numpy"):
            if mod == "numpy.random":
                drawn = sorted(n for n in names if n not in _NP_RANDOM_SAFE)
                if drawn:
                    self.flag(
                        "DET-RANDOM", node,
                        f"from numpy.random import {', '.join(drawn)} "
                        f"draws from the legacy global RNG state; use a "
                        f"seeded np.random.default_rng instance",
                        names=drawn)
            if "random" in names and mod == "numpy":
                self.np_random.add(names["random"])
            for n, asname in names.items():
                if n in _SEEDED_CTORS:
                    self.unseeded_ctor_aliases.add(asname)
        elif mod == "time" and self.lint_clock:
            clocks = sorted(set(names) & _WALL_CLOCK_TIME)
            if clocks:
                self.flag(
                    "DET-WALL-CLOCK", node,
                    f"from time import {', '.join(clocks)} inside a "
                    f"deterministic module — event loops must run on "
                    f"simulated time only", names=clocks)
        elif mod == "datetime":
            self.dt_classes.update(
                asname for n, asname in names.items()
                if n in ("datetime", "date"))
        elif mod == "torch":
            self.torch_draws.update(
                asname for n, asname in names.items() if n in _TORCH_DRAWS)
        self.generic_visit(node)

    # -- calls ----------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        self._check_random(node)
        if self.lint_clock:
            self._check_wall_clock(node)
        if self.lint_kernel:
            self._check_interpret_call(node)
        self.generic_visit(node)

    def _is_unseeded(self, node: ast.Call) -> bool:
        return not node.args and not any(
            kw.arg in ("seed", "x") or kw.arg is None for kw in node.keywords)

    def _without_generator(self, node: ast.Call) -> bool:
        return not any(kw.arg in ("generator", None) for kw in node.keywords)

    def _flag_torch_draw(self, node: ast.Call, name: str) -> None:
        self.flag("DET-RANDOM", node,
                  f"{name}() without generator= draws from torch's hidden "
                  f"default generator; pass a seeded torch.Generator")

    def _check_random(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id in self.unseeded_ctor_aliases and self._is_unseeded(node):
                self.flag("DET-RANDOM", node,
                          f"{fn.id}() without a seed falls back to OS "
                          f"entropy; pass an explicit seed")
            elif fn.id in self.torch_draws and self._without_generator(node):
                self._flag_torch_draw(node, fn.id)
            return
        if not isinstance(fn, ast.Attribute):
            return
        attr = fn.attr
        base = _dotted(fn.value)
        if base is None:
            return
        is_np_random = base in self.np_random or any(
            base == f"{np}.random" for np in self.np_aliases)
        if base in self.torch_aliases:
            if attr in _TORCH_DRAWS and self._without_generator(node):
                self._flag_torch_draw(node, f"{base}.{attr}")
        elif base in self.py_random:
            if attr in _SEEDED_CTORS:
                if self._is_unseeded(node):
                    self.flag("DET-RANDOM", node,
                              f"{base}.{attr}() without a seed falls back "
                              f"to OS entropy; pass an explicit seed")
            elif attr not in _PY_RANDOM_SAFE:
                self.flag("DET-RANDOM", node,
                          f"{base}.{attr}() draws from the global RNG "
                          f"state; use a seeded random.Random / "
                          f"np.random.default_rng instance")
        elif is_np_random:
            if attr in _SEEDED_CTORS:
                if self._is_unseeded(node):
                    self.flag("DET-RANDOM", node,
                              f"{base}.{attr}() without a seed falls back "
                              f"to OS entropy; pass an explicit seed")
            elif attr not in _NP_RANDOM_SAFE:
                self.flag("DET-RANDOM", node,
                          f"{base}.{attr}() draws from the legacy global "
                          f"numpy RNG state; use a seeded "
                          f"np.random.default_rng instance")

    def _check_wall_clock(self, node: ast.Call) -> None:
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            return
        base = _dotted(fn.value)
        if base in self.time_aliases and fn.attr in _WALL_CLOCK_TIME:
            self.flag("DET-WALL-CLOCK", node,
                      f"{base}.{fn.attr}() reads the wall clock inside a "
                      f"deterministic module — event loops must run on "
                      f"simulated time only")
        elif fn.attr in _WALL_CLOCK_DATETIME:
            root = _root_name(fn.value)
            if base in self.dt_classes or root in self.dt_modules:
                self.flag("DET-WALL-CLOCK", node,
                          f"{base}.{fn.attr}() reads the wall clock "
                          f"inside a deterministic module")

    def _check_interpret_call(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if kw.arg == "interpret" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, bool):
                self.flag(
                    "KERNEL-INTERPRET", kw.value,
                    f"hard-coded interpret={kw.value.value} pins the "
                    f"Pallas backend; route through "
                    f"repro._compat.pallas.resolve_interpret (None = "
                    f"auto-detect)")

    # -- function defaults ----------------------------------------------

    def _check_interpret_default(self, node) -> None:
        args = node.args
        pairs = list(zip(args.args[len(args.args) - len(args.defaults):],
                         args.defaults))
        pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if arg.arg == "interpret" and isinstance(default, ast.Constant) \
                    and isinstance(default.value, bool):
                self.flag(
                    "KERNEL-INTERPRET", default,
                    f"parameter default interpret={default.value} pins "
                    f"the Pallas backend; default to None and resolve "
                    f"via repro._compat.pallas.resolve_interpret")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if self.lint_kernel:
            self._check_interpret_default(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        if self.lint_kernel:
            self._check_interpret_default(node)
        self.generic_visit(node)

    # -- dict-order walks -----------------------------------------------

    def _dict_walk_target(self, it: ast.AST) -> Optional[str]:
        """Name of a param-tree-ish dict iterated via
        ``.items()/.keys()/.values()`` (None if the iterable is not such
        a walk, or is wrapped in ``sorted``)."""
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                and it.func.attr in ("items", "keys", "values")):
            return None
        base = it.func.value
        name = base.attr if isinstance(base, ast.Attribute) \
            else base.id if isinstance(base, ast.Name) else None
        if name is None or not _PARAM_TREE_NAME.search(name):
            return None
        return f"{name}.{it.func.attr}()"

    def _check_dict_walk(self, iter_node: ast.AST, stmt: ast.AST) -> None:
        target = self._dict_walk_target(iter_node)
        if target:
            self.flag(
                "DET-DICT-ORDER", stmt,
                f"iteration over {target} depends on dict insertion "
                f"order; wrap in sorted(...) so the param-tree walk "
                f"order is canonical")

    def visit_For(self, node: ast.For) -> None:
        self._check_dict_walk(node.iter, node)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_dict_walk(gen.iter, node)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


def _apply_noqa(findings: List[Finding], source: str) -> List[Finding]:
    lines = source.splitlines()
    kept = []
    for f in findings:
        if f.line is not None and 1 <= f.line <= len(lines):
            m = _NOQA_RE.search(lines[f.line - 1])
            if m:
                codes = m.group("codes")
                if codes is None:
                    continue
                suppressed = {c.strip().upper() for c in codes.split(",")}
                if f.code.upper() in suppressed:
                    continue
        kept.append(f)
    return kept


def lint_source(source: str, path: str,
                config: Optional[LintConfig] = None) -> List[Finding]:
    """Lint one module's source text; ``path`` scopes the path-dependent
    rules and labels the findings."""
    config = config or DEFAULT_CONFIG
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(code="PARSE-ERROR", message=str(e.msg), path=path,
                        line=e.lineno or 0)]
    linter = _Linter(path, config)
    linter.visit(tree)
    return _apply_noqa(linter.findings, source)


def lint_file(path: str, config: Optional[LintConfig] = None
              ) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path, config)


def lint_paths(paths: Iterable[str],
               config: Optional[LintConfig] = None) -> List[Finding]:
    """Lint files and/or directory trees (``*.py``), findings in
    path-sorted order."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
        else:
            files.append(p)
    findings: List[Finding] = []
    for path in files:
        findings.extend(lint_file(path, config))
    return findings

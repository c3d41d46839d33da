"""Scheduler-determinism lint — an AST pass over the modeled-virtual-time
code paths.

The zoo scheduler, the fleet, the pipelined CNN server and the fault
injectors all promise that every policy decision, latency percentile and
deadline miss is a **pure function of the seeded trace** (that promise is
what lets the port's tests hold their logs field for field against the
reference's).  This pass statically forbids the ways that promise silently
breaks:

* wall-clock reads (``time.time``/``perf_counter``/``monotonic``/
  ``process_time`` and their ``_ns`` variants, ``time.sleep``,
  ``datetime.now``/``utcnow``);
* nondeterministic randomness: any stdlib ``random.*`` call, any
  ``np.random.*`` call EXCEPT ``default_rng(<seed>)`` with an explicit
  seed argument (an argument-less ``default_rng()`` seeds from the OS),
  ``os.urandom``, ``uuid.uuid4``, and torch's global generator: a call to
  ``torch.rand``, ``randn``, ``randint``, ``randperm``, ``normal``,
  ``bernoulli`` or ``multinomial``, or an in-place ``.normal_()``,
  ``.uniform_()``, ``.random_()`` or ``.bernoulli_()``, without a
  ``generator=`` keyword;
* iteration over unordered sets (``for x in {...}`` / ``set(...)``,
  set-sourced comprehensions, ``list(set(...))``) — hash order is not
  part of the modeled-time contract.  ``sorted``/``min``/``max`` over a
  set are fine.

Draws from an explicit ``torch.Generator`` (``generator=``) are allowed
everywhere, as the reference allows ``jax.random`` (explicitly keyed,
deterministic by construction).  Genuine wall-clock *measurement* code is
exempted by function name (:data:`EXEMPT_FUNCTIONS`) or with an inline
``# det: allow`` pragma on the line.  The reference also lints its
``benchmarks/timing.py``; the port has no counterpart of that module (it
may not import ``benchmarks/``), so its targets are the four serving
modules.
"""
from __future__ import annotations

import ast
from pathlib import Path
from collections.abc import Iterable, Mapping

from repro_torch.analysis.report import AnalysisReport, Finding

#: files whose modeled-virtual-time promise this lint enforces,
#: relative to the repo root
DEFAULT_TARGETS = (
    "src/repro_torch/serve/zoo.py",
    "src/repro_torch/serve/fleet.py",
    "src/repro_torch/serve/cnn_server.py",
    "src/repro_torch/serve/faults.py",
)

#: per-file function names allowed to touch the wall clock: the
#: measurement utilities whose whole job is timing real execution
#: (their outputs never feed a modeled-time decision); none of the
#: port's targets has one
EXEMPT_FUNCTIONS: Mapping[str, frozenset] = {}

#: inline escape hatch: a source line containing this pragma is skipped
ALLOW_PRAGMA = "det: allow"

_WALL_CLOCK = frozenset({
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns", "time.sleep",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
})

_ENTROPY = frozenset({"os.urandom", "uuid.uuid4"})

_NP_RANDOM_PREFIXES = ("np.random.", "numpy.random.")

#: torch draws from the global generator unless given ``generator=``
_TORCH_RANDOM = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
})
_TORCH_RANDOM_INPLACE = frozenset({"normal_", "uniform_", "random_",
                                   "bernoulli_"})


def _dotted_name(node: ast.expr) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_unordered_set(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


class _DeterminismVisitor(ast.NodeVisitor):
    def __init__(self, rel: str, source_lines: list[str],
                 exempt: frozenset) -> None:
        self.rel = rel
        self.lines = source_lines
        self.exempt = exempt
        self.stack: list[str] = []
        self.findings: list[Finding] = []

    # -- helpers ------------------------------------------------------------
    def _skip(self, node: ast.AST) -> bool:
        if any(name in self.exempt for name in self.stack):
            return True
        line = self.lines[node.lineno - 1] \
            if 0 < node.lineno <= len(self.lines) else ""
        return ALLOW_PRAGMA in line

    def _flag(self, node: ast.AST, message: str) -> None:
        if not self._skip(node):
            self.findings.append(Finding(
                "determinism", f"{self.rel}:{node.lineno}", message))

    # -- function scoping ---------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted_name(node.func)
        if not any(kw.arg == "generator" for kw in node.keywords):
            if name in _TORCH_RANDOM:
                self._flag(node, f"{name}() draws from torch's global "
                                 "generator; pass generator=")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TORCH_RANDOM_INPLACE:
                self._flag(node, f".{node.func.attr}() draws from torch's "
                                 "global generator; pass generator=")
        if name is not None:
            if name in _WALL_CLOCK:
                self._flag(node, f"wall-clock call {name}() in a "
                                 "modeled-virtual-time code path")
            elif name in _ENTROPY:
                self._flag(node, f"OS-entropy call {name}() in a "
                                 "modeled-virtual-time code path")
            elif name.startswith("random."):
                self._flag(node, f"stdlib {name}() draws from unseeded "
                                 "global state")
            else:
                for prefix in _NP_RANDOM_PREFIXES:
                    if not name.startswith(prefix):
                        continue
                    if name.split(".")[-1] == "default_rng":
                        if not node.args and not node.keywords:
                            self._flag(node,
                                       f"{name}() without a seed draws "
                                       "OS entropy; pass an explicit "
                                       "seed")
                    else:
                        self._flag(node, f"{name}() uses numpy's global "
                                         "(or unseeded) random state")
                    break
            if name in ("list", "tuple", "enumerate") and node.args \
                    and _is_unordered_set(node.args[0]):
                self._flag(node, f"{name}() over an unordered set fixes "
                                 "an arbitrary hash order")
        self.generic_visit(node)

    # -- unordered iteration -------------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        if _is_unordered_set(node.iter):
            self._flag(node, "for-loop over an unordered set: iteration "
                             "order is not deterministic across runs")
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            if _is_unordered_set(gen.iter):
                self._flag(node, "comprehension over an unordered set: "
                                 "iteration order is not deterministic "
                                 "across runs")
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp


def default_root() -> Path:
    """The repo root this module was imported from
    (``src/repro_torch/analysis`` -> three levels up)."""
    return Path(__file__).resolve().parents[3]


def lint_file(path: Path, *, rel: str = "",
              exempt: frozenset = frozenset()) -> list[Finding]:
    """Run the determinism lint over one Python source file."""
    rel = rel or str(path)
    source = path.read_text()
    tree = ast.parse(source, filename=rel)
    visitor = _DeterminismVisitor(rel, source.splitlines(), exempt)
    visitor.visit(tree)
    return visitor.findings


def lint_scheduler_sources(root: Path | None = None,
                           targets: Iterable[str] = DEFAULT_TARGETS
                           ) -> AnalysisReport:
    """Lint every modeled-virtual-time source file
    (:data:`DEFAULT_TARGETS`) under ``root`` (default: this repo)."""
    root = root if root is not None else default_root()
    report = AnalysisReport(label="determinism")
    for rel in targets:
        path = root / rel
        if not path.exists():
            report.findings.append(Finding(
                "determinism", rel, "lint target does not exist"))
            continue
        report.findings.extend(lint_file(
            path, rel=rel, exempt=EXEMPT_FUNCTIONS.get(rel, frozenset())))
        report.checked_files += 1
    return report

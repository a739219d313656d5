"""The repo-specific AST lint (``python -m repro_torch.analysis lint``), a
port of ``repro.analysis.lint`` run over ``src/repro_torch``.

Five rules, each enforcing a contract the code would otherwise keep by
convention only:

* ``counter-mutation``: :class:`~repro_torch.core.littles_law.TierCounters`
  fields (``inserts``, ``occupancy_time``, ``class_counts[...]``) are
  written only by the counter substrate (``littles_law``, ``substrate``)
  and the engines' result-materialization functions; everything else reads
  counters through window deltas.
* ``nondeterminism``: sim paths (``core``, ``memsim``, ``tiering``,
  ``fabric``, ``scenarios``, ``analysis``, ``workload``) call no unseeded
  ``random.*`` sampler, no wall-clock ``time.*`` source, no ``np.random.*``
  global sampler, and no torch ``rand`` / ``randn`` / ``randint`` /
  ``randperm`` without ``generator=``: every stream comes from a seeded
  generator, and wall clocks belong to
  :class:`repro_torch.obs.metrics.PhaseProfiler`.
* ``deprecated-surface``: no two-positional-argument ``.window(fast, slow)``
  call outside ``core/controller.py`` and no ``merged=True`` counters
  outside ``core/substrate.py``.
* ``scenario-pickle``: every ``Scenario(...)`` is built declaratively (no
  lambda fields, which the sweep's process pool cannot pickle), and every
  registered scenario round-trips through ``pickle``.
* ``twin-parity``: the scalar and vector twins stay field-complete: every
  :class:`~repro_torch.core.controller.MikuConfig` and
  :class:`~repro_torch.core.littles_law.EstimatorConfig` knob is read by
  :meth:`~repro_torch.core.controller.VectorMikuLadder.from_units`, and
  every tiering-policy and
  :class:`~repro_torch.tiering.engine.MigrationEngine` knob by
  ``VectorTiering.__init__``.

Rule functions take parsed ASTs (or live objects, for the twin rule) and
return :class:`Finding` lists, so tests drive each rule on small synthetic
sources.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import textwrap
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

#: Packages (relative to ``src/repro_torch``) whose files are sim hot paths for
#: the nondeterminism rule.
_SIM_PACKAGES = ("core", "memsim", "tiering", "fabric", "scenarios",
                 "analysis", "workload")

#: TierCounters fields only the substrate may write.
_COUNTER_FIELDS = ("inserts", "occupancy_time")
_COUNTER_SUBSCRIPT = "class_counts"

#: (path suffix, enclosing function) pairs allowed to write counter fields:
#: the engines' result-materialization functions, which *build* the public
#: TierCounters from their flat accumulators.
_MUTATION_ALLOWED_FUNCS = (
    ("core/des.py", "_materialize_counters"),
    ("memsim/batched/fluid.py", "run_fluid"),
    ("memsim/batched/exact.py", "run_exact"),
)
#: Whole modules that own the counter types and their window plumbing.
_MUTATION_ALLOWED_MODULES = ("core/littles_law.py", "core/substrate.py")

_RANDOM_SAMPLERS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "paretovariate",
    "weibullvariate", "getrandbits", "randbytes",
})
_TIME_SOURCES = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "process_time", "process_time_ns",
})
_NP_RANDOM_SAMPLERS = frozenset({
    "random", "rand", "randn", "randint", "random_sample", "choice",
    "shuffle", "permutation", "uniform", "normal", "exponential", "seed",
})
#: torch samplers that draw from the global generator unless given one.
_TORCH_SAMPLERS = frozenset({"rand", "randn", "randint", "randperm"})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation: rule id, location, and the human message."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _attr_root(node: ast.expr) -> Optional[str]:
    """Dotted root of an attribute chain (``np.random.rand`` -> ``np``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


# ---------------------------------------------------------------------------
# Rule: counter-mutation
# ---------------------------------------------------------------------------


class _CounterMutationVisitor(ast.NodeVisitor):
    def __init__(self, rel: str) -> None:
        self.rel = rel
        self.stack: List[str] = []
        self.findings: List[Finding] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _allowed(self) -> bool:
        for suffix, func in _MUTATION_ALLOWED_FUNCS:
            if self.rel.endswith(suffix) and func in self.stack:
                return True
        return False

    def _flag_target(self, target: ast.expr, lineno: int) -> None:
        if isinstance(target, ast.Attribute) and \
                target.attr in _COUNTER_FIELDS:
            field = target.attr
        elif isinstance(target, ast.Subscript) and \
                isinstance(target.value, ast.Attribute) and \
                target.value.attr == _COUNTER_SUBSCRIPT:
            field = _COUNTER_SUBSCRIPT
        else:
            return
        if self._allowed():
            return
        self.findings.append(Finding(
            "counter-mutation", self.rel, lineno,
            f"TierCounters.{field} written outside the counter substrate "
            "(repro_torch.core.substrate / littles_law own window state; "
            "engines may only write it in their result materializers)",
        ))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._flag_target(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._flag_target(node.target, node.lineno)
        self.generic_visit(node)


def rule_counter_mutation(tree: ast.AST, rel: str) -> List[Finding]:
    """No TierCounters/window-state mutation outside the substrate."""
    if any(rel.endswith(m) for m in _MUTATION_ALLOWED_MODULES):
        return []
    v = _CounterMutationVisitor(rel)
    v.visit(tree)
    return v.findings


# ---------------------------------------------------------------------------
# Rule: nondeterminism
# ---------------------------------------------------------------------------


def rule_nondeterminism(tree: ast.AST, rel: str) -> List[Finding]:
    """No unseeded random / wall-clock calls in sim hot paths."""
    parts = Path(rel).parts
    if len(parts) < 2 or parts[0] not in _SIM_PACKAGES:
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            continue
        func = node.func
        attr = func.attr
        if isinstance(func.value, ast.Name):
            root = func.value.id
            if root == "random" and attr in _RANDOM_SAMPLERS:
                findings.append(Finding(
                    "nondeterminism", rel, node.lineno,
                    f"module-level random.{attr}() in a sim path; draw "
                    "from a seeded random.Random instance instead",
                ))
            elif root == "time" and attr in _TIME_SOURCES:
                findings.append(Finding(
                    "nondeterminism", rel, node.lineno,
                    f"wall-clock time.{attr}() in a sim path; simulated "
                    "time must come from the engine clock",
                ))
            elif root == "torch" and attr in _TORCH_SAMPLERS and not any(
                    kw.arg == "generator" for kw in node.keywords):
                findings.append(Finding(
                    "nondeterminism", rel, node.lineno,
                    f"torch.{attr}() without generator= in a sim path; pass "
                    "a seeded torch.Generator",
                ))
        elif isinstance(func.value, ast.Attribute) and \
                func.value.attr == "random" and \
                isinstance(func.value.value, ast.Name) and \
                func.value.value.id in ("np", "numpy"):
            if attr in _NP_RANDOM_SAMPLERS:
                findings.append(Finding(
                    "nondeterminism", rel, node.lineno,
                    f"global-state np.random.{attr}() in a sim path; use "
                    "a seeded np.random.default_rng(seed)",
                ))
            elif attr == "default_rng" and not node.args and \
                    not node.keywords:
                findings.append(Finding(
                    "nondeterminism", rel, node.lineno,
                    "np.random.default_rng() without a seed in a sim path",
                ))
    return findings


# ---------------------------------------------------------------------------
# Rule: deprecated-surface
# ---------------------------------------------------------------------------


def rule_deprecated_surface(tree: ast.AST, rel: str) -> List[Finding]:
    """No legacy two-arg ``.window()`` / ``merged=True`` counters."""
    findings: List[Finding] = []
    shim_module = rel.endswith("core/controller.py")
    counters_module = rel.endswith("core/substrate.py")
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not shim_module and isinstance(node.func, ast.Attribute) and \
                node.func.attr == "window" and len(node.args) == 2 and \
                not node.keywords:
            findings.append(Finding(
                "deprecated-surface", rel, node.lineno,
                "two-positional-arg .window(fast, slow) is the deprecated "
                "pre-vector surface; pass one TierWindow",
            ))
        if not counters_module:
            for kw in node.keywords:
                if kw.arg == "merged" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is True:
                    findings.append(Finding(
                        "deprecated-surface", rel, node.lineno,
                        "merged=True counters are deprecated; consume the "
                        "per-tier TierWindow and merge in the law "
                        "(MergedSlowPolicy)",
                    ))
    return findings


# ---------------------------------------------------------------------------
# Rule: scenario-pickle
# ---------------------------------------------------------------------------


def rule_scenario_pickle_ast(tree: ast.AST, rel: str) -> List[Finding]:
    """Scenario(...) construction must be declarative (no lambda fields)."""
    if "scenarios" not in Path(rel).parts:
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = node.func.id if isinstance(node.func, ast.Name) else (
            node.func.attr if isinstance(node.func, ast.Attribute) else None
        )
        if name not in ("Scenario", "Axis"):
            continue
        for kw in node.keywords:
            if isinstance(kw.value, ast.Lambda):
                findings.append(Finding(
                    "scenario-pickle", rel, kw.value.lineno,
                    f"{name}({kw.arg}=lambda ...) is not picklable across "
                    "the sweep process pool; use a module-level function",
                ))
        for arg in node.args:
            if isinstance(arg, ast.Lambda):
                findings.append(Finding(
                    "scenario-pickle", rel, arg.lineno,
                    f"lambda argument to {name}(...) is not picklable "
                    "across the sweep process pool",
                ))
    return findings


def rule_scenario_pickle_dynamic() -> List[Finding]:
    """Every registered scenario must survive a pickle round-trip."""
    import pickle

    from repro_torch.scenarios import registry

    findings: List[Finding] = []
    for sc in registry.all_scenarios():
        try:
            pickle.loads(pickle.dumps(sc))
        except Exception as ex:  # pickle raises a zoo of types
            findings.append(Finding(
                "scenario-pickle", "scenarios/library.py", 0,
                f"registered scenario {sc.name!r} is not picklable: {ex}",
            ))
    return findings


# ---------------------------------------------------------------------------
# Rule: twin-parity
# ---------------------------------------------------------------------------


def consumed_attrs(func, roots: Iterable[str]) -> Set[str]:
    """Attribute names ``func``'s source reads off any expression in
    ``roots`` (dotted-source match, e.g. ``"u.config"``)."""
    src = textwrap.dedent(inspect.getsource(func))
    tree = ast.parse(src)
    roots = set(roots)
    found: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            try:
                base = ast.unparse(node.value)
            except Exception:
                continue
            if base in roots:
                found.add(node.attr)
    return found


def _knob_names(obj) -> Set[str]:
    """Declared knob names: dataclass fields, or __init__ params (minus
    self / **kwargs) for plain classes."""
    if dataclasses.is_dataclass(obj):
        return {f.name for f in dataclasses.fields(obj)}
    sig = inspect.signature(obj.__init__)
    return {
        name for name, p in sig.parameters.items()
        if name != "self" and p.kind not in (
            inspect.Parameter.VAR_KEYWORD, inspect.Parameter.VAR_POSITIONAL
        )
    }


def compare_twin_surfaces(
    label: str,
    fields: Iterable[str],
    consumed: Iterable[str],
    *,
    extra_allowed: Iterable[str] = (),
    path: str = "",
    line: int = 0,
) -> List[Finding]:
    """Bidirectional field/consumption diff for one scalar↔vector pair."""
    fields, consumed = set(fields), set(consumed)
    findings: List[Finding] = []
    for f in sorted(fields - consumed):
        findings.append(Finding(
            "twin-parity", path, line,
            f"{label}: knob {f!r} is not consumed by the vector twin — "
            "a one-sided knob silently diverges the batched lane",
        ))
    for a in sorted(consumed - fields - set(extra_allowed)):
        findings.append(Finding(
            "twin-parity", path, line,
            f"{label}: vector twin reads unknown knob {a!r} — the scalar "
            "side declares no such field",
        ))
    return findings


def twin_pairs() -> List[Tuple[str, Set[str], Set[str], Set[str], str, int]]:
    """The checked pairs: (label, scalar fields, vector-consumed attrs,
    extra allowed reads, consumer path, consumer line)."""
    from repro_torch.core.controller import MikuConfig, VectorMikuLadder
    from repro_torch.core.littles_law import EstimatorConfig
    from repro_torch.memsim.batched.tiering import VectorTiering
    from repro_torch.tiering.engine import MigrationEngine
    from repro_torch.tiering.policies import HotnessLRUPolicy, MikuCoordinatedPolicy

    def loc(func) -> Tuple[str, int]:
        code = getattr(func, "__func__", func).__code__
        return code.co_filename, code.co_firstlineno

    fu_path, fu_line = loc(VectorMikuLadder.from_units)
    vt_path, vt_line = loc(VectorTiering.__init__)
    from_units_cfg = consumed_attrs(
        VectorMikuLadder.from_units, ("cfg", "u.config")
    )
    from_units_est = consumed_attrs(VectorMikuLadder.from_units, ("est",))
    vt_base = consumed_attrs(VectorTiering.__init__, ("base",))
    vt_pol = consumed_attrs(VectorTiering.__init__, ("pol",))
    vt_engine = consumed_attrs(VectorTiering.__init__, ("h.engine",))
    coordinated = _knob_names(MikuCoordinatedPolicy)
    return [
        ("MikuConfig <-> VectorMikuLadder.from_units",
         _knob_names(MikuConfig), from_units_cfg, set(), fu_path, fu_line),
        ("EstimatorConfig <-> VectorMikuLadder.from_units",
         _knob_names(EstimatorConfig), from_units_est, set(),
         fu_path, fu_line),
        ("HotnessLRUPolicy <-> VectorTiering",
         _knob_names(HotnessLRUPolicy), vt_base, set(), vt_path, vt_line),
        ("MikuCoordinatedPolicy <-> VectorTiering",
         coordinated, vt_pol, {"name", "base"}, vt_path, vt_line),
        ("MigrationEngine <-> VectorTiering",
         _knob_names(MigrationEngine), vt_engine, set(), vt_path, vt_line),
    ]


def rule_twin_parity() -> List[Finding]:
    """Every scalar knob has a vector consumer, and vice versa."""
    findings: List[Finding] = []
    for label, fields, consumed, extra, path, line in twin_pairs():
        findings.extend(compare_twin_surfaces(
            label, fields, consumed, extra_allowed=extra,
            path=path, line=line,
        ))
    return findings


# ---------------------------------------------------------------------------
# Running the rules
# ---------------------------------------------------------------------------

#: The per-file AST rules, in report order.
AST_RULES = (
    rule_counter_mutation,
    rule_nondeterminism,
    rule_deprecated_surface,
    rule_scenario_pickle_ast,
)


def default_src_root() -> Path:
    """The ``repro_torch`` package directory this module ships in."""
    return Path(__file__).resolve().parents[1]


def lint_file(path: Path, rel: str) -> List[Finding]:
    """Run every AST rule over one file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    findings: List[Finding] = []
    for rule in AST_RULES:
        findings.extend(rule(tree, rel))
    return findings


def run_lint(
    src_root: Optional[Path] = None, *, dynamic: bool = True
) -> List[Finding]:
    """Lint the whole package: AST rules per file, then the dynamic
    (import-the-code) rules — twin parity and scenario pickling."""
    root = Path(src_root) if src_root is not None else default_src_root()
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        findings.extend(lint_file(path, rel))
    if dynamic:
        findings.extend(rule_twin_parity())
        findings.extend(rule_scenario_pickle_dynamic())
    return findings


def format_report(findings: Sequence[Finding], n_files: int) -> str:
    if not findings:
        return f"repro_torch.analysis lint: {n_files} files checked, no findings"
    lines = [str(f) for f in findings]
    lines.append(
        f"repro_torch.analysis lint: {len(findings)} finding(s) in "
        f"{n_files} files"
    )
    return "\n".join(lines)

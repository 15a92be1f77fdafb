"""Repo invariant linter — AST-based, zero imports of the checked code
(the JAX package's ``analysis/lint.py``, over the port's tree:
``PACKAGE = "pencilarrays_tpu_torch"``, its allowlist
``pa-lint-torch.allow`` at the repo root).

The tree carries several cross-file invariants that no single module
can enforce at runtime:

``journal-event``
    every ``record_event("<name>", ...)`` call site's event name is
    registered in ``obs/schema.py`` ``EVENT_TYPES``;
``fleet-event``
    the ``fleet.*`` journal namespace is owned by ``fleet/`` and fully
    registered (literal names only inside ``fleet/``, never emitted
    outside it);
``env-knob``
    every ``PENCILARRAYS_TPU_*`` environment knob mentioned in package
    code is documented under ``docs/`` or in ``README.md``'s section of
    the port (the documentation corpus; ``docs/`` is the JAX package's,
    a knob only the port reads is documented in the port's section);
``plan-cache``
    every ``lru_cache``-decorated factory of a cached executable — a
    K1 plan (``CopyPlan``/``plan_copy``/``_plan_args`` or a call into
    the K1 module), a cuFFT transform (``torch.fft.*``) or a CUDA graph
    (``torch.cuda.CUDAGraph``/``torch.cuda.graph``/
    ``make_graphed_callables``) — is registered with
    ``cluster/elastic.py`` ``clear_plan_caches()``;
``fault-point``
    every injection point registered in ``resilience/faults.py``
    ``POINTS`` (and every literal consulted via ``faults.fire``/
    ``faults.armed``) appears in the ``docs/Resilience.md`` point
    table or, for a point only the port has, in its README section;
``unlocked-state``
    mutable module-level state that is actually *mutated* inside the
    daemon-bearing packages (``obs/``, ``cluster/``, ``serve/``,
    ``engine/``, ``fleet/``) lives in a module that also defines a
    module-level lock, or is explicitly allowlisted;
``thread-spawn``
    raw ``threading.Thread(...)`` construction appears ONLY inside
    ``engine/`` — every other subsystem spawns through
    :func:`~pencilarrays_tpu_torch.engine.threads.spawn_thread`;
``wire-cast``
    element-type casts never touch exchange payloads outside the
    sanctioned pack/unpack of ``parallel/wire.py``: inside the exchange
    modules (``parallel/transpositions.py``, ``parallel/routing.py``)
    and the fused-hop builder (``ops/fft.py`` ``_fused_hop``) a
    ``.to(<dtype>)`` or ``.type(<dtype>)`` call is a finding, and
    package-wide a ``.to``/``.type``/``.view`` call targeting an fp8
    type (``torch.float8_*``, or a string naming one) is a finding —
    an fp8 payload quantized outside ``parallel/wire.py`` ships no
    per-tile scales.  The port's exchanges move ``uint8`` *views* of
    their buffers (bytes on the wire, not a cast), which stay out of
    the rule;
``hop-peak``
    ``routing._hop_peak_bytes`` — the ONE peak-memory footprint
    accounting — is referenced ONLY from ``parallel/routing.py`` and
    ``analysis/spmd.py``;
``trace-ctx``
    the request trace context is minted ONLY at the two admission
    points — ``fleet/router.py`` and ``serve/service.py``, plus the
    definition site — and PROPAGATED everywhere else: every
    ``encode_request(`` call in ``fleet/`` passes ``trace=``,
    ``fleet/worker.py`` admits into its service only under a
    ``requestflow.installed(...)`` block, and the serve dispatch-meta
    builder carries the ``"trace"`` key;
``kv-fenced``
    every KV write (``.set(`` / ``.set_if(`` / ``.delete(``) inside
    the recovery-path packages (``cluster/``, ``fleet/``) either goes
    through :class:`~pencilarrays_tpu_torch.cluster.kv.FencedKV` or
    carries an inline ``# kv-unfenced: <reason>`` opt-out at the call
    site.

Everything is parsed from source with :mod:`ast` — the linter never
imports the modules it checks, so it runs in milliseconds and works on
a tree that does not even import.

Findings outside the committed allowlist (``pa-lint-torch.allow`` at
the repo root — one ``check-id identifier  # justification`` per line)
fail ``pa-lint`` (``python -m pencilarrays_tpu_torch.analysis``).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "Finding",
    "Allowlist",
    "CHECKS",
    "run_lint",
    "lint_tree",
]

PACKAGE = "pencilarrays_tpu_torch"
DEFAULT_ALLOWLIST = "pa-lint-torch.allow"

# the daemon-bearing packages whose module-level mutable state the
# unlocked-state check audits
DAEMON_PACKAGES = ("obs", "cluster", "serve", "engine", "fleet")

# the one package allowed to construct threads (thread-spawn check)
THREAD_PACKAGE = "engine"

_ENV_KNOB_RE = re.compile(r"^PENCILARRAYS_TPU_[A-Z0-9]+(?:_[A-Z0-9]+)*$")

_MUTATING_METHODS = frozenset({
    "append", "add", "setdefault", "pop", "update", "clear", "extend",
    "remove", "discard", "popitem", "insert", "appendleft",
})

CHECKS = ("journal-event", "fleet-event", "env-knob", "plan-cache",
          "fault-point", "unlocked-state", "thread-spawn", "wire-cast",
          "hop-peak", "trace-ctx", "kv-fenced")

# the exchange-program sources the wire-cast check audits: whole
# modules whose bodies build exchange programs, plus named functions in
# modules that only partly do (fft.py's fused hop — its plan-level dtype
# coercions outside the fused hop are legitimate).  parallel/wire.py is
# the sanctioned choke point and is exempt by construction.
WIRE_CAST_MODULES = ("parallel/transpositions.py", "parallel/routing.py")
WIRE_CAST_FUNCTIONS = {"ops/fft.py": ("_fused_hop",)}
# the calls that change an element type (``view`` only reinterprets,
# which the fp8 rule below covers)
WIRE_CAST_METHODS = frozenset({"to", "type"})
WIRE_CAST_DTYPES = frozenset({
    "float16", "half", "bfloat16", "float32", "float", "float64",
    "double", "complex32", "complex64", "cfloat", "complex128",
    "cdouble", "int8", "uint8", "int16", "short", "int32", "int",
    "int64", "long", "bool"})

# the fp8 wire family is additionally audited PACKAGE-WIDE: a ``.to``,
# ``.type`` or ``.view`` call targeting an fp8 element type ANYWHERE
# outside parallel/wire.py is a finding.  The per-tile scale transport
# makes ad-hoc fp8 casts uniquely dangerous: a payload quantized outside
# the choke point ships no scales, so it decodes to garbage that the
# guard's widened wire tolerance may well accept.  The allowlist is
# empty ON PURPOSE: there are no grandfathered sites.
WIRE_CAST_EXEMPT = ("parallel/wire.py",)
WIRE_CAST_FP8_METHODS = frozenset({"to", "type", "view"})
WIRE_CAST_FP8_NAMES = frozenset({
    "float8_e4m3fn", "float8_e4m3fnuz", "float8_e5m2", "float8_e5m2fnuz",
    "fp8_e4m3", "fp8_e5m2", "e4m3", "e5m2"})
WIRE_CAST_ALLOWLIST: Tuple[str, ...] = ()

# the only modules allowed to reference the ONE footprint accounting
# (hop-peak check); everything else bounds through analysis.spmd
HOP_PEAK_NAME = "_hop_peak_bytes"
HOP_PEAK_MODULES = ("parallel/routing.py", "analysis/spmd.py")

# trace-ctx check: the only modules allowed to MINT a request trace
# (the two admission points plus the definition site), the worker
# whose service admissions must run under installed(), and the serve
# module whose dispatch-meta builder must carry the trace key
TRACE_MINT_NAME = "mint_trace"
TRACE_MINT_MODULES = ("obs/requestflow.py", "fleet/router.py",
                      "serve/service.py")
TRACE_WORKER_MODULE = "fleet/worker.py"
TRACE_META_MODULE = "serve/service.py"
TRACE_META_FUNCTION = "_dispatch_meta"

# kv-fenced check: the packages whose KV writes run on
# recovery/reformation paths, where a zombie — a rank that slept
# through a reformation — can corrupt the new generation's state.
# Every ``<kv-ish receiver>.set/set_if/delete(`` call there either
# goes through ``FencedKV`` (receiver named ``fenced*``) or carries an
# inline ``# kv-unfenced: <why this write cannot be a zombie's>``
# opt-out at the call site.  The allowlist is empty ON
# PURPOSE: the justification lives next to the write it excuses.
KV_FENCED_PACKAGES = ("cluster", "fleet")
KV_WRITE_METHODS = frozenset({"set", "set_if", "delete"})
KV_FENCED_OPTOUT = "# kv-unfenced:"


@dataclass(frozen=True)
class Finding:
    """One invariant violation.  ``ident`` is the stable identifier an
    allowlist entry names (never a line number — entries must survive
    unrelated edits)."""

    check: str
    path: str          # repo-relative
    line: int
    ident: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.check} {self.ident}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclass
class Allowlist:
    """The committed escape hatch: ``check-id identifier`` lines, each
    REQUIRING a ``# justification`` comment (an unjustified entry is
    itself a finding — the list documents debt, it does not hide it).
    ``#``-only and blank lines are comments."""

    path: Optional[str] = None
    entries: Dict[str, str] = field(default_factory=dict)  # key -> why
    bad_lines: List[Tuple[int, str]] = field(default_factory=list)
    _hits: Set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        al = cls(path=path)
        if not os.path.exists(path):
            return al
        with open(path, encoding="utf-8") as f:
            for n, raw in enumerate(f, 1):
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                body, _, why = line.partition("#")
                parts = body.split()
                if len(parts) != 2 or parts[0] not in CHECKS:
                    al.bad_lines.append((n, raw.rstrip()))
                    continue
                if not why.strip():
                    al.bad_lines.append((n, raw.rstrip()))
                    continue
                al.entries[f"{parts[0]} {parts[1]}"] = why.strip()
        return al

    def allows(self, finding: Finding) -> bool:
        if finding.key in self.entries:
            self._hits.add(finding.key)
            return True
        return False

    def unused(self) -> List[str]:
        """Entries that suppressed nothing — stale debt to delete."""
        return sorted(set(self.entries) - self._hits)


# ---------------------------------------------------------------------------
# source loading
# ---------------------------------------------------------------------------


def _iter_py_files(pkg_root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _parse(path: str) -> Optional[ast.Module]:
    try:
        with open(path, encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None


PORT_README_HEADING = "## PyTorch/CUDA port"


def _readme_port_section(text: str) -> str:
    """README.md's section of the port: from its heading to the next
    heading of the same level (the rest of README describes the JAX
    package); a README without that heading is the port's own, whole."""
    i = text.find(PORT_README_HEADING)
    if i < 0:
        return text
    j = text.find("\n## ", i + len(PORT_README_HEADING))
    return text[i:] if j < 0 else text[i:j]


def _docs_corpus(root: str) -> str:
    """Every docs/**/*.md plus README.md's port section, concatenated —
    the text the env-knob and fault-point checks search."""
    chunks = []
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        with open(readme, encoding="utf-8") as f:
            chunks.append(_readme_port_section(f.read()))
    docs = os.path.join(root, "docs")
    for dirpath, _dirnames, filenames in os.walk(docs):
        for fn in sorted(filenames):
            if fn.endswith(".md"):
                with open(os.path.join(dirpath, fn),
                          encoding="utf-8") as f:
                    chunks.append(f.read())
    return "\n".join(chunks)


def _rel(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _module_dotted(root: str, path: str) -> str:
    """``<root>/pencilarrays_tpu/ops/fft.py`` -> ``ops.fft``
    (relative to the package)."""
    rel = _rel(root, path)
    parts = rel.split("/")
    if parts and parts[0] == PACKAGE:
        parts = parts[1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# ---------------------------------------------------------------------------
# registry extraction (AST reads of the source-of-truth modules)
# ---------------------------------------------------------------------------


def _dict_str_keys(node: ast.AST) -> Set[str]:
    keys: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Dict):
            for k in n.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
    return keys


def registered_events(root: str) -> Set[str]:
    """``EVENT_TYPES`` keys, parsed from ``obs/schema.py``."""
    tree = _parse(os.path.join(root, PACKAGE, "obs", "schema.py"))
    if tree is None:
        return set()
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            targets = [node.target.id]
        if "EVENT_TYPES" in targets and node.value is not None:
            return _dict_str_keys(node.value)
    return set()


def registered_points(root: str) -> Set[str]:
    """``POINTS`` entries, parsed from ``resilience/faults.py``."""
    tree = _parse(os.path.join(root, PACKAGE, "resilience", "faults.py"))
    if tree is None:
        return set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "POINTS"
                for t in node.targets):
            return {n.value for n in ast.walk(node.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
    return set()


def registered_plan_caches(root: str) -> Set[Tuple[str, str]]:
    """``(dotted_module, factory_name)`` pairs registered with
    ``clear_plan_caches()`` — parsed from ``cluster/elastic.py``: the
    function-local ``from .. import X as _alias`` imports map aliases
    to modules, and the ``for mod, names in ((alias, (names...)), ...)``
    tuple literal lists the registered factory names."""
    path = os.path.join(root, PACKAGE, "cluster", "elastic.py")
    tree = _parse(path)
    if tree is None:
        return set()
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)
               and n.name == "clear_plan_caches"), None)
    if fn is None:
        return set()
    # alias -> dotted module relative to the package.  elastic.py lives
    # one package level down, so a level-2 relative import resolves to
    # the package root.
    aliases: Dict[str, str] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.ImportFrom):
            base = n.module or ""
            for a in n.names:
                dotted = f"{base}.{a.name}" if base else a.name
                aliases[a.asname or a.name] = dotted
    out: Set[Tuple[str, str]] = set()
    for n in ast.walk(fn):
        if not isinstance(n, ast.Tuple):
            continue
        # looking for 2-tuples (alias_name, ("name", ...))
        if len(n.elts) != 2 or not isinstance(n.elts[0], ast.Name):
            continue
        mod = aliases.get(n.elts[0].id)
        if mod is None:
            continue
        for c in ast.walk(n.elts[1]):
            if isinstance(c, ast.Constant) and isinstance(c.value, str):
                out.add((mod, c.value))
    return out


# ---------------------------------------------------------------------------
# per-check scanners
# ---------------------------------------------------------------------------


def _is_record_event_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in ("record_event", "_record_event")
    if isinstance(f, ast.Attribute):
        return f.attr == "record_event"
    return False


def _check_journal_events(root: str, trees: Dict[str, ast.Module],
                          findings: List[Finding]) -> None:
    events = registered_events(root)
    if not events:
        findings.append(Finding(
            "journal-event", f"{PACKAGE}/obs/schema.py", 1,
            "EVENT_TYPES",
            "could not parse EVENT_TYPES from obs/schema.py"))
        return
    for path, tree in trees.items():
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and _is_record_event_call(node) and node.args):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue  # dynamic name: runtime schema lint owns it
            if arg.value not in events:
                findings.append(Finding(
                    "journal-event", _rel(root, path), node.lineno,
                    arg.value,
                    f"record_event({arg.value!r}, ...) is not "
                    f"registered in obs/schema.py EVENT_TYPES"))


def _check_fleet_events(root: str, trees: Dict[str, ast.Module],
                        findings: List[Finding]) -> None:
    """The ``fleet.*`` journal namespace is owned by ``fleet/`` and
    fully registered — both directions:

    * inside ``fleet/``, every ``record_event`` name must be a string
      LITERAL (a dynamic name would dodge the static registry check —
      in the package whose events gate failover, that is not
      acceptable debt) that is registered and lives in the ``fleet.``
      namespace (fleet modules never journal another layer's events);
    * outside ``fleet/``, emitting a ``fleet.*`` event is a finding —
      the fleet timeline must be attributable to the fleet layer.

    Unregistered literals anywhere are already journal-event findings;
    this check adds the namespace-ownership and no-dynamic-names
    invariants the fleet drills assert on."""
    events = registered_events(root)
    fleet_prefix = os.path.join(root, PACKAGE, "fleet") + os.sep
    for path, tree in trees.items():
        in_fleet = path.startswith(fleet_prefix)
        dotted = _module_dotted(root, path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and _is_record_event_call(node) and node.args):
                continue
            arg = node.args[0]
            literal = (arg.value
                       if isinstance(arg, ast.Constant)
                       and isinstance(arg.value, str) else None)
            if in_fleet:
                if literal is None:
                    findings.append(Finding(
                        "fleet-event", _rel(root, path), node.lineno,
                        f"{dotted}:dynamic",
                        "record_event with a non-literal event name "
                        "in fleet/ — fleet events must be statically "
                        "checkable against obs/schema.py"))
                elif not literal.startswith("fleet."):
                    findings.append(Finding(
                        "fleet-event", _rel(root, path), node.lineno,
                        literal,
                        f"fleet/ journals non-fleet event "
                        f"{literal!r} — the fleet layer owns (only) "
                        f"the fleet.* namespace"))
                elif literal not in events:
                    findings.append(Finding(
                        "fleet-event", _rel(root, path), node.lineno,
                        literal,
                        f"unregistered fleet event {literal!r} "
                        f"(register it in obs/schema.py EVENT_TYPES)"))
            elif literal is not None and literal.startswith("fleet."):
                findings.append(Finding(
                    "fleet-event", _rel(root, path), node.lineno,
                    literal,
                    f"{literal!r} journaled outside fleet/ — fleet.* "
                    f"events must be attributable to the fleet layer"))


def _check_env_knobs(root: str, trees: Dict[str, ast.Module],
                     docs: str, findings: List[Finding]) -> None:
    seen: Dict[str, Tuple[str, int]] = {}
    for path, tree in trees.items():
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and _ENV_KNOB_RE.match(node.value)):
                seen.setdefault(node.value, (path, node.lineno))
    for knob in sorted(seen):
        path, line = seen[knob]
        if knob not in docs:
            findings.append(Finding(
                "env-knob", _rel(root, path), line, knob,
                f"env knob {knob} is read in code but documented "
                f"nowhere under docs/ or README.md"))


def _has_lru_cache(fn: ast.FunctionDef) -> bool:
    for d in fn.decorator_list:
        target = d.func if isinstance(d, ast.Call) else d
        if isinstance(target, ast.Name) and target.id == "lru_cache":
            return True
        if isinstance(target, ast.Attribute) and target.attr == "lru_cache":
            return True
    return False


# the names whose call builds a cached executable (plan-cache check)
_K1_PLAN_CALLS = frozenset({"CopyPlan", "plan_copy", "_plan_args"})
_K1_MODULE_NAMES = frozenset({"k1", "permute", "_permute"})
_GRAPH_CALLS = frozenset({"CUDAGraph", "make_graphed_callables"})


def _dotted(node: ast.AST) -> str:
    """``torch.cuda.graph`` for an attribute chain of names, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _builds_executable(fn: ast.FunctionDef) -> bool:
    """Does the function body build a cached executable: a K1 plan, a
    cuFFT transform or a CUDA graph (module docstring)?"""
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name in _K1_PLAN_CALLS or name in _GRAPH_CALLS:
            return True
        path = _dotted(f)
        if path.startswith("torch.fft.") or path == "torch.cuda.graph":
            return True
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in _K1_MODULE_NAMES:
            return True
    return False


def _check_plan_caches(root: str, trees: Dict[str, ast.Module],
                       findings: List[Finding]) -> None:
    registered = registered_plan_caches(root)
    if not registered:
        findings.append(Finding(
            "plan-cache", f"{PACKAGE}/cluster/elastic.py", 1,
            "clear_plan_caches",
            "could not parse the clear_plan_caches registration table "
            "from cluster/elastic.py"))
        return
    reg_names = {(m, n) for m, n in registered}
    for path, tree in trees.items():
        dotted = _module_dotted(root, path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.FunctionDef)
                    and _has_lru_cache(node) and _builds_executable(node)):
                continue
            ident = f"{dotted}.{node.name}"
            if (dotted, node.name) not in reg_names:
                findings.append(Finding(
                    "plan-cache", _rel(root, path), node.lineno, ident,
                    f"lru_cache'd executable factory {ident} (K1 plan, "
                    f"cuFFT or CUDA graph) is not registered with "
                    f"elastic.clear_plan_caches() — a reformation would "
                    f"redispatch its stale executables"))


def _check_fault_points(root: str, trees: Dict[str, ast.Module],
                        docs_resilience: str,
                        findings: List[Finding]) -> None:
    points = registered_points(root)
    if not points:
        findings.append(Finding(
            "fault-point", f"{PACKAGE}/resilience/faults.py", 1,
            "POINTS",
            "could not parse POINTS from resilience/faults.py"))
        return
    # literals consulted at call sites (faults.fire / faults.armed)
    consulted: Dict[str, Tuple[str, int]] = {}
    for path, tree in trees.items():
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in ("fire", "armed")
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "faults"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                consulted.setdefault(arg.value, (path, node.lineno))
    for pt, (path, line) in sorted(consulted.items()):
        if pt not in points:
            findings.append(Finding(
                "fault-point", _rel(root, path), line, pt,
                f"faults call site consults unregistered injection "
                f"point {pt!r} (register it in faults.POINTS)"))
    for pt in sorted(points):
        if f"`{pt}`" not in docs_resilience:
            where = consulted.get(pt)
            findings.append(Finding(
                "fault-point",
                _rel(root, where[0]) if where
                else f"{PACKAGE}/resilience/faults.py",
                where[1] if where else 1, pt,
                f"injection point {pt!r} is missing from the "
                f"docs/Resilience.md point table"))


def _module_has_lock(tree: ast.Module) -> bool:
    """A module-level ``<name> = threading.Lock()/RLock()`` (or bare
    ``Lock()``) assignment."""
    for node in tree.body:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        f = value.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name in ("Lock", "RLock"):
            return True
    return False


def _is_mutable_value(value: ast.AST) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        f = value.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        return name in ("dict", "list", "set", "defaultdict", "deque",
                        "OrderedDict", "Counter")
    return False


def _mutated_names(tree: ast.Module) -> Set[str]:
    """Names that are mutated (method call, subscript store/delete, or
    ``global`` rebinding) anywhere in the module."""
    out: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and isinstance(n.func.value, ast.Name) \
                and n.func.attr in _MUTATING_METHODS:
            out.add(n.func.value.id)
        elif isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name):
                    out.add(t.value.id)
        elif isinstance(n, ast.Delete):
            for t in n.targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name):
                    out.add(t.value.id)
        elif isinstance(n, ast.Global):
            out.update(n.names)
    return out


def _check_unlocked_state(root: str, trees: Dict[str, ast.Module],
                          findings: List[Finding]) -> None:
    prefixes = tuple(os.path.join(root, PACKAGE, p) + os.sep
                     for p in DAEMON_PACKAGES)
    for path, tree in trees.items():
        if not path.startswith(prefixes):
            continue
        has_lock = _module_has_lock(tree)
        if has_lock:
            continue
        mutated = _mutated_names(tree)
        dotted = _module_dotted(root, path)
        for node in tree.body:
            targets: List[ast.Name] = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets
                           if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name) and node.value is not None:
                targets = [node.target]
            if not targets or node.value is None:
                continue
            if not _is_mutable_value(node.value):
                continue
            for t in targets:
                if t.id.startswith("__") or t.id not in mutated:
                    continue  # read-only table, or never mutated
                ident = f"{dotted}.{t.id}"
                findings.append(Finding(
                    "unlocked-state", _rel(root, path), node.lineno,
                    ident,
                    f"module-level mutable state {ident} is mutated in "
                    f"a daemon-bearing package but the module defines "
                    f"no module-level lock"))


def _is_thread_ctor(f: ast.AST) -> bool:
    """``threading.Thread(...)`` / ``Thread(...)`` (a from-import)."""
    if isinstance(f, ast.Attribute) and f.attr == "Thread" and \
            isinstance(f.value, ast.Name) and f.value.id == "threading":
        return True
    return isinstance(f, ast.Name) and f.id == "Thread"


def _check_thread_spawn(root: str, trees: Dict[str, ast.Module],
                        findings: List[Finding]) -> None:
    """Thread construction is an engine/ monopoly: everything else
    spawns through ``engine.threads.spawn_thread`` (module docstring).
    The ident is ``<dotted module>.<enclosing function>`` so an
    allowlist entry survives unrelated edits."""
    allowed = os.path.join(root, PACKAGE, THREAD_PACKAGE) + os.sep
    for path, tree in trees.items():
        if path.startswith(allowed):
            continue
        dotted = _module_dotted(root, path)

        def visit(node: ast.AST, scope: str) -> None:
            for child in ast.iter_child_nodes(node):
                inner = scope
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = child.name
                if isinstance(child, ast.Call) and \
                        _is_thread_ctor(child.func):
                    ident = f"{dotted}.{scope}"
                    findings.append(Finding(
                        "thread-spawn", _rel(root, path), child.lineno,
                        ident,
                        f"raw threading.Thread construction in {ident} "
                        f"— spawn through engine.threads.spawn_thread "
                        f"(the one audited choke point; threads outside "
                        f"engine/ are unnamed, uninventoried, and "
                        f"reopen the dispatch-ordering deadlock class)"))
                visit(child, inner)

        visit(tree, "<module>")


def _dtype_target(node: ast.AST) -> bool:
    """Does a ``.to``/``.type`` argument name an element type:
    ``torch.<dtype>``, a name or attribute called ``*dtype*``?"""
    if isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "torch" \
                and (node.attr in WIRE_CAST_DTYPES
                     or node.attr in WIRE_CAST_FP8_NAMES):
            return True
        return "dtype" in node.attr
    if isinstance(node, ast.Name):
        return "dtype" in node.id
    return False


def _is_cast(call: ast.Call) -> bool:
    """``x.to(<dtype>)`` / ``x.to(dtype=...)`` / ``x.type(<dtype>)``."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr in WIRE_CAST_METHODS):
        return False
    return (any(_dtype_target(a) for a in call.args)
            or any(k.arg == "dtype" for k in call.keywords))


def _check_wire_cast(root: str, trees: Dict[str, ast.Module],
                     findings: List[Finding]) -> None:
    """Exchange payloads change element type ONLY through
    ``parallel/wire.py``'s pack/unpack (module docstring).  The ident
    is ``<dotted module>.<enclosing function>`` (stable across
    unrelated edits, the thread-spawn convention)."""
    targets: Dict[str, Optional[Tuple[str, ...]]] = {
        os.path.join(root, PACKAGE, *m.split("/")): None
        for m in WIRE_CAST_MODULES}
    for m, fns in WIRE_CAST_FUNCTIONS.items():
        targets[os.path.join(root, PACKAGE, *m.split("/"))] = tuple(fns)
    for path, tree in trees.items():
        if path not in targets:
            continue
        only_fns = targets[path]
        dotted = _module_dotted(root, path)

        def visit(node: ast.AST, scope: str, inside: bool) -> None:
            for child in ast.iter_child_nodes(node):
                in_scope, in_target = scope, inside
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    in_scope = child.name
                    if only_fns is not None:
                        in_target = inside or child.name in only_fns
                if (isinstance(child, ast.Call) and _is_cast(child)
                        and (only_fns is None or in_target)):
                    ident = f"{dotted}.{scope}"
                    findings.append(Finding(
                        "wire-cast", _rel(root, path), child.lineno,
                        ident,
                        f"direct .{child.func.attr}(<dtype>) on a "
                        f"potential exchange payload in {ident} — "
                        f"element-type changes in exchange programs go "
                        f"through the sanctioned pack/unpack helpers "
                        f"(parallel/wire.py), or the priced byte model "
                        f"and the guard's wire tolerance silently "
                        f"diverge from the bytes actually moved"))
                visit(child, in_scope, in_target)

        visit(tree, "<module>", only_fns is None)
    _check_wire_cast_fp8(root, trees, findings)


def _fp8_cast_target(node: ast.AST) -> bool:
    """Does a cast argument name an fp8 element type?  Covers the
    attribute (``torch.float8_e4m3fn``), bare-name and string
    spellings."""
    if isinstance(node, ast.Attribute):
        return node.attr in WIRE_CAST_FP8_NAMES
    if isinstance(node, ast.Name):
        return node.id in WIRE_CAST_FP8_NAMES
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        v = node.value.lower().replace("-", "_")
        return v in WIRE_CAST_FP8_NAMES or "float8" in v or "fp8" in v
    return False


def _check_wire_cast_fp8(root: str, trees: Dict[str, ast.Module],
                         findings: List[Finding]) -> None:
    """The package-wide fp8 family rule (see the constants' comment):
    ``.to``/``.type``/``.view`` calls targeting an fp8 type are
    findings everywhere but parallel/wire.py.  ``WIRE_CAST_ALLOWLIST``
    idents are exempt — and it is empty."""
    exempt = {os.path.join(root, PACKAGE, *m.split("/"))
              for m in WIRE_CAST_EXEMPT}
    for path, tree in trees.items():
        if path in exempt:
            continue
        dotted = _module_dotted(root, path)

        def visit(node: ast.AST, scope: str) -> None:
            for child in ast.iter_child_nodes(node):
                inner = scope
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = child.name
                if (isinstance(child, ast.Call)
                        and isinstance(child.func, ast.Attribute)
                        and child.func.attr in WIRE_CAST_FP8_METHODS
                        and (any(_fp8_cast_target(a) for a in child.args)
                             or any(_fp8_cast_target(k.value)
                                    for k in child.keywords
                                    if k.arg == "dtype"))):
                    ident = f"{dotted}.{scope}"
                    if ident not in WIRE_CAST_ALLOWLIST:
                        findings.append(Finding(
                            "wire-cast", _rel(root, path), child.lineno,
                            ident,
                            f"fp8-targeted .{child.func.attr}( in {ident} "
                            f"— fp8 wire forms carry per-tile scales "
                            f"that ONLY parallel/wire.py's pack/unpack "
                            f"transport correctly; an ad-hoc cast ships "
                            f"a scale-less payload the guard's widened "
                            f"wire tolerance may silently accept"))
                visit(child, inner)

        visit(tree, "<module>")


def _check_hop_peak(root: str, trees: Dict[str, ast.Module],
                    findings: List[Finding]) -> None:
    """``_hop_peak_bytes`` stays the ONE footprint accounting: any
    reference (import, attribute access, bare name) outside
    ``parallel/routing.py`` / ``analysis/spmd.py`` is a finding — a
    new caller must route through the sanctioned ``analysis.spmd``
    entry points instead of re-deriving footprints.  The ident is
    ``<dotted module>.<enclosing function>`` (the thread-spawn
    convention, stable across unrelated edits)."""
    allowed = {os.path.join(root, PACKAGE, *m.split("/"))
               for m in HOP_PEAK_MODULES}
    for path, tree in trees.items():
        if path in allowed:
            continue
        dotted = _module_dotted(root, path)

        def visit(node: ast.AST, scope: str) -> None:
            for child in ast.iter_child_nodes(node):
                inner = scope
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = child.name
                hit = (
                    (isinstance(child, ast.Name)
                     and child.id == HOP_PEAK_NAME)
                    or (isinstance(child, ast.Attribute)
                        and child.attr == HOP_PEAK_NAME)
                    or (isinstance(child, ast.ImportFrom) and any(
                        a.name == HOP_PEAK_NAME for a in child.names)))
                if hit:
                    ident = f"{dotted}.{scope}"
                    findings.append(Finding(
                        "hop-peak", _rel(root, path), child.lineno,
                        ident,
                        f"direct {HOP_PEAK_NAME} reference in {ident} "
                        f"— peak-HBM footprints are computed ONLY by "
                        f"parallel/routing.py and analysis/spmd.py; "
                        f"bound schedules through analysis.spmd "
                        f"(step_hop_peak / predicted_peak_hbm / "
                        f"verify_hbm) so the router's admission and "
                        f"the static verifier can never disagree"))
                visit(child, inner)

        visit(tree, "<module>")


def _is_installed_ctx(expr: ast.AST) -> bool:
    """``requestflow.installed(...)`` / ``installed(...)`` as a with-
    item context expression."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Attribute):
        return f.attr == "installed"
    return isinstance(f, ast.Name) and f.id == "installed"


def _check_trace_ctx(root: str, trees: Dict[str, ast.Module],
                     findings: List[Finding]) -> None:
    """The request trace context is minted at the two admission points
    and PROPAGATED everywhere else (module docstring).  Three
    sub-rules, each anchored on a concrete site: the ``mint_trace``
    choke point (everywhere), cross-wire ``encode_request`` calls in
    ``fleet/`` must pass ``trace=``, the worker's service admissions
    must run under ``requestflow.installed(...)``, and the serve
    dispatch-meta builder must carry the ``"trace"`` key.  Rules
    anchored on files or functions a tree does not have skip silently
    (a fixture repo without a fleet layer has nothing to propagate).
    The ident is ``<dotted module>.<enclosing function>`` (the
    thread-spawn convention)."""
    mint_allowed = {os.path.join(root, PACKAGE, *m.split("/"))
                    for m in TRACE_MINT_MODULES}
    fleet_prefix = os.path.join(root, PACKAGE, "fleet") + os.sep
    worker_path = os.path.join(root, PACKAGE,
                               *TRACE_WORKER_MODULE.split("/"))
    meta_path = os.path.join(root, PACKAGE,
                             *TRACE_META_MODULE.split("/"))
    for path, tree in trees.items():
        dotted = _module_dotted(root, path)
        in_fleet = path.startswith(fleet_prefix)

        def visit(node: ast.AST, scope: str, installed: bool) -> None:
            for child in ast.iter_child_nodes(node):
                inner, inst = scope, installed
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = child.name
                    inst = False    # a nested def runs later, outside
                    # the enclosing with's dynamic extent
                if isinstance(child, ast.With) and any(
                        _is_installed_ctx(i.context_expr)
                        for i in child.items):
                    inst = True
                # (a) the mint choke point: only the admission points
                # (and the definition site) may reference mint_trace
                if path not in mint_allowed and (
                        (isinstance(child, ast.Name)
                         and child.id == TRACE_MINT_NAME)
                        or (isinstance(child, ast.Attribute)
                            and child.attr == TRACE_MINT_NAME)
                        or (isinstance(child, ast.ImportFrom) and any(
                            a.name == TRACE_MINT_NAME
                            for a in child.names))):
                    findings.append(Finding(
                        "trace-ctx", _rel(root, path), child.lineno,
                        f"{dotted}.{scope}",
                        f"{TRACE_MINT_NAME} referenced in {dotted}."
                        f"{scope} — a trace is minted ONCE at "
                        f"admission (fleet/router.py or serve/"
                        f"service.py); minting mid-path shears the "
                        f"request's causal chain"))
                if isinstance(child, ast.Call):
                    f = child.func
                    fname = (f.attr if isinstance(f, ast.Attribute)
                             else f.id if isinstance(f, ast.Name)
                             else None)
                    # (b) cross-wire re-encodes propagate the trace
                    if (in_fleet and fname == "encode_request"
                            and not any(k.arg in ("trace", None)
                                        for k in child.keywords)):
                        findings.append(Finding(
                            "trace-ctx", _rel(root, path),
                            child.lineno, f"{dotted}.{scope}",
                            f"encode_request call in {dotted}.{scope} "
                            f"does not pass trace= — a re-encode that "
                            f"drops (or re-mints) the trace shears "
                            f"the causal chain exactly at the "
                            f"rebind/failover the post-mortem needs"))
                    # (c) worker admissions adopt the inbound trace
                    if (path == worker_path and fname == "submit"
                            and isinstance(f, ast.Attribute)
                            and not inst):
                        findings.append(Finding(
                            "trace-ctx", _rel(root, path),
                            child.lineno, f"{dotted}.{scope}",
                            f".submit( in {dotted}.{scope} outside a "
                            f"requestflow.installed(...) block — the "
                            f"serve layer would mint a fresh trace "
                            f"for a routed request instead of "
                            f"adopting the wire's"))
                visit(child, inner, inst)

        visit(tree, "<module>", False)
        # (d) the dispatch-meta builder carries the trace key (the
        # engine installs it around the run — dropping it silently
        # orphans every engine/guard/retry record from its request)
        if path == meta_path:
            fn = next((n for n in ast.walk(tree)
                       if isinstance(n, ast.FunctionDef)
                       and n.name == TRACE_META_FUNCTION), None)
            if fn is not None and "trace" not in _dict_str_keys(fn):
                findings.append(Finding(
                    "trace-ctx", _rel(root, path), fn.lineno,
                    f"{dotted}.{TRACE_META_FUNCTION}",
                    f"{TRACE_META_FUNCTION} builds no dict with a "
                    f"'trace' key — engine-side records would journal "
                    f"with no request attribution"))


def _check_kv_fenced(root: str, trees: Dict[str, ast.Module],
                     findings: List[Finding]) -> None:
    """Every KV write in the recovery-path packages (``cluster/``,
    ``fleet/``) is either fenced or explicitly, inline-justified
    unfenced (module docstring).  A write call is in scope when its
    receiver expression mentions ``kv`` (``self.kv.set(...)``,
    ``kv.delete(...)``, ``coord.kv.set_if(...)``); a receiver
    mentioning ``fenced`` IS the sanctioned path.  The opt-out is a
    ``# kv-unfenced: <reason>`` comment on the call's first or last
    source line, or in the comment block directly above the call —
    the reason is required (an empty one is still a finding), and it
    lives next to the write so a reader sees the excuse and the
    excused code together.  The ident is
    ``<dotted module>.<enclosing function>`` (the thread-spawn
    convention)."""
    prefixes = tuple(os.path.join(root, PACKAGE, p) + os.sep
                     for p in KV_FENCED_PACKAGES)
    for path, tree in trees.items():
        if not path.startswith(prefixes):
            continue
        dotted = _module_dotted(root, path)
        try:
            with open(path, encoding="utf-8") as f:
                src_lines = f.read().splitlines()
        except OSError:
            src_lines = []

        def _has_marker(line: str) -> bool:
            i = line.find(KV_FENCED_OPTOUT)
            return (i >= 0
                    and bool(line[i + len(KV_FENCED_OPTOUT):].strip()))

        def _opted_out(call: ast.Call) -> bool:
            # the marker rides the call's own line(s), or a contiguous
            # comment block directly above it (multi-line excuses)
            for n in {call.lineno, getattr(call, "end_lineno",
                                           call.lineno)}:
                if n is not None and n <= len(src_lines) \
                        and _has_marker(src_lines[n - 1]):
                    return True
            n = call.lineno - 1
            while n >= 1 and src_lines[n - 1].lstrip().startswith("#"):
                if _has_marker(src_lines[n - 1]):
                    return True
                n -= 1
            return False

        def visit(node: ast.AST, scope: str) -> None:
            for child in ast.iter_child_nodes(node):
                inner = scope
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = child.name
                if (isinstance(child, ast.Call)
                        and isinstance(child.func, ast.Attribute)
                        and child.func.attr in KV_WRITE_METHODS):
                    try:
                        recv = ast.unparse(child.func.value).lower()
                    except Exception:   # pragma: no cover - exotic AST
                        recv = ""
                    if ("kv" in recv and "fenced" not in recv
                            and not _opted_out(child)):
                        findings.append(Finding(
                            "kv-fenced", _rel(root, path),
                            child.lineno, f"{dotted}.{scope}",
                            f"raw KV .{child.func.attr}( in {dotted}."
                            f"{scope} — recovery-path writes go "
                            f"through FencedKV (zombie fencing) or "
                            f"carry an inline '{KV_FENCED_OPTOUT} "
                            f"<reason>' opt-out"))
                visit(child, inner)

        visit(tree, "<module>")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def lint_tree(root: str) -> List[Finding]:
    """Run every check over the package at ``root`` (the repo root
    containing ``pencilarrays_tpu_torch/``).  Returns raw findings — the
    caller applies the allowlist."""
    pkg_root = os.path.join(root, PACKAGE)
    trees: Dict[str, ast.Module] = {}
    for path in _iter_py_files(pkg_root):
        tree = _parse(path)
        if tree is not None:
            trees[path] = tree
    docs = _docs_corpus(root)
    resilience_path = os.path.join(root, "docs", "Resilience.md")
    docs_resilience = ""
    if os.path.exists(resilience_path):
        with open(resilience_path, encoding="utf-8") as f:
            docs_resilience = f.read()
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        # a point only the port has is documented in its README section
        with open(readme, encoding="utf-8") as f:
            docs_resilience += "\n" + _readme_port_section(f.read())
    findings: List[Finding] = []
    _check_journal_events(root, trees, findings)
    _check_fleet_events(root, trees, findings)
    _check_env_knobs(root, trees, docs, findings)
    _check_plan_caches(root, trees, findings)
    _check_fault_points(root, trees, docs_resilience, findings)
    _check_unlocked_state(root, trees, findings)
    _check_thread_spawn(root, trees, findings)
    _check_wire_cast(root, trees, findings)
    _check_hop_peak(root, trees, findings)
    _check_trace_ctx(root, trees, findings)
    _check_kv_fenced(root, trees, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.check, f.ident))
    return findings


def run_lint(root: str, allowlist: Optional[Allowlist] = None
             ) -> Tuple[List[Finding], Allowlist]:
    """Lint + allowlist filtering: returns ``(reportable findings,
    the loaded allowlist)``.  Malformed or unjustified allowlist lines
    are themselves findings (the list must stay honest)."""
    if allowlist is None:
        allowlist = Allowlist.load(os.path.join(root, DEFAULT_ALLOWLIST))
    findings = [f for f in lint_tree(root) if not allowlist.allows(f)]
    for n, raw in allowlist.bad_lines:
        # "allowlist" is deliberately NOT in CHECKS: a malformed or
        # unjustified entry cannot be allowlisted away
        findings.append(Finding(
            "allowlist",
            _rel(root, allowlist.path or DEFAULT_ALLOWLIST), n,
            f"line:{n}",
            f"malformed or unjustified allowlist line: {raw!r} "
            f"(format: '<check-id> <identifier>  # justification')"))
    return findings, allowlist

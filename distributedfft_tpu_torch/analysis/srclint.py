"""AST-level repo-invariant lints over the port's source — the JAX
package's ``analysis/srclint.py``, with its three rule names (so
``dfft-torch-verify --json`` carries JAX's keys) and what each means in
the port:

* ``traced-host-io`` — the code that runs on EVERY execution must not
  read ``os.environ`` or do host I/O (``open``, ``input``,
  ``subprocess``): the bodies of ``torch.autograd.Function.forward`` and
  ``backward``, the closures that ``forward_fn`` / ``inverse_fn`` /
  ``_fwd_parts`` / ``_inv_parts`` / ``_build_fwd`` / ``_build_inv`` /
  ``_build_r2c`` / ``_build_c2r`` / ``_build`` / ``exchange_body`` (and
  the other builders of ``PIPELINE_BUILDERS``) return, and the functions
  they call in the same module. An environment read per call would split
  a plan's directions mid-run — the same bug class as the JAX package's
  trace-time freeze, which ``Config.resolved_guards`` documents
  ("resolved once at plan construction"). The fault injector reads its
  spec per call by contract (``resilience/inject.py``, another module).
* ``host-only-jnp`` — the host-only modules (``utils/wisdom.py``,
  ``obs/tracing.py``) import no ``ops.hopper_fft`` or ``ops._build`` and
  make no ``torch.cuda`` call at import: wisdom is loaded standalone by
  the flock-contract tests, and tracing must stay importable before any
  device exists.
* ``wisdom-flock`` — every ``os.replace`` (the atomic-write idiom) in a
  lock-disciplined module (``utils/wisdom.py``, ``serve/``,
  ``solvers/``, ``persist/``) must be reachable only under the
  ``_advisory_lock`` flock helper of ``utils/wisdom.py``: a write outside
  the lock re-opens the read-merge-replace race the helper closes.

An inline ``# srclint: allow(<rule>)`` comment on the offending line
suppresses a finding — visible, greppable, reviewed.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

# Builders whose returned closures run on every execution of a plan
# (their nested defs and lambdas are the per-execution roots).
PIPELINE_BUILDERS = frozenset({
    "forward_fn", "inverse_fn", "_fwd_parts", "_inv_parts", "_build_fwd",
    "_build_inv", "_build_r2c", "_build_c2r", "_build", "exchange_body",
    "_streams_fwd_body", "_streams_inv_body", "_fft3d_r2c", "_fft3d_c2r",
    "_fft3d_c2c", "_fft3d_fwd", "_fft3d_inv", "_fwd_ffts", "_inv_ffts",
    "_chain", "_ring_pipe", "_ring_hooks", "_exchange", "_slab_parts",
    "_chunked", "_pure_fn", "wrap",
})

# Host-only modules (package-relative): importing the kernel module or
# the kernel build here couples a pure-host path to the device side.
HOST_ONLY_MODULES = (
    os.path.join("utils", "wisdom.py"),
    os.path.join("obs", "tracing.py"),
)
_DEVICE_MODULES = ("hopper_fft", "_build")

_ALLOW_MARK = "# srclint: allow("


@dataclasses.dataclass(frozen=True)
class SrcFinding:
    """One source-lint diagnostic (``rule`` is the invariant name the
    mutation tests assert on)."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"[srclint/{self.rule}] {self.path}:{self.line}: " \
               f"{self.message}"


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``os.environ.get`` ->
    "os.environ.get")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _allowed(src_lines: List[str], line: int, rule: str) -> bool:
    if 1 <= line <= len(src_lines):
        txt = src_lines[line - 1]
        if _ALLOW_MARK + rule + ")" in txt:
            return True
    return False


# ---------------------------------------------------------------------------
# traced-host-io
# ---------------------------------------------------------------------------

def _is_function_class(node: ast.ClassDef) -> bool:
    """A ``torch.autograd.Function`` subclass (by its base's name)."""
    for base in node.bases:
        name = base.attr if isinstance(base, ast.Attribute) else \
            getattr(base, "id", "")
        if name == "Function":
            return True
    return False


class _FnIndex(ast.NodeVisitor):
    """Function defs by name + the call edges and per-execution roots of
    one module."""

    def __init__(self) -> None:
        self.defs: Dict[str, List[ast.AST]] = {}
        self.roots: List[ast.AST] = []
        self._stack: List[ast.AST] = []
        # (caller def or None, callee simple name) edges
        self.calls: List[Tuple[Optional[ast.AST], str]] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if _is_function_class(node):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and \
                        item.name in ("forward", "backward"):
                    self.roots.append(item)
        self.generic_visit(node)

    def _visit_fn(self, node: Any) -> None:
        self.defs.setdefault(node.name, []).append(node)
        if node.name in PIPELINE_BUILDERS:
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                    self.roots.append(sub)
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        caller = self._stack[-1] if self._stack else None
        self.calls.append((caller, _call_name(node)))
        self.generic_visit(node)


_HOST_IO_CALLS = frozenset({"open", "input"})
_HOST_IO_PREFIXES = ("subprocess.", "os.system", "os.popen", "os.getenv",
                     "os.putenv", "os.environ")


def _traced_fns(tree: ast.Module) -> Set[ast.AST]:
    """The module's per-execution function set: the roots, closed over
    same-module calls by simple name (a root's callees run on every
    execution too) and over defs nested in a member."""
    idx = _FnIndex()
    idx.visit(tree)
    traced: Set[ast.AST] = set(idx.roots)
    changed = True
    while changed:
        changed = False
        for caller, callee in idx.calls:
            if caller in traced:
                for d in idx.defs.get(callee, []):
                    if d not in traced:
                        traced.add(d)
                        changed = True
        nested = set()
        for fn in traced:
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.FunctionDef, ast.Lambda)) \
                        and sub not in traced:
                    nested.add(sub)
        if nested:
            traced |= nested
            changed = True
    return traced


def _lint_traced_host_io(path: str, tree: ast.Module,
                         src_lines: List[str]) -> List[SrcFinding]:
    out: List[SrcFinding] = []
    for fn in _traced_fns(tree):
        for node in ast.walk(fn):
            msg = None
            if isinstance(node, ast.Call):
                name = _call_name(node)
                dotted = _dotted(node.func)
                if name in _HOST_IO_CALLS:
                    msg = f"host I/O call {name}() inside per-execution " \
                          f"function {_fn_name(fn)!r}"
                elif any(dotted.startswith(p) for p in _HOST_IO_PREFIXES):
                    msg = f"{dotted}() inside per-execution function " \
                          f"{_fn_name(fn)!r}"
            elif isinstance(node, (ast.Attribute, ast.Subscript)):
                dotted = _dotted(node if isinstance(node, ast.Attribute)
                                 else node.value)
                if dotted.startswith("os.environ"):
                    msg = f"os.environ read inside per-execution function " \
                          f"{_fn_name(fn)!r} (read on every execution: a " \
                          "mid-run change splits a plan's directions)"
            if msg and not _allowed(src_lines, node.lineno,
                                    "traced-host-io"):
                out.append(SrcFinding("traced-host-io", path, node.lineno,
                                      msg))
    # De-duplicate per line (the Attribute inside a flagged Call would
    # otherwise report the same read twice).
    seen: Set[int] = set()
    uniq = []
    for f in sorted(out, key=lambda f: f.line):
        if f.line not in seen:
            seen.add(f.line)
            uniq.append(f)
    return uniq


# ---------------------------------------------------------------------------
# host-only-jnp
# ---------------------------------------------------------------------------

def _fn_name(fn: ast.AST) -> str:
    return getattr(fn, "name", "<lambda>")


def _module_level(tree: ast.Module) -> List[ast.AST]:
    """The nodes that run when the module is imported (outside every def
    and class body's functions)."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _lint_host_only_jnp(path: str, tree: ast.Module,
                        src_lines: List[str]) -> List[SrcFinding]:
    if not any(path.endswith(suffix) for suffix in HOST_ONLY_MODULES):
        return []
    out: List[SrcFinding] = []
    for node in ast.walk(tree):
        bad = None
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[-1] in _DEVICE_MODULES:
                    bad = alias.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.split(".")[-1] in _DEVICE_MODULES:
                bad = mod
            elif any(a.name in _DEVICE_MODULES for a in node.names):
                bad = f"{mod}.{next(a.name for a in node.names if a.name in _DEVICE_MODULES)}"
        if bad and not _allowed(src_lines, node.lineno, "host-only-jnp"):
            out.append(SrcFinding(
                "host-only-jnp", path, node.lineno,
                f"host-only module imports {bad} (couples a pure-host "
                "path to the kernels)"))
    for node in _module_level(tree):
        if isinstance(node, ast.Call) and \
                _dotted(node.func).startswith("torch.cuda"):
            if not _allowed(src_lines, node.lineno, "host-only-jnp"):
                out.append(SrcFinding(
                    "host-only-jnp", path, node.lineno,
                    f"host-only module calls {_dotted(node.func)}() at "
                    "import (touches the device before one is asked "
                    "for)"))
    return out


# ---------------------------------------------------------------------------
# wisdom-flock
# ---------------------------------------------------------------------------

LOCK_HELPER = "_advisory_lock"

# Modules whose os.replace writes must stay under the flock helper: the
# wisdom store (the rule's origin), plus every module of the serve/,
# solvers/ and persist/ packages — long-lived processes persisting shared
# state (checkpoint generations) re-open the exact read-merge-replace race
# the helper closes.
LOCKED_REPLACE_MODULES = (os.path.join("utils", "wisdom.py"),)
LOCKED_REPLACE_PACKAGES = ("serve", "solvers", "persist")


def _replace_lock_applies(path: str) -> bool:
    if any(path.endswith(m) for m in LOCKED_REPLACE_MODULES):
        return True
    # Match package names against components INSIDE the package tree
    # only — a checkout path that happens to contain a directory named
    # "serve" must not widen the rule to the whole repo. Paths under
    # package_root() are matched relative to it; relative paths (the
    # synthetic-source form the tests use) are matched as given; other
    # absolute paths are out of scope.
    root = package_root()
    abspath = os.path.abspath(path)
    if abspath.startswith(root + os.sep):
        rel = os.path.relpath(abspath, root)
    elif not os.path.isabs(path):
        rel = path
    else:
        return False
    parts = rel.replace("\\", "/").split("/")
    return any(pkg in parts[:-1] for pkg in LOCKED_REPLACE_PACKAGES)


def _locked_withs(tree: ast.Module) -> List[ast.With]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.With):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and \
                        _call_name(ctx) == LOCK_HELPER:
                    out.append(node)
    return out


def _lint_wisdom_flock(path: str, tree: ast.Module,
                       src_lines: List[str]) -> List[SrcFinding]:
    """Every ``os.replace`` (the atomic-write idiom) in a
    lock-disciplined module (wisdom store, serve/, solvers/) must sit
    inside a ``with _advisory_lock(...)`` block — lexically, or in a
    function whose every same-module call site does."""
    if not _replace_lock_applies(path):
        return []
    locked = _locked_withs(tree)
    locked_nodes: Set[ast.AST] = set()
    for w in locked:
        locked_nodes.update(ast.walk(w))

    # Map replace calls to their enclosing function defs.
    fns: Dict[str, ast.FunctionDef] = {}
    parents: Dict[ast.AST, Optional[ast.FunctionDef]] = {}

    def index(node: ast.AST, fn: Optional[ast.FunctionDef]) -> None:
        for child in ast.iter_child_nodes(node):
            here = child if isinstance(child, ast.FunctionDef) else fn
            if isinstance(child, ast.FunctionDef):
                fns[child.name] = child
            parents[child] = fn
            index(child, here)

    index(tree, None)

    def enclosing_fn(node: ast.AST) -> Optional[ast.FunctionDef]:
        return parents.get(node)

    replaces = [n for n in ast.walk(tree)
                if isinstance(n, ast.Call)
                and _dotted(n.func) == "os.replace"]
    out: List[SrcFinding] = []
    for call in replaces:
        if call in locked_nodes:
            continue
        fn = enclosing_fn(call)
        if fn is not None:
            # One indirection level: the writer helper is fine when every
            # same-module call of it happens under the lock.
            sites = [c for c in ast.walk(tree)
                     if isinstance(c, ast.Call)
                     and _call_name(c) in (fn.name,)
                     and c is not call]
            if sites and all(s in locked_nodes for s in sites):
                continue
        if _allowed(src_lines, call.lineno, "wisdom-flock"):
            continue
        out.append(SrcFinding(
            "wisdom-flock", path, call.lineno,
            "atomic store write (os.replace) reachable outside the "
            f"{LOCK_HELPER} flock helper — re-opens the "
            "read-merge-replace race"))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str = "<string>") -> List[SrcFinding]:
    """All source lints over one module's text (the harness the mutation
    tests feed synthetic sources through)."""
    tree = ast.parse(src, filename=path)
    lines = src.splitlines()
    out = _lint_traced_host_io(path, tree, lines)
    out += _lint_host_only_jnp(path, tree, lines)
    out += _lint_wisdom_flock(path, tree, lines)
    return out


def lint_file(path: str) -> List[SrcFinding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scanned_files(root: Optional[str] = None,
                  skip: Iterable[str] = ()) -> List[str]:
    """Every module ``lint_repo`` walks — the canonical scope of the
    repo lints (``serve/`` and ``solvers/`` included; the completeness
    test pins that, so a new package cannot silently fall outside the
    lint gate)."""
    root = root or package_root()
    skip = set(skip)
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            if os.path.relpath(path, root) in skip:
                continue
            out.append(path)
    return out


def lint_repo(root: Optional[str] = None,
              skip: Iterable[str] = ()) -> List[SrcFinding]:
    """Lint every module under ``distributedfft_tpu_torch/`` (or
    ``root``)."""
    out: List[SrcFinding] = []
    for path in scanned_files(root, skip):
        try:
            out.extend(lint_file(path))
        except SyntaxError as e:
            out.append(SrcFinding("parse", path, e.lineno or 0,
                                  f"syntax error: {e.msg}"))
    return out

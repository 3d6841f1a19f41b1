"""AST concurrency lint over ``occam/serve`` (OCM05x).

The serve subsystem's contract is a single never-blocked event loop:
the only awaits are ``asyncio`` primitives, device work happens in the
sync ``Session.pump`` path *between* scheduled callbacks, and shared
engine state is only touched from the loop. Two rule families enforce
it statically:

* **OCM050** — a blocking call inside an ``async def`` body:
  ``time.sleep`` (module aliases and ``from time import sleep``
  tracked), anything ``.block_until_ready`` (JAX device sync), and a
  sync ``.pump(...)`` (a device tick stalls every other ticket).
  ``asyncio.sleep`` / ``asyncio.wait_for`` are awaitable and never
  flagged.
* **OCM051** — a locally-defined callable handed off the event loop
  (``threading.Thread(target=...)``, ``loop.run_in_executor(...,
  fn)``, ``executor.submit(fn)``) whose body stores to ``self.<attr>``
  outside a lock-guarded ``with`` block.
"""
from __future__ import annotations

import ast
import os

from .report import AuditReport, Finding, finding

__all__ = ["lint_source", "lint_file", "lint_serve", "serve_root"]

_BLOCKING_ATTRS = ("block_until_ready", "synchronize", "pump")


def _repo_locus(path: str, lineno: int) -> str:
    p = str(path).replace(os.sep, "/")
    idx = p.find("src/repro_torch/")
    if idx >= 0:
        p = p[idx:]
    return f"{p}:{lineno}"


def _iter_body_skipping_defs(fn: ast.AST):
    """Walk a function body without descending into nested def/lambda
    scopes (they run on their own schedule, not in this async frame)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _lock_guarded(node: ast.With) -> bool:
    for item in node.items:
        for n in ast.walk(item.context_expr):
            name = n.id if isinstance(n, ast.Name) else (
                n.attr if isinstance(n, ast.Attribute) else "")
            if "lock" in name.lower() or "mutex" in name.lower():
                return True
    return False


class _ModuleLint:
    def __init__(self, tree: ast.Module, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self.time_modules: set[str] = set()
        self.sleep_names: set[str] = set()
        self.block_names: set[str] = set()
        # every def in the module, by name — classmethods and module
        # functions alike; the OCM051 resolver looks thread targets and
        # executor jobs up here
        self.defs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        self.time_modules.add(alias.asname or "time")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for alias in node.names:
                        if alias.name == "sleep":
                            self.sleep_names.add(alias.asname or "sleep")
                else:
                    for alias in node.names:
                        if alias.name == "block_until_ready":
                            self.block_names.add(
                                alias.asname or "block_until_ready")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node

    # -- OCM050 -------------------------------------------------------------

    def _blocking_name(self, func: ast.AST) -> str | None:
        if isinstance(func, ast.Attribute):
            if (func.attr == "sleep"
                    and isinstance(func.value, ast.Name)
                    and func.value.id in self.time_modules):
                return "time.sleep"
            if func.attr in _BLOCKING_ATTRS:
                return func.attr
        elif isinstance(func, ast.Name):
            if func.id in self.sleep_names:
                return "time.sleep"
            if func.id in self.block_names:
                return "block_until_ready"
        return None

    def check_async(self, fn: ast.AsyncFunctionDef) -> None:
        for node in _iter_body_skipping_defs(fn):
            if not isinstance(node, ast.Call):
                continue
            name = self._blocking_name(node.func)
            if name:
                self.findings.append(finding(
                    "OCM050", _repo_locus(self.path, node.lineno),
                    f"blocking call {name}() inside async def "
                    f"{fn.name!r} stalls the event loop",
                    function=fn.name, call=name, line=node.lineno))

    # -- OCM051 -------------------------------------------------------------

    def _resolve_callable(self, expr: ast.AST):
        if isinstance(expr, ast.Name):
            return self.defs.get(expr.id)
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            return self.defs.get(expr.attr)
        if isinstance(expr, ast.Lambda):
            return None  # expression-only: cannot contain a store
        return None

    def _offloaded_callable(self, call: ast.Call):
        """The callable this call hands off the event loop, if any."""
        func = call.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if name == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    return kw.value
        elif name == "run_in_executor" and len(call.args) >= 2:
            return call.args[1]
        elif name == "submit" and isinstance(func, ast.Attribute) \
                and call.args:
            # plain-Name receivers only (executor/pool handles); keeps
            # Session/engine ``submit(payload)`` calls out of scope
            if isinstance(func.value, ast.Name) \
                    and func.value.id != "self":
                return call.args[0]
        return None

    def _unguarded_stores(self, fn, guarded: bool = False,
                          node: ast.AST | None = None):
        node = node if node is not None else fn
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            inner_guard = guarded or (isinstance(child, ast.With)
                                      and _lock_guarded(child))
            if not inner_guard and isinstance(
                    child, (ast.Assign, ast.AugAssign)):
                targets = child.targets if isinstance(child, ast.Assign) \
                    else [child.target]
                for t in targets:
                    for n in ast.walk(t):
                        if (isinstance(n, ast.Attribute)
                                and isinstance(n.ctx, ast.Store)
                                and isinstance(n.value, ast.Name)
                                and n.value.id == "self"):
                            yield n
            yield from self._unguarded_stores(fn, inner_guard, child)

    def check_offload(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            target = self._offloaded_callable(node)
            if target is None:
                continue
            fn = self._resolve_callable(target)
            if fn is None:
                continue
            stores = list(self._unguarded_stores(fn))
            if stores:
                attrs = sorted({f"self.{s.attr}" for s in stores})
                self.findings.append(finding(
                    "OCM051", _repo_locus(self.path, node.lineno),
                    f"callable {fn.name!r} runs off the event loop "
                    f"(line {node.lineno}) but mutates {', '.join(attrs)}"
                    f" without a lock",
                    function=fn.name, line=node.lineno, attrs=attrs))


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint one module's source text; returns OCM05x findings."""
    tree = ast.parse(source, filename=str(path))
    lint = _ModuleLint(tree, path)
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            lint.check_async(node)
    lint.check_offload(tree)
    return lint.findings


def lint_file(path: str) -> list[Finding]:
    with open(path) as f:
        return lint_source(f.read(), path)


def serve_root() -> str:
    """The installed ``occam/serve`` package directory — what
    ``lint_serve`` scans by default."""
    from .. import serve as serve_pkg

    return os.path.dirname(os.path.abspath(serve_pkg.__file__))


def lint_serve(root: str | None = None) -> AuditReport:
    """Run the concurrency lint over every module of ``occam/serve``
    (or any directory of Python files)."""
    root = root or serve_root()
    findings: list[Finding] = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            findings += lint_file(os.path.join(root, name))
    return AuditReport(f"serve-lint:{_repo_locus(root, 0).rsplit(':', 1)[0]}",
                       tuple(findings))

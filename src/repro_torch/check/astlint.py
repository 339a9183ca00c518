"""AST lint of the port's bug classes, stdlib ``ast`` only (the port's
counterpart of ``repro/check/astlint.py``).

Each rule encodes a class of bug the port's records name, so it cannot
silently come back:

* **R1a sync-in-graph-capture** — no synchronising call
  (``synchronize``, ``.item()``, ``.cpu()``, ``.tolist()``) inside a
  ``with torch.cuda.graph(...)`` block. A capture records launches and
  computes nothing: a host sync there fails the capture or reads values
  that do not exist yet (a capture never syncs, ``PERF.md`` §6).
* **R1b hidden-fallback** — no ``except`` handler under
  ``repro_torch/kernels/`` or ``repro_torch/graph/`` that calls a plain
  version (``*_plain``) or an oracle (``*_ref``, ``ref.*``). A kernel that
  fails raises to its caller; a handler that quietly runs the plain
  version instead hides the failure, which the port forbids (``kernels.
  ops``: "there is no fallback from a kernel to its plain version").
* **R2 wall-clock-elapsed** — an elapsed time is not computed from
  ``time.time()``: the wall clock steps under NTP adjustment, so use the
  monotonic ``time.perf_counter()``. An absolute stamp is fine; only a
  subtraction over it is flagged.
* **R3 timer-stop-before-sync** — in one function, a
  ``torch.cuda.synchronize()`` / ``Event.synchronize()`` / ``.item()``
  after the LAST ``perf_counter`` stop, where that timer's interval holds
  none, means the timer measured the launches' enqueue time, not the
  device's work: the stop is taken after the last sync, never before
  it.

Run as a module::

    python -m repro_torch.check.astlint [paths...]
    # default: src/repro_torch, chip_smoke.py and scripts/torch_*.py

Exit status 1 iff any finding.
"""
from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path
from typing import Iterator, List

#: the calls that wait for the device
SYNC_CALLS = ("synchronize", "item", "cpu", "tolist")
#: the calls a timer's stop must follow
TIMER_SYNCS = ("synchronize", "item")
#: the port's packages whose except handlers must not run a plain version
NO_FALLBACK = (("repro_torch", "kernels"), ("repro_torch", "graph"))


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _attr_call(node: ast.AST, names) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in names)


def _called_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _walk_local(node: ast.AST) -> Iterator[ast.AST]:
    """``node`` and its descendants, not entering nested function or
    class definitions (their bodies run elsewhere, or never)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                stack.append(c)


def _is_graph_capture(item: ast.withitem) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph(...)``)."""
    e = item.context_expr
    return (isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute)
            and e.func.attr == "graph"
            and isinstance(e.func.value, (ast.Attribute, ast.Name))
            and getattr(e.func.value, "attr",
                        getattr(e.func.value, "id", None)) == "cuda")


def _rule_sync_in_capture(path: str, tree: ast.AST) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, (ast.With, ast.AsyncWith))
                and any(_is_graph_capture(i) for i in node.items)):
            continue
        for stmt in node.body:
            for n in _walk_local(stmt):
                if _attr_call(n, SYNC_CALLS):
                    out.append(Finding(
                        path, n.lineno, "sync-in-graph-capture",
                        f".{n.func.attr}() inside a torch.cuda.graph "
                        "capture: a capture records launches and computes "
                        "nothing, so a host sync there fails it or reads "
                        "values that do not exist yet"))
    return out


def _under(path: str, parts) -> bool:
    p = Path(path).parts
    return any(p[i:i + len(parts)] == parts for i in range(len(p)))


def _is_plain_call(call: ast.Call) -> bool:
    name = _called_name(call)
    f = call.func
    return (name.endswith("_plain") or name.endswith("_ref")
            or (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "ref"))


def _rule_hidden_fallback(path: str, tree: ast.AST) -> List[Finding]:
    if not any(_under(path, parts) for parts in NO_FALLBACK):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        for stmt in node.body:
            for n in _walk_local(stmt):
                if isinstance(n, ast.Call) and _is_plain_call(n):
                    out.append(Finding(
                        path, n.lineno, "hidden-fallback",
                        f"except handler calls {_called_name(n)}(): a "
                        "kernel that fails must raise, not fall back to "
                        "its plain version"))
    return out


def _is_time_time(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "time"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "time")


def _is_monotonic_stamp(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("perf_counter", "monotonic"))


def _rule_wall_clock_elapsed(path: str, tree: ast.AST) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
                and any(_is_time_time(n) for n in ast.walk(node)):
            out.append(Finding(
                path, node.lineno, "wall-clock-elapsed",
                "elapsed time computed from time.time(); wall clock steps "
                "under NTP adjustment: use time.perf_counter() "
                "(monotonic) for intervals"))
    return out


def _stamp_starts(local) -> dict:
    """name -> lines where ``name = time.perf_counter()`` (a timer's
    start) is assigned."""
    out: dict = {}
    for n in local:
        if isinstance(n, ast.Assign) and _is_monotonic_stamp(n.value):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(n.lineno)
    return out


def _rule_stop_before_sync(path: str, tree: ast.AST) -> List[Finding]:
    """A function's last timer stop (``perf_counter() - t0``) whose
    interval from its start holds no sync, and a sync after it: the sync
    that should have preceded the stop."""
    out = []
    scopes = [n for n in ast.walk(tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    scopes.append(tree)                     # module level counts as a scope
    for scope in scopes:
        body = [s for s in scope.body
                if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef))]
        if not body:
            continue
        local = [n for s in body for n in _walk_local(s)]
        stops = [n for n in local
                 if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)
                 and _is_monotonic_stamp(n.left)]
        syncs = sorted((n.lineno, n.func.attr) for n in local
                       if _attr_call(n, TIMER_SYNCS))
        if not stops or not syncs:
            continue
        last = max(stops, key=lambda n: n.lineno)
        stop, begin = last.lineno, body[0].lineno
        if isinstance(last.right, ast.Name):
            begin = max((x for x in _stamp_starts(local).get(last.right.id,
                                                             ())
                         if x <= stop), default=begin)
        if any(begin < line <= stop for line, _ in syncs):
            continue
        for line, attr in syncs:
            if line > stop:
                out.append(Finding(
                    path, line, "timer-stop-before-sync",
                    f".{attr}() after the last timer stop (line {stop}), "
                    "with no sync between that timer's start and its "
                    "stop: the timer measured the launches' enqueue time, "
                    "not the device's work; sync before stopping"))
    return out


RULES = (_rule_sync_in_capture, _rule_hidden_fallback,
         _rule_wall_clock_elapsed, _rule_stop_before_sync)


def lint_file(path) -> List[Finding]:
    src = Path(path).read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [Finding(str(path), e.lineno or 0, "syntax-error", str(e))]
    out: List[Finding] = []
    for rule in RULES:
        out.extend(rule(str(path), tree))
    return out


def _files(paths) -> List[Path]:
    files: List[Path] = []
    for p in map(Path, paths):
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    return files


def lint_paths(paths) -> List[Finding]:
    out: List[Finding] = []
    for f in _files(paths):
        out.extend(lint_file(f))
    return out


def port_paths(root) -> List[Path]:
    """The port's tree under ``root``: ``src/repro_torch``,
    ``chip_smoke.py`` and ``scripts/torch_*.py``."""
    root = Path(root)
    return ([root / "src" / "repro_torch", root / "chip_smoke.py"]
            + sorted((root / "scripts").glob("torch_*.py")))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths = argv or port_paths(Path(__file__).resolve().parents[3])
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    rules = ", ".join(r.__name__.replace("_rule_", "") for r in RULES)
    print(f"astlint: {len(findings)} finding(s) over {len(_files(paths))} "
          f"file(s) [{rules}]")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())

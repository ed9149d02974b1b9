"""Analyzer 3: lock discipline — no blocking calls under a held lock.

Static half of the race tooling (``utils/race.py`` is the dynamic half):
per function, track ``with <lock>:`` regions and flag calls that can
block indefinitely while the lock is held — RPC invokes, UFS I/O,
``time.sleep``, stream/subprocess drains, unbounded ``Future.result()``
/ ``.wait()`` / ``Thread.join()``.  A *bounded* call (explicit timeout)
is exempt, mirroring the try-lock rule TSAN applies: a bounded wait
cannot convert a lock into a deadlock, only into latency.

``Condition.wait`` is exempt when the receiver looks like a condition
variable (``cond``/``cv``/``not_empty``/``all_tasks_done``…): waiting on
a condition RELEASES its lock — that is the one blocking-under-lock
pattern that is correct by construction.

Nested ``def``/``lambda`` bodies do not execute inside the region and
are skipped.  Cross-function blocking (helper called under a lock that
itself blocks) is out of scope for the static pass — the runtime
``LockOrderAuditor`` plugin covers what this cannot see.

Suppress with ``# lint: allow[lock-blocking-call] -- <why it is safe>``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from alluxio_tpu_torch.lint.collect import RepoFacts
from alluxio_tpu_torch.lint.findings import Finding
from alluxio_tpu_torch.lint.model import PyFile, RepoModel, function_index

RULES = ("lock-blocking-call",)

#: a with-item guards a lock when its expression's terminal name matches
_LOCK_NAME_RE = re.compile(r"(^|_)(lock|mutex)s?$|_lock$", re.I)
_LOCK_CALL_METHODS = {"read_locked", "write_locked"}

#: receivers that look like condition variables (wait releases the lock)
_COND_RECV_RE = re.compile(
    r"(cond|cv$|not_empty|not_full|all_tasks_done|condition)", re.I)

_RPC_METHODS = {"call", "call_stream", "call_stream_in", "open_stream",
                "invoke"}
_UFS_METHODS = {"open", "read", "read_range", "write", "list_status",
                "get_status", "delete", "rename", "mkdirs", "exists",
                "content_length", "open_stream"}
_UFS_RECV_RE = re.compile(r"(^|_)ufs$|^ufs_|_ufs_", re.I)
_SOCKET_METHODS = {"recv", "sendall", "accept", "connect", "makefile"}
_SUBPROCESS_FNS = {"run", "check_output", "check_call", "communicate"}


def _dotted(expr: ast.AST) -> Optional[str]:
    """'self._lock' / 'time.sleep' for Name/Attribute chains, else None."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_lock_expr(expr: ast.AST) -> Optional[str]:
    """Display name of the lock a with-item acquires, or None."""
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CALL_METHODS:
            base = _dotted(fn.value) or "<expr>"
            return f"{base}.{fn.attr}()"
        # lock.acquire()-style context managers are not a with-pattern here
        return None
    dotted = _dotted(expr)
    if dotted is not None and _LOCK_NAME_RE.search(dotted.rsplit(".", 1)[-1]):
        return dotted
    return None


def _has_timeout(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None):
            return True
    return False


def _classify_blocking(call: ast.Call) -> Optional[str]:
    """Why this call blocks (short reason), or None when benign."""
    fn = call.func
    dotted = _dotted(fn) or ""
    attr = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else "")
    recv = dotted.rsplit(".", 1)[0] if "." in dotted else ""

    if dotted in ("time.sleep", "sleep"):
        return "time.sleep blocks every other waiter of the lock"
    if attr in _RPC_METHODS and isinstance(fn, ast.Attribute):
        if _has_timeout(call):
            return None
        return f"RPC '.{attr}(...)' holds the lock across a network " \
               f"round trip"
    if attr == "result" and isinstance(fn, ast.Attribute):
        if call.args or _has_timeout(call):
            return None  # bounded result(timeout) cannot deadlock
        return "unbounded Future.result() under a lock can deadlock " \
               "against the executor"
    if attr == "exception" and isinstance(fn, ast.Attribute) and \
            not call.args and not _has_timeout(call):
        return "unbounded Future.exception() under a lock can deadlock " \
               "against the executor"
    if attr == "wait" and isinstance(fn, ast.Attribute):
        if call.args or _has_timeout(call):
            return None
        if _COND_RECV_RE.search(recv):
            return None  # Condition.wait releases the lock
        return "unbounded .wait() under a lock"
    if attr == "join" and isinstance(fn, ast.Attribute) and \
            not call.args and not call.keywords:
        if _COND_RECV_RE.search(recv):
            return None
        return "unbounded .join() under a lock (str.join always has " \
               "an argument; this is a thread/process join)"
    if attr == "communicate" and isinstance(fn, ast.Attribute) and \
            not _has_timeout(call):
        return "subprocess .communicate() without timeout under a lock"
    if attr in _UFS_METHODS and isinstance(fn, ast.Attribute) and \
            _UFS_RECV_RE.search(recv.rsplit(".", 1)[-1] if recv else ""):
        return f"UFS I/O '.{attr}(...)' holds the lock across backing-" \
               f"store latency"
    if attr in _SOCKET_METHODS and isinstance(fn, ast.Attribute) and \
            re.search(r"(sock|socket|conn)$", recv.rsplit(".", 1)[-1]
                      if recv else "", re.I):
        return f"socket '.{attr}(...)' under a lock"
    if dotted.startswith("subprocess.") and attr in _SUBPROCESS_FNS and \
            not _has_timeout(call):
        return f"subprocess.{attr}(...) without timeout under a lock"
    if dotted in ("urllib.request.urlopen", "urlopen") and \
            not _has_timeout(call):
        return "urlopen without timeout under a lock"
    return None


class _FunctionScanner(ast.NodeVisitor):
    """Walks ONE function body tracking the held-lock stack."""

    def __init__(self, pf: PyFile, qualname: str,
                 findings: List[Finding],
                 counters: Dict[str, int]) -> None:
        self._pf = pf
        self._qual = qualname
        self._findings = findings
        self._counters = counters
        self._held: List[str] = []

    # nested defs/lambdas execute later, outside the region
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return None

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        return None

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            lock = _is_lock_expr(item.context_expr)
            if lock is not None:
                acquired.append(lock)
            else:
                self.visit(item.context_expr)
        self._held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        del self._held[len(self._held) - len(acquired):]

    def visit_Call(self, node: ast.Call) -> None:
        if self._held:
            reason = _classify_blocking(node)
            if reason is not None:
                callee = _dotted(node.func) or "<call>"
                base = f"{self._qual}:{callee}"
                n = self._counters.get(base, 0)
                self._counters[base] = n + 1
                anchor = base if n == 0 else f"{base}#{n}"
                self._findings.append(Finding(
                    rule="lock-blocking-call", path=self._pf.path,
                    line=node.lineno, anchor=anchor,
                    message=f"{reason} (holding {', '.join(self._held)} "
                            f"in {self._qual})"))
        self.generic_visit(node)


def analyze(model: RepoModel, facts: RepoFacts) -> List[Finding]:
    del facts
    findings: List[Finding] = []
    for pf in model.py_files:
        counters: Dict[str, int] = {}
        for qualname, func in function_index(pf.tree):
            scanner = _FunctionScanner(pf, qualname, findings, counters)
            for stmt in func.body:
                scanner.visit(stmt)
    return findings

"""Repo model: one parse of every source file, shared by analyzers.

Keeping the walk + ``ast.parse`` in one place is what keeps the full-tree
run inside its <30s budget — each analyzer re-walks the cached trees, it
never re-reads disk. The port's lint reads Python only: no ``docs/``,
``README.md`` or ``ROADMAP.md`` (the JAX package's lint keeps those, and
their names belong to that package).
"""

from __future__ import annotations

import ast
import os
import subprocess
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from alluxio_tpu_torch.lint.findings import Suppression, parse_suppressions

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules",
              "build", "dist"}


@dataclass
class PyFile:
    path: str  # repo-relative, e.g. "alluxio_tpu_torch/master/health.py"
    text: str
    tree: ast.AST
    suppressions: Dict[int, Suppression]

    _docstring_lines: Optional[Set[int]] = field(default=None, repr=False)

    def docstring_lines(self) -> Set[int]:
        """Line numbers occupied by module/class/function docstrings —
        strings there are prose, not registry references."""
        if self._docstring_lines is None:
            lines: Set[int] = set()
            for node in ast.walk(self.tree):
                if isinstance(node, (ast.Module, ast.ClassDef,
                                     ast.FunctionDef, ast.AsyncFunctionDef)):
                    body = getattr(node, "body", [])
                    if body and isinstance(body[0], ast.Expr) and \
                            isinstance(body[0].value, ast.Constant) and \
                            isinstance(body[0].value.value, str):
                        c = body[0].value
                        lines.update(range(c.lineno, c.end_lineno + 1))
            self._docstring_lines = lines
        return self._docstring_lines


@dataclass
class RepoModel:
    root: str
    py_files: List[PyFile]
    #: paths restricted by --changed / explicit path args (None = full tree);
    #: registry-level rules that need the whole tree consult this to know
    #: whether they may run.
    restricted: Optional[Set[str]] = None

    def py(self, prefix: str = "") -> Iterator[PyFile]:
        for f in self.py_files:
            if f.path.startswith(prefix):
                yield f

    @property
    def is_partial(self) -> bool:
        return self.restricted is not None


def function_index(tree: ast.AST) -> List[Tuple[str, ast.AST]]:
    """(qualname, node) for every function/method, outermost first —
    shared by the analyzers that anchor findings on qualnames (anchors
    feed baseline idents, so there must be exactly ONE walker)."""
    out: List[Tuple[str, ast.AST]] = []

    def rec(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((f"{prefix}{child.name}", child))
                rec(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.ClassDef):
                rec(child, f"{prefix}{child.name}.")
            else:
                rec(child, prefix)

    rec(tree, "")
    return out


def _read(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError:
        return None


def _walk_files(root: str, rel_dirs: Tuple[str, ...],
                exts: Tuple[str, ...]) -> Iterator[str]:
    for rel_dir in rel_dirs:
        top = os.path.join(root, rel_dir)
        if not os.path.isdir(top):
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for name in sorted(filenames):
                if name.endswith(exts):
                    yield os.path.relpath(os.path.join(dirpath, name), root)


#: Python scanned for registry usage + discipline rules.  Tests are NOT
#: scanned by default: fake names there are legitimate (drills, fixtures)
#: and "a key is read somewhere" must mean product code.
PY_ROOTS = ("alluxio_tpu_torch",)


def changed_paths(root: str) -> Set[str]:
    """Repo-relative paths touched vs HEAD (staged + unstaged + untracked),
    for the fast ``lint-changed`` mode."""
    out: Set[str] = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            r = subprocess.run(args, cwd=root, capture_output=True,
                               text=True, timeout=30, check=False)
        except (OSError, subprocess.TimeoutExpired):
            continue
        out.update(p.strip() for p in r.stdout.splitlines() if p.strip())
    return out


def build_model(root: str, only_paths: Optional[Set[str]] = None,
                extra_py: Tuple[str, ...] = ()) -> RepoModel:
    """Parse the tree.  ``only_paths`` restricts the *scanned* set (fast
    mode / explicit fixture runs); ``extra_py`` adds python files outside
    ``PY_ROOTS`` (tests pass fixture modules this way)."""
    py_files: List[PyFile] = []

    py_candidates = list(_walk_files(root, PY_ROOTS, (".py",)))
    py_candidates.extend(extra_py)
    for rel in py_candidates:
        if only_paths is not None and rel not in only_paths and \
                rel not in extra_py:
            continue
        text = _read(os.path.join(root, rel))
        if text is None:
            continue
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError:
            # let the test suite / interpreter report syntax errors;
            # lint only analyzes parseable files
            continue
        py_files.append(PyFile(path=rel, text=text, tree=tree,
                               suppressions=parse_suppressions(text)))

    return RepoModel(root=root, py_files=py_files,
                     restricted=set(only_paths) if only_paths is not None
                     else None)

#!/usr/bin/env python
"""Stdlib fallback linter (the SURVEY §5 lint analog when ruff is absent).

The build image has no ruff/flake8 (zero egress); this covers the highest
-value pyflakes-class checks with only ``ast``:

  * syntax errors (via compile),
  * unused imports,
  * duplicate imports,
  * ``except:`` bare excepts,
  * mutable default arguments.

``make lint`` runs ruff when installed and falls back to this script.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
TARGETS = ["tpuslam", "tools", "tests", "bench.py", "chip_smoke.py", "__graft_entry__.py"]


def _imported_names(tree: ast.Module) -> list[tuple[str, int]]:
    """Module-level imports only: nested (lazy) imports are deliberate here
    and scope-local duplicates are not duplicates."""
    out = []
    for n in tree.body:
        if isinstance(n, ast.Import):
            for a in n.names:
                name = (a.asname or a.name).split(".")[0]
                out.append((name, n.lineno))
        elif isinstance(n, ast.ImportFrom):
            if n.module == "__future__":
                continue
            for a in n.names:
                if a.name == "*":
                    continue
                out.append((a.asname or a.name, n.lineno))
    return out


def _used_names(tree: ast.AST) -> set[str]:
    used: set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Name):
            used.add(n.id)
        elif isinstance(n, ast.Attribute):
            root = n
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    return used


def lint_file(path: Path) -> list[str]:
    src = path.read_text()
    problems: list[str] = []
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error: {e.msg}"]

    used = _used_names(tree)
    reexport = path.name == "__init__.py"  # imports there are the public API
    seen: set[str] = set()
    for name, lineno in _imported_names(tree):
        if name in seen:
            problems.append(f"{path}:{lineno}: duplicate import '{name}'")
        seen.add(name)
        if name not in used and not name.startswith("_") and not reexport:
            problems.append(f"{path}:{lineno}: unused import '{name}'")

    for n in ast.walk(tree):
        if isinstance(n, ast.ExceptHandler) and n.type is None:
            problems.append(f"{path}:{n.lineno}: bare 'except:'")
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in n.args.defaults + n.args.kw_defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        f"{path}:{d.lineno}: mutable default argument in "
                        f"'{n.name}'"
                    )
    return problems


def main() -> int:
    files: list[Path] = []
    for t in TARGETS:
        p = REPO_ROOT / t
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    problems: list[str] = []
    for f in files:
        problems.extend(lint_file(f))
    for msg in problems:
        print(msg)
    print(f"lint: {len(files)} files, {len(problems)} problems")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())

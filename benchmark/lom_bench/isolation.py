"""Which loaded modules the benchmark refuses: the JAX stack and the JAX
package, compared by the whole top-level name (the part before the first
dot): ``lili_om_tpu_torch`` begins with ``lili_om_tpu`` and is allowed.
The reference must also not load the program."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lili_om_tpu"})
PROGRAM = "lili_om_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in forbidden)


def imported_tops(root: Path) -> set:
    """The top-level names that the Python files under ``root`` import
    (absolute imports only; relative ones stay inside the package)."""
    out = set()
    for path in Path(root).rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                out.update(top(a.name) for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                out.add(top(node.module))
    return out

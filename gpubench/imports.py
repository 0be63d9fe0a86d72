"""The check that nothing in the process is the JAX package or JAX.

Names are compared by their top-level module, the part before the first
dot, whole: `delay_enc_tpu_torch` is not `delay_enc_tpu`.
"""

from __future__ import annotations

import ast
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "delay_enc_tpu")


def top_level(name: str) -> str:
    return name.split(".")[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top_level(m) in FORBIDDEN)


def forbidden_imports(source: str) -> list:
    """The forbidden modules that a Python source imports."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if top_level(a.name) in FORBIDDEN]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if top_level(node.module) in FORBIDDEN:
                found.append(node.module)
    return found

"""Reading the program's spans and counters out of a run's window totals.

`Run.spans` is the difference of the program registry's snapshot
(`delay_enc_tpu_torch/utils/timers.py`) across the window: a span's
seconds under its path, `<root>/<phase>/.../<name>`, and a counter under
`#<name>`.  Each function gives None where the names it reads are absent,
as in a program that has no such span or counter.
"""

from __future__ import annotations


def under(run, root: str) -> list:
    """The names of the spans inside the root span `root`."""
    return [n for n in run.spans if n.startswith(root + "/")]


def leaf_total(run, root: str, leaf: str) -> float | None:
    """Seconds in every span inside `root` whose own name is `leaf`."""
    names = [n for n in under(run, root) if n.rsplit("/", 1)[1] == leaf]
    return sum(run.spans[n] for n in names) if names else None


def self_total(run, root: str, leaf: str, child: str) -> float | None:
    """Seconds in every `leaf` span inside `root` less those of their
    `child` children: the leaf spans' self time, where they have only that
    kind of child."""
    total = leaf_total(run, root, leaf)
    if total is None:
        return None
    inner = sum(run.spans[n] for n in under(run, root) if n.endswith(f"/{leaf}/{child}"))
    return total - inner


def counter(run, root: str, prefix: str) -> int | None:
    """The counters whose names start with `prefix`, summed, where the root
    span `root` ran in the window."""
    names = [n for n in run.spans if n.startswith("#" + prefix)]
    if not names or not under(run, root):
        return None
    return sum(run.spans[n] for n in names)


def per_proof(run, total, scale: float = 1.0) -> float | None:
    """A window total over the proofs the window completed."""
    if total is None or not run.proofs:
        return None
    return total * scale / run.proofs

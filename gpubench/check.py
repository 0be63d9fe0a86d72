"""The comparison that decides `correct`.

Five numbers, each an exact count with the limit 0:

    statement  1 where the statement the program built (its every column,
               copy and public input) is not the configuration's, by hash;
    vk_diff    entries of the program's verifying key (15 fixed and 6
               permutation commitments, the transcript's first scalar) that
               differ from the reference's, worked out from the statement
               at the SRS's secret;
    rejected   proofs of the sample that the reference's verifier, under
               its own key, rejects;
    missing    proofs asked for that never came (a request that raised, or
               returned fewer);
    repeated   proofs whose bytes equal another's of the same run: every
               request draws fresh prover randomness.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .reference import plonk as ref

LIMITS = {"statement": 0, "vk_diff": 0, "rejected": 0, "missing": 0, "repeated": 0}


def sample(count: int, size: int, rng: np.random.Generator) -> list:
    """Sorted indices of min(size, count) distinct proofs."""
    return sorted(int(i) for i in rng.choice(count, size=min(size, count), replace=False))


def judge(statement: dict, pinned: str, tau: int, program_vk: list, proofs: list,
          picked: list, missing: int) -> tuple:
    """({name: value} of the five numbers, [lines of detail]).  pinned is
    the configuration's hash of the statement; program_vk is [(name,
    value)] in `ref.VerifyingKey.entries` order."""
    other = digest(statement) != pinned
    detail = [f"the statement's hash {digest(statement)} is not {pinned}"] if other else []
    vk = ref.verifying_key(statement, tau)
    want = dict(vk.entries())
    got = dict(program_vk)
    diff = [name for name in want if got.get(name) != want[name]]
    detail += [f"vk entry {name} differs from the reference's" for name in diff]
    rejected = 0
    for i in picked:
        ok, why = ref.verify(vk, tau, proofs[i], statement["instance"])
        if not ok:
            rejected += 1
            detail.append(f"proof {i} rejected: {why}")
    seen, repeated = set(), 0
    for p in proofs:
        repeated += p in seen
        seen.add(p)
    return {"statement": int(other), "vk_diff": len(diff), "rejected": rejected,
            "missing": missing, "repeated": repeated}, detail


def digest(statement: dict) -> str:
    """A hash of the statement's every column, copy and public input, which
    pins the configuration's statement."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{statement['k']}:{statement['rows']}:{statement['lookup_widths']}".encode())
    for name in sorted(statement["fixed"]):
        h.update(f"{name}:{','.join(map(str, statement['fixed'][name]))};".encode())
    h.update(repr(statement["copies"]).encode())
    h.update(repr(statement["instance"]).encode())
    return h.hexdigest()


def passed(numbers: dict) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())

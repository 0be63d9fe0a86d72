"""Native Poseidon permutation and sponge.

Mirrors reference/src/poseidon/{permutation.rs,poseidon.rs} exactly:

 - optimized permutation: first-half full rounds end with the pre-sparse MDS,
   partial rounds use single-constant + sparse-MDS steps, second half is
   plain full rounds with a trailing constant-free sbox+MDS
   (permutation.rs:7-47);
 - reference (unoptimized) permutation for cross-testing
   (permutation.rs:59-80);
 - sponge `update`/`squeeze` with RATE-chunk absorption and the optional
   h_flag=1 ONE-padding (poseidon.rs:33-79);
 - encryption initial state [0, 0, k0, k1, 1] (poseidon.rs:15-22) and hash
   initial state [2^64, 0, ..] (spec.rs:10-17).
"""

from __future__ import annotations

from .spec import Spec


def sbox(field, x: int) -> int:
    """x^5 (spec.rs:30-44)."""
    x2 = x * x % field.p
    x4 = x2 * x2 % field.p
    return x4 * x % field.p


def apply_mds(field, m, state):
    p = field.p
    return [sum(e * s for e, s in zip(row, state)) % p for row in m]


def apply_sparse_mds(field, sm, state):
    p = field.p
    new0 = sum(e * s for e, s in zip(sm.row, state)) % p
    out = [new0]
    for col_el, word in zip(sm.col_hat, state[1:]):
        out.append((col_el * state[0] + word) % p)
    return out


def permute(spec: Spec, state: list[int]) -> list[int]:
    """Optimized permutation (permutation.rs:7-47)."""
    f = spec.field
    p = f.p
    r_f_half = spec.r_f // 2
    state = list(state)

    # first half of full rounds
    state = [(s + c) % p for s, c in zip(state, spec.constants_start[0])]
    for consts in spec.constants_start[1:r_f_half]:
        state = [sbox(f, s) for s in state]
        state = [(s + c) % p for s, c in zip(state, consts)]
        state = apply_mds(f, spec.mds, state)
    state = [sbox(f, s) for s in state]
    state = [(s + c) % p for s, c in zip(state, spec.constants_start[-1])]
    state = apply_mds(f, spec.pre_sparse_mds, state)

    # partial rounds
    for constant, sm in zip(spec.constants_partial, spec.sparse_matrices):
        state[0] = sbox(f, state[0])
        state[0] = (state[0] + constant) % p
        state = apply_sparse_mds(f, sm, state)

    # second half of full rounds
    for consts in spec.constants_end:
        state = [sbox(f, s) for s in state]
        state = [(s + c) % p for s, c in zip(state, consts)]
        state = apply_mds(f, spec.mds, state)
    state = [sbox(f, s) for s in state]
    state = apply_mds(f, spec.mds, state)
    return state


def permute_unoptimized(spec: Spec, state: list[int]) -> list[int]:
    """SpecRef::permute (permutation.rs:59-80): add-constants, sbox, MDS
    every round, partial rounds sbox only the first word."""
    f = spec.field
    p = f.p
    r_f_half = spec.r_f // 2
    state = list(state)
    consts = spec.unoptimized_constants
    for r in range(r_f_half):
        state = [(s + c) % p for s, c in zip(state, consts[r])]
        state = [sbox(f, s) for s in state]
        state = apply_mds(f, spec.mds, state)
    for r in range(r_f_half, r_f_half + spec.r_p):
        state = [(s + c) % p for s, c in zip(state, consts[r])]
        state[0] = sbox(f, state[0])
        state = apply_mds(f, spec.mds, state)
    for r in range(r_f_half + spec.r_p, spec.r_f + spec.r_p):
        state = [(s + c) % p for s, c in zip(state, consts[r])]
        state = [sbox(f, s) for s in state]
        state = apply_mds(f, spec.mds, state)
    return state


class Poseidon:
    """Sponge construction (poseidon.rs:13-80)."""

    def __init__(self, spec: Spec, state: list[int]):
        self.spec = spec
        self.state = list(state)
        self.absorbing: list[int] = []

    @classmethod
    def new_enc(cls, spec: Spec, k0: int, k1: int) -> "Poseidon":
        """Encryption state [0, 0, k0, k1, 1] (poseidon.rs:15-22; T=5)."""
        assert spec.t == 5
        return cls(spec, [0, 0, k0, k1, 1])

    @classmethod
    def new_hash(cls, spec: Spec) -> "Poseidon":
        """Hash state [2^64, 0, ...] (spec.rs:10-17 State::default)."""
        state = [0] * spec.t
        state[0] = (1 << 64) % spec.field.p
        return cls(spec, state)

    def update(self, elements: list[int]) -> None:
        """Absorb; permutes on each full RATE chunk, holds a partial tail
        (poseidon.rs:33-53)."""
        rate = self.spec.rate
        p = self.spec.field.p
        inputs = self.absorbing + list(elements)
        self.absorbing = []
        for off in range(0, len(inputs), rate):
            chunk = inputs[off : off + rate]
            if len(chunk) < rate:
                self.absorbing = chunk
            else:
                for i, e in enumerate(chunk):
                    self.state[i + 1] = (self.state[i + 1] + e) % p
                self.state = permute(self.spec, self.state)
                self.absorbing = []

    def squeeze(self, h_flag: int) -> list[int]:
        """Absorb the tail (plus ONE padding if h_flag=1), permute, return the
        full state words (poseidon.rs:57-79)."""
        p = self.spec.field.p
        last_chunk = list(self.absorbing)
        assert len(last_chunk) < self.spec.rate
        if h_flag == 1:
            last_chunk.append(1)
        for i, e in enumerate(last_chunk):
            self.state[i + 1] = (self.state[i + 1] + e) % p
        self.state = permute(self.spec, self.state)
        self.absorbing = []
        return list(self.state)

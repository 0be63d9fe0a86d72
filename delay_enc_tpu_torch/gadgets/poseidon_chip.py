"""PoseidonChip: constrains the optimized Poseidon permutation.

Row-level mirror of reference/src/poseidon/chip.rs: per full-round
sbox word: two muls + one mul_add_constant (chip.rs:199-207); MDS rows are
T-term composes (chip.rs:278-302); partial rounds use the sparse-MDS layout
(one T-term compose + RATE two-term composes, chip.rs:305-338).

Initial states: `new_enc` assigns [0,0,k0,k1,1] as *constants*
(chip.rs:59-92), `new_enc_de` assigns them as *witness* (chip.rs:95-128 —
the delay circuit equality-constrains words 2,3 to the hash output), and
`new_hash` assigns [2^64,0,..] constants (chip.rs:131-152).
"""

from __future__ import annotations

from ..cs import Builder, Cell, MainGate, Term
from ..poseidon.spec import Spec


class PoseidonChip:
    def __init__(self, builder: Builder, spec: Spec, state: list[Cell]):
        self.b = builder
        self.mg = MainGate(builder)
        self.spec = spec
        self.state = state
        self.absorbing: list[Cell] = []

    # --- constructors --------------------------------------------------
    @classmethod
    def new_enc(cls, builder: Builder, spec: Spec, key0: int, key1: int) -> "PoseidonChip":
        mg = MainGate(builder)
        words = [0, 0, key0, key1, 1]
        state = [mg.assign_constant(w) for w in words]
        return cls(builder, spec, state)

    @classmethod
    def new_enc_de(cls, builder: Builder, spec: Spec, key0: int, key1: int) -> "PoseidonChip":
        mg = MainGate(builder)
        words = [0, 0, key0, key1, 1]
        state = [mg.assign_value(w) for w in words]
        return cls(builder, spec, state)

    @classmethod
    def new_hash(cls, builder: Builder, spec: Spec) -> "PoseidonChip":
        mg = MainGate(builder)
        words = [0] * spec.t
        words[0] = (1 << 64) % spec.field.p
        state = [mg.assign_constant(w) for w in words]
        return cls(builder, spec, state)

    def set_inputs(self, elements: list[Cell]) -> None:
        self.absorbing.extend(elements)

    # --- round pieces --------------------------------------------------
    def _sbox_full(self, constants: list[int]) -> None:
        for i, const in enumerate(constants):
            w = self.state[i]
            t = self.mg.mul(w, w)
            t = self.mg.mul(t, t)
            self.state[i] = self.mg.mul_add_constant(t, w, const)

    def _sbox_part(self, constant: int) -> None:
        w = self.state[0]
        t = self.mg.mul(w, w)
        t = self.mg.mul(t, t)
        self.state[0] = self.mg.mul_add_constant(t, w, constant)

    def _absorb_with_pre_constants(
        self, inputs: list[Cell], pre_constants: list[int], h_flag: bool
    ) -> None:
        """chip.rs:222-275: state[0] += c0; state[1+i] += input_i + c_{1+i};
        remaining words += c (+1 on the first remaining word if h_flag)."""
        t = self.spec.t
        assert len(inputs) < t
        offset = len(inputs) + 1
        self.state[0] = self.mg.add_constant(self.state[0], pre_constants[0])
        for i, inp in enumerate(inputs):
            self.state[i + 1] = self.mg.add_with_constant(
                self.state[i + 1], inp, pre_constants[i + 1]
            )
        for j, i in enumerate(range(offset, t)):
            extra = 1 if (h_flag and j == 0) else 0
            self.state[i] = self.mg.add_constant(self.state[i], pre_constants[i] + extra)

    def _apply_mds(self, mds: list[list[int]]) -> None:
        new_state = [
            self.mg.compose([Term(cell, e) for cell, e in zip(self.state, row)])
            for row in mds
        ]
        self.state = new_state

    def _apply_sparse_mds(self, sm) -> None:
        new_state = [
            self.mg.compose([Term(cell, e) for cell, e in zip(self.state, sm.row)])
        ]
        for col_el, word in zip(sm.col_hat, self.state[1:]):
            new_state.append(
                self.mg.compose([Term(self.state[0], col_el), Term(word, 1)])
            )
        self.state = new_state

    # --- permutation ----------------------------------------------------
    def _permute(self, inputs: list[Cell], h_flag: bool) -> None:
        spec = self.spec
        r_f_half = spec.r_f // 2
        consts = spec.constants_start
        self._absorb_with_pre_constants(inputs, consts[0], h_flag)
        for c in consts[1:r_f_half]:
            self._sbox_full(c)
            self._apply_mds(spec.mds)
        self._sbox_full(consts[-1])
        self._apply_mds(spec.pre_sparse_mds)

        for constant, sm in zip(spec.constants_partial, spec.sparse_matrices):
            self._sbox_part(constant)
            self._apply_sparse_mds(sm)

        for c in spec.constants_end:
            self._sbox_full(c)
            self._apply_mds(spec.mds)
        self._sbox_full([0] * spec.t)
        self._apply_mds(spec.mds)

    def permutation(self, inputs: list[Cell]) -> None:
        """chip.rs:341-378 (encryption flavor, no ONE padding)."""
        self._permute(inputs, h_flag=False)

    def perm_hash(self, inputs: list[Cell]) -> None:
        """chip.rs:381-418 (hash flavor: ONE pad on the first word past the
        inputs)."""
        self._permute(inputs, h_flag=True)

"""PoseidonEncCircuit: standalone Poseidon-encryption circuit.

Mirror of reference/src/encryption/chip.rs:114-204: assign the
expected (natively computed) ciphertext as witness, run the in-circuit
encryption with keys as constants, and equality-constrain the produced
ciphertext cells to the expected cells.  No public inputs (the reference
passes `vec![vec![]]`, chip.rs:236)."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..cs import Builder, MainGate
from ..fields.prime import PrimeField
from ..poseidon.spec import Spec
from ..gadgets.enc_chip import MESSAGE_CAPACITY, PoseidonEncChip


@dataclass
class PoseidonEncCircuit:
    spec: Spec
    num_input: int
    message: list[int]
    key: tuple[int, int]
    expected: list[int]
    capacity: int = MESSAGE_CAPACITY

    def build(self) -> Builder:
        b = Builder(self.spec.field)
        mg = MainGate(b)

        expected_cells = [mg.assign_value(v) for v in self.expected]

        chip = PoseidonEncChip.new(b, self.spec, self.key)
        # permute before state message addition (chip.rs:176)
        chip.pose_chip.permutation([])
        for v in self.message[: self.num_input]:
            e = mg.assign_value(v)
            chip.pose_chip.set_inputs([e])
        cipher_text = chip.absorb_and_relese(self.capacity)
        for ct, exp in zip(cipher_text, expected_cells):
            mg.assert_equal(ct, exp)
        return b

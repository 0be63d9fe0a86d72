"""PoseidonEncChip: in-circuit Poseidon sponge encryption.

Mirror of reference/src/encryption/chip.rs:28-110.  Behavioral note
(preserved deliberately): `absorb_and_relese` adds the message to the state
with main-gate adds AND then calls `permutation(inputs)`, which absorbs the
same inputs again (chip.rs:94-104) — so the in-circuit tag permutation runs
on state + 2*message while the native cipher's runs on state alone (see
encryption/cipher.py).  The equality constraint against the native
ciphertext is therefore satisfiable exactly when the two paths agree (the
reference's tests use zero messages; chip.rs:220, lib.rs:339-341)."""

from __future__ import annotations

from ..cs import Builder, Cell, MainGate
from ..poseidon.spec import Spec
from .poseidon_chip import PoseidonChip

MESSAGE_CAPACITY = 2  # encryption/poseidon_enc.rs:10
CIPHER_SIZE = MESSAGE_CAPACITY + 1


class PoseidonEncChip:
    def __init__(self, pose_chip: PoseidonChip, key0: int, key1: int):
        self.pose_chip = pose_chip
        self.pose_key0 = key0
        self.pose_key1 = key1

    @classmethod
    def new(cls, builder: Builder, spec: Spec, sk: tuple[int, int]) -> "PoseidonEncChip":
        """Keys as constants (chip.rs:48-69 via PoseidonChip::new_enc)."""
        return cls(PoseidonChip.new_enc(builder, spec, sk[0], sk[1]), sk[0], sk[1])

    @classmethod
    def new_de(cls, builder: Builder, spec: Spec, sk: tuple[int, int]) -> "PoseidonEncChip":
        """Keys as witness (lib.rs:80-99 via PoseidonChip::new_enc_de)."""
        return cls(PoseidonChip.new_enc_de(builder, spec, sk[0], sk[1]), sk[0], sk[1])

    def absorb_and_relese(self, capacity: int = MESSAGE_CAPACITY) -> list[Cell]:
        """chip.rs:72-110 (sic name)."""
        chip = self.pose_chip
        mg = chip.mg
        rate = chip.spec.rate
        cipher_text: list[Cell] = []
        input_elements = list(chip.absorbing)
        chip.absorbing = []
        i = 0
        for off in range(0, len(input_elements), rate):
            inputs = input_elements[off : off + rate]
            for j, inp in enumerate(inputs):
                chip.state[j + 1] = mg.add(chip.state[j + 1], inp)
                if i < capacity:
                    cipher_text.append(chip.state[j + 1])
                    i += 1
            chip.permutation(inputs)  # double-absorb, as in the reference
        cipher_text.append(chip.state[1])
        return cipher_text
